"""The benchmark's harness, general over cells.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
harness finds everything else by name, so a later cell, mix or metric is
added as files alone:

- ``<config file>``            the configuration, as ``BENCHMARK.json`` names it;
- ``traffic/<traffic>.json``   the mix: the entry that drives the program and
                               its parameters;
- ``entries/<entry>.py``       how a mix drives the program: set-up, one unit
                               of work (a fit, a block of steps), the traced
                               stretch, the program's answers and the judge;
- ``cells/<workload>.json``    the cell's limits and reference sizes;
- ``metrics/<metric>.py``      one per-layer metric: ``read(run)`` returns a
                               number or None (nothing to read).

A run sets up, then starts units of work while the window has room for
one more at the mean pace so far (always at least one) and finishes each
unit it starts; then reads the peak memory, traces one more unit when
asked, takes the program's answers, frees the program's state and judges
the answers against the plain reference.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

from portbench import common

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` as a module of its own (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    name = "portbench_file_" + re.sub(r"\W", "_", str(path.resolve().with_suffix("")))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    reference: dict
    entry: ModuleType
    end_to_end: list
    per_layer: dict = field(default_factory=dict)   # name -> reader module


def load_cell(workload: str, root: Path = CHECKOUT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    cell_file = json.loads((bench_dir / "cells" / f"{workload}.json").read_text())
    e2e = [m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = {}
    for m in bench["per_layer"]:
        listed = m.get("workloads")
        if (workload in listed) if listed is not None else (m["moves"] in e2e):
            per_layer[m["name"]] = load_module(bench_dir / "metrics" / f"{m['name']}.py")
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=cell_file["limits"], reference=cell_file.get("reference", {}),
                entry=load_module(bench_dir / "entries" / f"{traffic['entry']}.py"),
                end_to_end=e2e, per_layer=per_layer)


@dataclass
class Run:
    """What the per-layer readers see: the window's units, the traced
    stretch and what the reference counted."""
    cell: Cell
    units: list
    trace: common.Trace | None
    ref: dict


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             control: bool = False, log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch
    cuda = torch.device(device).type == "cuda"
    entry = cell.entry
    ctx = entry.setup(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = common.process_age_s()
    units = []
    t0 = time.perf_counter()
    while True:
        units.append(entry.run_unit(ctx))
        log(f"unit {len(units)}: " + json.dumps(units[-1]))
        elapsed = time.perf_counter() - t0
        # start another unit only if it would end inside the window at the pace so far
        if elapsed + elapsed / len(units) > seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    stretch = None
    if trace:
        steps = max([getattr(m, "STEPS", 0) for m in cell.per_layer.values()] or [0])
        stretch = entry.traced_unit(ctx, steps)
    answers = entry.control_answers(ctx) if control else entry.answers(ctx)
    entry.free(ctx)
    if cuda:
        torch.cuda.empty_cache()
    readings, ref = entry.judge(ctx, answers)

    checks = {k: {"value": float(readings[k]), "limit": float(cell.limits[k])}
              for k in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    attempted = len(units) + (1 if trace else 0)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        metrics = {}
        run = Run(cell=cell, units=units, trace=stretch, ref=ref)
        for name, reader in cell.per_layer.items():
            value = reader.read(run)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": reader.UNIT}
        device_info["busy_s"] = stretch.busy_s()
        device_info["window_s"] = stretch.window_s
    else:
        values = dict(entry.end_to_end(ctx, units, window_s), setup_s=setup_s)
        units_of = {"setup_s": "s"} | getattr(entry, "UNITS", {})
        metrics = {name: {"value": float(values[name]), "unit": units_of[name]}
                   for name in cell.end_to_end}
    out = {"correct": correct, "attempted": attempted, "failed": 0 if correct else 1,
           "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = {"device_ops": stretch.device_ops(), "idle_gaps": stretch.idle_gaps()}
    out["checks"] = checks
    log(f"window: {len(units)} units in {window_s:.3f} s; setup {setup_s:.3f} s")
    return out


def apply_overrides(cell: Cell, overrides: dict | None) -> Cell:
    """A copy of ``cell`` with {"config": {...}, "traffic": {...},
    "reference": {...}, "limits": {...}} merged in (for tests at small size)."""
    cell = copy.copy(cell)
    for part, values in (overrides or {}).items():
        setattr(cell, part, {**getattr(cell, part), **values})
    return cell


def main(argv=None, control: bool = False) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="run one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    log(f"{cell.name} seed {args.seed} seconds {args.seconds} trace {args.trace}"
        f"{' CONTROL' if control else ''}; card: {common.power_limit()}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   control=control, log=log)
    bad = common.forbidden_modules(list(sys.modules))
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"portbench check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"portbench correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
