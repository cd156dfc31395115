"""Dry run of every (architecture x shape) cell on the production meshes:
port of ``repro/launch/dryrun.py``.  Builds each cell on the abstract
path, counts its step's operations (``launch.cost``) and records the
memory per device, the counted cost, the parameter collectives and the
roofline terms with the H100's constants.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_405b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both_meshes [--out runs/dryrun_torch]

Needs no card and allocates nothing: the operands are meta tensors and
the mesh is logical (``launch.mesh``), so no device count is forced.
Records keep the reference's keys where a counterpart exists; ``count_s``
stands for its ``lower_s`` and ``compile_s``.  There is no HLO, so no
``--save_hlo``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.cell import build_cell
from repro_torch.launch.cost import cell_report, count_cell
from repro_torch.launch.mesh import make_production_mesh


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: pathlib.Path,
             counted: dict | None = None) -> dict:
    """One cell's record, written to ``out_dir``.  ``counted`` keeps each
    (arch, shape)'s op count across calls: the count is of the global
    step, the same on both meshes, so the second mesh reuses it
    (``counts_reused``)."""
    mesh_tag = "pod512" if multi_pod else "pod256"
    tag = f"{arch}__{shape_name}__{mesh_tag}"
    out_path = out_dir / f"{tag}.json"
    cfg = get_config(arch)
    rec: dict = dict(arch=arch, shape=shape_name, mesh=mesh_tag, ok=False)

    if shape_name in cfg.skip_shapes:
        rec.update(skipped=True, reason=cfg.skip_reason, ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    t0 = time.perf_counter()
    try:
        cell = build_cell(arch, shape_name, make_production_mesh(multi_pod=multi_pod))
        counted = {} if counted is None else counted
        reused = (arch, shape_name) in counted
        if not reused:
            counted[(arch, shape_name)] = count_cell(cell)
        report = cell_report(cell, counted[(arch, shape_name)])
        rec.update(ok=True, skipped=False, count_s=round(time.perf_counter() - t0, 2),
                   counts_reused=reused, **report)
    except Exception as e:  # noqa: BLE001 - one cell's failure is its record's
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--all", action="store_true", help="every arch and shape (the default)")
    ap.add_argument("--multi_pod", action="store_true")
    ap.add_argument("--both_meshes", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--skip_existing", action="store_true")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if args.all or args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_fail = 0
    counted: dict = {}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'pod512' if mp else 'pod256'}"
                out_path = out_dir / f"{tag}.json"
                if args.skip_existing and out_path.exists():
                    prev = json.loads(out_path.read_text())
                    if prev.get("ok"):
                        print(f"[skip] {tag}")
                        continue
                t0 = time.perf_counter()
                rec = run_cell(arch, shape, mp, out_dir, counted)
                dt = time.perf_counter() - t0
                if rec["ok"]:
                    n_ok += 1
                    status = "SKIP " + rec.get("reason", "")[:40] if rec.get("skipped") else "OK"
                    mem = rec.get("memory", {})
                    arg_gb = mem.get("argument_size_in_bytes", 0) / 2**30
                    peak_gb = mem.get("peak_live_bytes_global", 0) / 2**30
                    dom = rec.get("roofline", {}).get("dominant", "-")
                    print(f"[{status:>5}] {tag}  {dt:6.1f}s args={arg_gb:.2f}GiB/device "
                          f"peak={peak_gb:.1f}GiB global bound={dom}", flush=True)
                else:
                    n_fail += 1
                    print(f"[FAIL ] {tag}  {dt:6.1f}s {rec['error'][:200]}", flush=True)
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
