"""Readings behind the limits of a cell's checks, at the cell's own size:

    python3 portbench/readings.py --workload <cell> --seeds 7,8,9 \
        --variants sound,stuck_step,control [--setup-fault moved_neighbours]

For each seed: one set-up (with ``--setup-fault`` planted, for a fault of
the set-up's own stages), then for each variant one unit of work and the
program's answers (``sound``: as committed; a name of ``faults.FAULTS``:
that fault planted for the unit and its answers; ``control``: the
reference in bfloat16 takes the program's place).  Then the program's
state is freed and each variant judged.  One JSON line a reading, printed
and appended to ``--out``.  The benchmark's own runs never run this.
"""
import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    # as run.py: the script's own directory is not a package root
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402


def read(cell, seed: int, variants: list[str], setup_fault: str | None, device: str):
    """The readings of ``variants`` on one set-up of ``cell`` from ``seed``."""
    entry = cell.entry
    kept = []
    with pytest.MonkeyPatch.context() as mp:
        if setup_fault:
            FAULTS[setup_fault][0](mp)
        t0 = time.perf_counter()
        ctx = entry.setup(cell, seed, device)
        setup_s = time.perf_counter() - t0
        for v in variants:
            with pytest.MonkeyPatch.context() as mv:
                if v in FAULTS:
                    FAULTS[v][0](mv)
                unit = entry.run_unit(ctx)
                ans = entry.control_answers(ctx) if v == "control" else entry.answers(ctx)
            kept.append((v, dict(vars(ctx)), ans, unit))
    for v, snapshot, ans, unit in kept:
        vars(ctx).update(snapshot)
        entry.free(ctx)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        readings, counts = entry.judge(ctx, ans)
        yield {"workload": cell.name, "seed": seed, "variant": v, "setup_fault": setup_fault,
               "readings": readings, "counts": counts, "setup_s": setup_s,
               "unit_s": unit["seconds"], "judge_s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variants", default="sound", help="comma-separated")
    ap.add_argument("--setup-fault", default=None, choices=sorted(FAULTS))
    ap.add_argument("--out", default="chiprun_out/readings.jsonl")
    args = ap.parse_args()
    variants = args.variants.split(",")
    unknown = [v for v in variants if v not in FAULTS and v not in ("sound", "control")]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    cell = harness.load_cell(args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in read(cell, seed, variants, args.setup_fault, "cuda"):
            text = json.dumps(line)
            print(text, flush=True)
            with out.open("a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
