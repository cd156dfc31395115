"""Shared small-size set-up of the harness tests (imported by them, not a
pytest conftest: its name keeps it out of the repository's test
collection)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402

SCHEDULE = {"exaggeration_iters": 30, "momentum_switch_iter": 30}

# each cell at a size a CPU test holds; everything else as committed
SMALL = {
    "mnist_bh_fit": {"config": {"n": 400, "dim": 24, "n_iter": 150, **SCHEDULE},
                     "traffic": {"warmup_steps": 3, "backend_options": {}}},
    "mouse_bh_descent": {"config": {"n": 1000, "n_iter": 50, **SCHEDULE},
                         "traffic": {"warmup_steps": 2,
                                     "backend_options": {"chunk_size": 500, "knn_shards": 2},
                                     "mesh_devices": 2},
                         "reference": {"knn_rows": 200, "step_rows": 300}},
}


def small_cell(workload: str, **extra):
    over = {k: dict(v) for k, v in SMALL[workload].items()}
    for part, values in extra.items():
        over[part] = {**over.get(part, {}), **values}
    return harness.apply_overrides(harness.load_cell(workload), over)


def run_small(workload: str, seed: int = 12345, trace: bool = False, control: bool = False,
              **extra) -> dict:
    """One whole run of ``workload`` on the CPU at its small size, on one
    thread (the test workers share the cores)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(small_cell(workload, **extra), seed, 0.0, trace, device="cpu",
                                control=control, log=lambda msg: None)
    finally:
        torch.set_num_threads(threads)
