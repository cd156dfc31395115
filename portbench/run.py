"""Run one benchmark cell of the port:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers compared with the reference are the last lines
of standard error.  Exits non-zero, with no result, without enough CUDA
devices or when a module named jax, jaxlib, flax or repro was loaded.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the script's own directory is not a package root: its file names would
# shadow top-level modules
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

# no library may pull in JAX behind the program's back
os.environ.setdefault("USE_FLAX", "0")

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
