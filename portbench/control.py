"""The control of a cell's correctness check: a whole run in which the
plain reference, computed in bfloat16 (one precision below the
configuration's float32), takes the program's place as the source of the
judged answers.  It must come out ``correct: false``:

    python3 portbench/control.py --workload <cell> --seed <n> --seconds 1

The benchmark's own runs never run it; the limits in ``cells/`` were set
between the program's readings and the control's.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(control=True))
