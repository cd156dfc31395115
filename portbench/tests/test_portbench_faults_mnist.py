"""``mnist_bh_fit``'s check at a size the CPU holds: a sound run passes, and a
run with the timed path broken underneath (the chip look skipped, the rest
of the run driven as committed) comes out ``correct: false``, as does the
control (the reference in bfloat16 in the program's place)."""
import pytest

from conftest_portbench import run_small
from portbench.faults import FAULTS, failing

CELL = "mnist_bh_fit"


def test_sound_run_is_correct():
    out = run_small(CELL, seed=2**33 + 17)
    assert failing(out) == [] and out["correct"] is True


def test_control_is_not_correct():
    out = run_small(CELL, seed=4321, control=True)
    assert out["correct"] is False and failing(out)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    plant, caught_by = FAULTS[fault]
    plant(monkeypatch)
    out = run_small(CELL, seed=99)
    assert out["correct"] is False
    assert (caught_by if isinstance(caught_by, str) else caught_by[CELL]) in failing(out)
