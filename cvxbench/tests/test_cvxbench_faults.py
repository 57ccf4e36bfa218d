"""The judge against faults planted in the timed path, and against the
control, on the CPU at a small size: each cell's run is driven whole
(set-up, window, kept steps, judge) past the look for a card, with the
program's solve broken underneath, and `correct` has to come out false.
A sound run at the same size comes out true.

Faults (cvxbench/control.py, which also reads them on the card), each
where the answer is produced, the layer's solve: the solve returns its
starting iterate unchanged; half of the batch is left out and given the
mean of the rest; the answers of two lanes of every step are swapped.
The exchange between chips is not a fault these one-chip cells can have.
The control is the reference computed in TF32 in the program's place.
"""

import pytest

from cvxbench import spec
from cvxbench.control import FAULTS, control_patch, fault_patch
from cvxbench.run import SetupClock, run

CELLS = ("box_qp.admm_train", "box_qp.ipm_train", "markowitz.rescue_train")


def small(name):
    cell = spec.load_cell(name)
    cell.config["batch"] = 24
    cell.mix.update(warm_steps=1, kept_steps=2)
    return cell


def judged(name, patch):
    fields, checks, _ = run(small(name), 2 ** 31 + 7, 0.3, False, "cpu",
                            SetupClock(), patch)
    return fields["correct"], checks


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, checks = judged(name, None)
    assert ok, checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault):
    ok, checks = judged(name, fault_patch(FAULTS[fault]))
    assert not ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    ok, checks = judged(name, control_patch())
    assert not ok, checks
