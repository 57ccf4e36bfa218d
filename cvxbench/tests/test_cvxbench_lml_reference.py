"""The LML configuration's plain reference and its cell on the CPU.

The reference (reference/lml_top5.py) against the optimality conditions
of the LML projection and against central differences of its own solve,
its TF32 control against its float64 run, and, as
test_cvxbench_faults.py does for the older cells, the cell driven whole
at a small batch: a sound run is correct, and every planted fault and
the control are not."""

import subprocess
import sys

import pytest
import torch

from cvxbench import spec
from cvxbench.control import FAULTS, control_patch, fault_patch
from cvxbench.reference import lml_top5 as lml
from cvxbench.run import SetupClock, run

CELL = "lml.ipm_train"


def _logits(seed, B=16, n=100):
    g = torch.Generator().manual_seed(seed)
    return 2.0 * torch.randn(B, n, generator=g, dtype=torch.float64)


def test_solution_meets_the_optimality_conditions():
    x = _logits(1)
    y, nu, ok = lml.solve(x, 5.0)
    assert ok.all()
    assert ((y > 0) & (y < 1)).all()
    assert (y.sum(-1) - 5.0).abs().max() < 1e-12
    # stationarity: x_i - logit(y_i) is the same (-nu) on every
    # coordinate; logit loses digits where y is within 1e-6 of 0 or 1
    inner = (y > 1e-6) & (y < 1 - 1e-6)
    resid = (x - torch.logit(y) + nu[:, None]).abs()
    assert resid[inner].max() < 1e-8


def test_nu_moves_as_k_does():
    x = _logits(2, B=4)
    nus = [lml.solve(x, k)[1] for k in (1.0, 5.0, 50.0, 99.0)]
    assert all((a < b).all() for a, b in zip(nus, nus[1:]))
    with pytest.raises(ValueError):
        lml.solve(x, 100.0)


def test_gradient_against_central_differences():
    x = _logits(3, B=4)
    g = torch.Generator().manual_seed(4)
    ybar = torch.randn(4, 100, generator=g, dtype=torch.float64)
    y, _, _ = lml.solve(x, 5.0)
    xbar = lml.vjp(y, ybar)
    d = torch.randn(x.shape, generator=g, dtype=torch.float64)
    eps = 1e-6
    fd = ((lml.solve(x + eps * d, 5.0)[0] - lml.solve(x - eps * d, 5.0)[0])
          * ybar).sum(-1) / (2 * eps)
    an = (xbar * d).sum(-1)
    assert torch.allclose(fd, an, rtol=1e-6, atol=1e-9), (fd, an)
    # the gradient is orthogonal to 1: shifting every logit moves nothing
    assert (xbar.sum(-1)).abs().max() < 1e-12


def test_tf32_control_reads_worse_than_float64():
    x = _logits(5, B=64)
    ybar = torch.randn(64, 100, generator=torch.Generator().manual_seed(6),
                       dtype=torch.float64)
    cfg = {"k": 5}
    (y64,), (g64,), ok64 = lml.solve_and_grad([x], [ybar], cfg, "float64")
    (y32,), (g32,), _ = lml.solve_and_grad([x], [ybar], cfg, "float32")
    (y19,), (g19,), ok19 = lml.solve_and_grad([x], [ybar], cfg, "tf32")
    assert ok64.all() and ok19.all() and y19.dtype == torch.float32

    def gaps(y, g):
        out = (y.double() - y64).abs().amax(-1)
        grad = ((g.double() - g64).abs().amax(-1) / g64.abs().amax(-1))
        total = (y.double().sum(-1) - 5.0).abs()
        return out.median(), grad.median(), total.max()

    for low, mid in zip(gaps(y19, g19), gaps(y32, g32)):
        assert low > 10 * mid
    # what the cell's limits separate (cells/lml.ipm_train.json)
    out_med, grad_med, total = gaps(y19, g19)
    assert total > 1e-4 and grad_med > 5e-6


def test_reference_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, cvxbench.reference.lml_top5\n"
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'jax', 'cvxpylayers_tpu', 'cvxpylayers_tpu_torch'}))"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_instances_repeat_under_a_seed():
    cell = spec.load_cell(CELL)
    cm = cell.config_module()

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return cm.instances(cell.config, g, 8, "cpu")[0]

    assert torch.equal(draw(2 ** 31 + 99), draw(2 ** 31 + 99))
    assert not torch.equal(draw(2 ** 31 + 99), draw(2 ** 31 + 100))
    assert cm.output_shapes(cell.config, 8) == [(8, 100)]


def _judged(patch):
    cell = spec.load_cell(CELL)
    cell.config["batch"] = 24
    cell.mix.update(warm_steps=1, kept_steps=2)
    fields, checks, _ = run(cell, 2 ** 31 + 7, 0.3, False, "cpu",
                            SetupClock(), patch)
    return fields["correct"], checks


def test_sound_run_is_correct():
    ok, checks = _judged(None)
    assert ok, checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault):
    ok, checks = _judged(fault_patch(FAULTS[fault]))
    assert not ok, checks


def test_control_is_not_correct():
    ok, checks = _judged(control_patch())
    assert not ok, checks
