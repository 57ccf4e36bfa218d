"""Traffic repeats under a seed: the same seed gives the same instances,
the same cotangents and the same kept steps, and every training step
draws a batch of its own."""

import pytest
import torch

from cvxbench import spec
from cvxbench.run import Reservoir, SetupClock


def _instances(cell, seed, rows):
    gen = torch.Generator().manual_seed(seed)
    return cell.config_module().instances(cell.config, gen, rows, "cpu")


def test_instances_repeat_under_a_seed():
    for name in ("box_qp.admm_train", "markowitz.rescue_train"):
        cell = spec.load_cell(name)
        a = _instances(cell, 2 ** 31 + 99, 16)
        b = _instances(cell, 2 ** 31 + 99, 16)
        c = _instances(cell, 2 ** 31 + 100, 16)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], c[0])


def test_instances_keep_their_guarantees():
    cell = spec.load_cell("box_qp.admm_train")
    v, G, h = _instances(cell, 5, 64)
    assert (h >= 1.0).all()      # the reference's interior-point start
    cell = spec.load_cell("markowitz.rescue_train")
    mu, F = _instances(cell, 5, 64)
    n = mu.shape[1]
    risk = (F @ torch.full((n, 1), 1.0 / n)).squeeze(-1).norm(dim=-1)
    assert (risk < cell.config["risk_budget"]).all()


def _workload(name, seed):
    cell = spec.load_cell(name)
    cell.config["batch"] = 8
    return cell.kind_module().Workload(cell, seed, torch.device("cpu"),
                                       SetupClock())


@pytest.mark.parametrize("name", ["box_qp.admm_train",
                                  "markowitz.rescue_train"])
def test_training_steps_draw_fresh_batches_fixed_by_the_seed(name):
    a, b = _workload(name, 2 ** 31 + 3), _workload(name, 2 ** 31 + 3)
    (pa1, ba1), (pb1, bb1) = a.draw(), b.draw()
    pa2, ba2 = a.draw()
    for x, y, z in zip(pa1 + ba1, pb1 + bb1, pa2 + ba2):
        assert torch.equal(x, y)
        assert not torch.equal(x, z) and x is not z
    assert all(p.requires_grad and p.is_leaf for p in pa1)


def test_kept_steps_repeat_under_a_seed():
    def picks(seed, steps=200):
        r = Reservoir(3, seed)
        kept = [None] * 3
        for i in range(steps):
            s = r.slot()
            if s is not None:
                kept[s] = i
        return kept

    assert picks(7) == picks(7)
    assert len(set(picks(7))) == 3
    assert picks(7) != picks(8) or picks(7) != picks(9)
