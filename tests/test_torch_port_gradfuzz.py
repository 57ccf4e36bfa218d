"""Gradients of random small programs against central differences.

Each seed draws a strictly convex quadratic program of random size with
inequality, box and (sometimes) equality constraints. Its solution map
goes through CvxpyLayer(device="cpu") in f64 by ADMM and by the
interior-point method; the gradient of a random linear loss with respect
to every parameter, from one backward pass through the implicit adjoint,
is held against a central difference of the loss along a random direction
in parameter space. Nothing of the reference is involved.
"""

import numpy as np
import pytest
import torch

import cvxpylayers_tpu_torch as ct

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_B = 2


def _program(seed):
    r = np.random.default_rng(2000 + seed)
    n = int(r.integers(2, 6))
    mi = int(r.integers(1, 5))
    me = int(r.integers(0, 2))
    L = r.standard_normal((n, n)) * 0.5
    P = L @ L.T + 0.2 * np.eye(n)
    G = r.standard_normal((_B, mi, n))
    F = r.standard_normal((_B, me, n))
    x0 = r.uniform(-0.4, 0.4, (_B, n))
    h = np.einsum("bij,bj->bi", G, x0) + np.abs(r.standard_normal((_B, mi)))
    g = np.einsum("bij,bj->bi", F, x0)
    q = r.standard_normal((_B, n)) * 2.0
    x = ct.Variable(n)
    pq, pG, ph = ct.Parameter(n), ct.Parameter((mi, n)), ct.Parameter(mi)
    cons, params, vals = [pG @ x <= ph, x >= -1, x <= 1], [pq, pG, ph], \
        [q, G, h]
    if me:
        pF, pg = ct.Parameter((me, n)), ct.Parameter(me)
        cons.append(pF @ x == pg)
        params += [pF, pg]
        vals += [F, g]
    prob = ct.Problem(ct.Minimize(
        pq @ x + 0.5 * ct.quad_form(x, ct.Constant(P))), cons)
    layer = ct.CvxpyLayer(prob, parameters=params, variables=[x],
                          device="cpu", solver_args={"refine_steps": 3})
    weights = r.standard_normal((_B, n))
    directions = [r.standard_normal(v.shape) for v in vals]
    return layer, vals, weights, directions


@pytest.mark.parametrize("method", ["admm", "ipm"])
@pytest.mark.parametrize("seed", range(8))
def test_gradient_matches_central_difference(seed, method):
    layer, vals, weights, directions = _program(seed)
    args = {"solve_method": method}
    w = torch.as_tensor(weights)

    def loss(values):
        (x,) = layer(*values, solver_args=args)
        return (x * w).sum()

    tin = [torch.as_tensor(v).requires_grad_() for v in vals]
    loss(tin).backward()
    analytic = sum(float((t.grad * torch.as_tensor(d)).sum())
                   for t, d in zip(tin, directions))
    assert all(bool(torch.isfinite(t.grad).all()) for t in tin)
    step = 1e-6
    with torch.no_grad():
        hi = loss([torch.as_tensor(v + step * d)
                   for v, d in zip(vals, directions)])
        lo = loss([torch.as_tensor(v - step * d)
                   for v, d in zip(vals, directions)])
    numeric = float(hi - lo) / (2 * step)
    # the solution map of a quadratic program is linear while the active
    # set holds (it does within the step at these seeds), so the central
    # difference is exact up to the ~1e-11 the polish leaves over the step
    assert abs(analytic - numeric) < 1e-7 * (1 + abs(numeric))
    assert abs(numeric) > 1e-3  # the loss does depend on the parameters
