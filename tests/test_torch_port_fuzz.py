"""Random small programs through the port's layer, held to their
optimality conditions.

Each seed draws the sizes (variables, inequality rows, equality rows),
whether the objective has curvature, and feasible data. The program goes
through CvxpyLayer(device="cpu") in f64 by ADMM and by the interior-point
method, and the primal solution and the duals it returns are checked in
numpy against the KKT conditions of the program as stated, and for the
linear programs against HiGHS's optimal value. Nothing of the reference
is involved.
"""

import numpy as np
import pytest
import scipy.optimize as sopt
import torch

import cvxpylayers_tpu_torch as ct

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_B = 3


def _draw(seed):
    r = np.random.default_rng(1000 + seed)
    n = int(r.integers(2, 7))
    mi = int(r.integers(1, 6))
    me = int(r.integers(0, min(n, 3)))
    lp = bool(seed % 2)
    L = r.standard_normal((n, n)) * 0.5
    P = np.zeros((n, n)) if lp else L @ L.T + 0.1 * np.eye(n)
    G = r.standard_normal((_B, mi, n))
    F = r.standard_normal((_B, me, n))
    x0 = r.uniform(-0.5, 0.5, (_B, n))  # feasible, strictly inside the box
    slack = np.abs(r.standard_normal((_B, mi))) * (r.random((_B, mi)) > 0.3)
    h = np.einsum("bij,bj->bi", G, x0) + slack
    g = np.einsum("bij,bj->bi", F, x0)
    q = r.standard_normal((_B, n))
    return n, mi, me, lp, P, q, G, h, F, g


def _layer(n, mi, me, P):
    x = ct.Variable(n)
    q, G, h = ct.Parameter(n), ct.Parameter((mi, n)), ct.Parameter(mi)
    ineq = G @ x <= h
    lo, hi = x >= -1, x <= 1
    cons, params = [ineq, lo, hi], [q, G, h]
    if me:
        F, g = ct.Parameter((me, n)), ct.Parameter(me)
        eq = F @ x == g
        cons.append(eq)
        params += [F, g]
    objective = q @ x
    if P.any():
        objective = objective + 0.5 * ct.quad_form(x, ct.Constant(P))
    duals = [c.dual_variables[0] for c in cons]
    return ct.CvxpyLayer(ct.Problem(ct.Minimize(objective), cons),
                         parameters=params, variables=[x] + duals,
                         device="cpu")


@pytest.mark.parametrize("method", ["admm", "ipm"])
@pytest.mark.parametrize("seed", range(8))
def test_random_program_meets_its_optimality_conditions(seed, method):
    n, mi, me, lp, P, q, G, h, F, g = _draw(seed)
    layer = _layer(n, mi, me, P)
    vals = [q, G, h] + ([F, g] if me else [])
    args = {"solve_method": method}
    if method == "ipm" and lp:
        args["ipm_mode"] = "pd"
    outs, status, _ = layer.solve_with_info(
        *(torch.as_tensor(a) for a in vals), solver_args=args)
    assert (status == 0).all(), status
    x, lam, d_lo, d_hi = (o.numpy() for o in outs[:4])
    nu = outs[4].numpy() if me else np.zeros((_B, 0))
    tol = 1e-6
    for i in range(_B):
        # primal feasibility
        assert (G[i] @ x[i] - h[i]).max() < tol
        assert np.abs(x[i]).max() < 1 + tol
        assert np.abs(F[i] @ x[i] - g[i]).max(initial=0.0) < tol
        # dual feasibility and complementary slackness
        for d in (lam[i], d_lo[i], d_hi[i]):
            assert d.min() > -tol
        assert np.abs(lam[i] * (h[i] - G[i] @ x[i])).max() < tol
        assert np.abs(d_lo[i] * (x[i] + 1)).max() < tol
        assert np.abs(d_hi[i] * (1 - x[i])).max() < tol
        # stationarity of the Lagrangian
        grad = (P @ x[i] + q[i] + G[i].T @ lam[i] - d_lo[i] + d_hi[i]
                + F[i].T @ nu[i])
        assert np.abs(grad).max() < tol
        if lp:
            res = sopt.linprog(q[i], A_ub=G[i], b_ub=h[i],
                               A_eq=F[i] if me else None,
                               b_eq=g[i] if me else None,
                               bounds=[(-1, 1)] * n, method="highs")
            assert abs(q[i] @ x[i] - res.fun) < 1e-7 * (1 + abs(res.fun))
