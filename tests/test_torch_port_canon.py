"""Port front end: the canonical program carries across.

The same problem built in both packages' DSLs must give the same cone
dims and sizes, and, for the same parameter values, the same dense
(P, q, A, b) out of stuff() + the layer's _assemble. The raw COO order
may differ (the reference may use its native join).
"""

from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct


def box_qp(mod, n=8, m_ineq=4):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    G = mod.Parameter((m_ineq, n))
    h = mod.Parameter(m_ineq)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [G @ x <= h, x >= 0, x <= 1])
    return prob, [v, G, h], [x]


def simplex(mod, n=6):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [mod.sum(x) == 1, x >= 0])
    return prob, [v], [x]


def lad(mod, n=2, m=3):
    x = mod.Variable(n, nonneg=True)
    A = mod.Parameter((m, n))
    b = mod.Parameter(m)
    prob = mod.Problem(mod.Minimize(0.5 * mod.pnorm(A @ x - b, 1)))
    return prob, [A, b], [x]


def _values(params, B, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B,) + tuple(p.shape)) for p in params]


@pytest.mark.parametrize("build", [box_qp, simplex, lad],
                         ids=["box_qp", "simplex", "lad"])
def test_dense_program_carries_across(build):
    prob_j, par_j, var_j = build(cj)
    prob_t, par_t, var_t = build(ct)
    lj = cj.CvxpyLayer(prob_j, parameters=par_j, variables=var_j)
    lt = ct.CvxpyLayer(prob_t, parameters=par_t, variables=var_t,
                       device="cpu")
    assert astuple(lt.prog.dims) == astuple(lj.prog.dims)
    assert (lt.prog.n, lt.prog.m) == (lj.prog.n, lj.prog.m)
    assert lt._p_diag_full == lj._p_diag_full
    assert lt._p_diag_only == lj._p_diag_only

    B = 3
    vals = _values(par_j, B, seed=5)
    flags = [True] * len(vals)
    p_ext_j = lj._stack_params([jnp.asarray(v) for v in vals], B, flags)
    p_ext_t = lt._stack_params([torch.as_tensor(v) for v in vals], B, flags)
    np.testing.assert_array_equal(np.asarray(p_ext_j), p_ext_t.numpy())

    got = lt._assemble(p_ext_t)
    for i in range(B):
        want = lj._assemble(p_ext_j[i])
        for w, g in zip(want, got):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       atol=1e-12, rtol=0)


def test_out_of_slice_features_raise():
    x = ct.Variable(3)
    p = ct.Parameter(3)
    soc = ct.Problem(ct.Minimize(ct.norm(x - p, 2)))
    with pytest.raises(NotImplementedError, match="later port slice"):
        ct.CvxpyLayer(soc, parameters=[p], variables=[x], device="cpu")
    with pytest.raises(NotImplementedError, match="later port slice"):
        ct.Problem(ct.Minimize(ct.sum_squares(x - p))).solve()
    with pytest.raises(NotImplementedError, match="later port slice"):
        _ = x / p
