"""Port front end: the canonical program carries across.

The same problem built in both packages' DSLs must give the same cone
dims and sizes, and, for the same parameter values, the same dense
(P, q, A, b) out of stuff() + the layer's _assemble. The raw COO order
may differ (the reference may use its native join). The cone dims and
the solver settings, which every later stage keys on, carry across
field by field.
"""

from dataclasses import astuple, fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)


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


def eq_qp(mod, n=4):
    x = mod.Variable(n)
    c = mod.Parameter(n)
    G = mod.Parameter((2, n))
    h = mod.Parameter(2)
    F = mod.Parameter((1, n))
    g = mod.Parameter(1)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x) + c @ x),
                       [G @ x <= h, F @ x == g])
    return prob, [c, G, h, F, g], [x]


def box_lp(mod, n=3):
    x = mod.Variable(n)
    c = mod.Parameter(n)
    G = mod.Parameter((2, n))
    prob = mod.Problem(mod.Maximize(c @ x),
                       [G @ x <= 1, x >= -1, x <= 1])
    return prob, [c, G], [x]


def chebyshev(mod, n=2, m=4):
    x = mod.Variable(n)
    A = mod.Parameter((m, n))
    b = mod.Parameter(m)
    prob = mod.Problem(mod.Minimize(mod.norm(A @ x - b, "inf")))
    return prob, [A, b], [x]


def hinge(mod, n=3, m=4):
    x = mod.Variable(n)
    A = mod.Parameter((m, n))
    lam = mod.Parameter(nonneg=True)
    prob = mod.Problem(
        mod.Minimize(mod.sum(mod.pos(1 - A @ x)) + lam * mod.sum(mod.abs(x))))
    return prob, [A, lam], [x]


def max_of_affine(mod, n=2, m=4):
    x = mod.Variable(n)
    A = mod.Parameter((m, n))
    b = mod.Parameter(m)
    prob = mod.Problem(mod.Minimize(mod.max(A @ x - b)), [x >= -1, x <= 1])
    return prob, [A, b], [x]


def l1_ball(mod, n=3):
    x = mod.Variable(n)
    c = mod.Parameter(n)
    r = mod.Parameter(nonneg=True)
    prob = mod.Problem(mod.Minimize(c @ x), [mod.norm(x, 1) <= r])
    return prob, [c, r], [x]


def markowitz(mod, n=4):
    x = mod.Variable(n)
    mu = mod.Parameter(n)
    S = np.eye(n) + 0.3 * np.ones((n, n))
    prob = mod.Problem(
        mod.Minimize(mod.quad_form(x, mod.Constant(S)) - mu @ x),
        [mod.sum(x) == 1, x >= 0])
    return prob, [mu], [x]


_BUILDS = [box_qp, simplex, lad, eq_qp, box_lp, chebyshev, hinge,
           max_of_affine, l1_ball, markowitz]


def _values(params, B, seed):
    r = np.random.default_rng(seed)
    return [np.abs(v) if getattr(p, "nonneg", False) else v
            for p, v in ((p, r.standard_normal((B,) + tuple(p.shape)))
                         for p in params)]


@pytest.mark.parametrize("build", _BUILDS,
                         ids=[f.__name__ for f in _BUILDS])
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
    # a general-cone layer builds and solves by ADMM and, since the
    # interior-point method's cone blocks were ported, by the IPM too
    layer = ct.CvxpyLayer(soc, parameters=[p], variables=[x], device="cpu")
    v = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)
    (sol,) = layer(v, solver_args={"solve_method": "ipm"})
    np.testing.assert_allclose(sol.numpy(), v.numpy(), atol=1e-6)
    # the plain solve and division by an expression behave as the
    # reference's: no value raises, x / p is a (DGP) quotient
    for pk, kw in ((ct, {"device": "cpu"}), (cj, {})):
        xk, pk_ = pk.Variable(3), pk.Parameter(3)
        with pytest.raises(ValueError, match="has no value"):
            pk.Problem(pk.Minimize(pk.sum_squares(xk - pk_))).solve(**kw)
    xj, pj = cj.Variable(3), cj.Parameter(3)
    assert (x / p).curvature().name == (xj / pj).curvature().name
    assert type(x / p).__name__ == type(xj / pj).__name__ == "DivExpression"


_DIMS = [
    dict(zero=2, nonneg=3),
    dict(nonneg=4, soc=(3, 4), exp=1),
    dict(zero=1, psd=(2, 3), pow3=(0.3,)),
]


@pytest.mark.parametrize("kw", _DIMS, ids=["polyhedral", "soc-exp", "psd-pow"])
def test_cone_dims_carry_across(kw):
    jd, td = JDims(**kw), TDims(**kw)
    assert astuple(td) == astuple(jd)
    for prop in ("total", "soc_total", "psd_total", "offset_nonneg",
                 "offset_soc", "offset_exp", "offset_psd", "offset_pow"):
        assert getattr(td, prop) == getattr(jd, prop), prop
    assert td.is_polyhedral() == jd.is_polyhedral()
    assert td.is_polyhedral() == (set(kw) <= {"zero", "nonneg"})
    assert hash(td) == hash(TDims(**kw))  # the layer keys its solvers on it


def test_cone_dims_reject_what_the_reference_rejects():
    for bad in (dict(soc=(0,)), dict(psd=(0,)), dict(pow3=(1.0,))):
        with pytest.raises(ValueError):
            JDims(**bad)
        with pytest.raises(ValueError):
            TDims(**bad)


def test_solver_settings_carry_across():
    js, ts = JSettings(), TSettings()
    jf = {f.name: getattr(js, f.name) for f in fields(js)}
    tf = {f.name: getattr(ts, f.name) for f in fields(ts)}
    assert tf == jf
    kw = {"solve_method": "ipm", "ipm_mode": "pd", "eps_abs": 1e-5,
          "epoch": 7}
    assert astuple(ts.replace(**kw)) == astuple(js.replace(**kw))
    assert ts.replace(**kw) == TSettings(**kw) and ts == TSettings()
    with pytest.raises(TypeError):
        ts.replace(no_such_setting=1)
