"""Stuffed cone programs of every cone family carry across.

The port's canonicalizer is a full copy: it reduces programs with
second-order, exponential, PSD and power cones too, although the layer
solves only zero and nonneg cones so far. For each program, built in both
DSLs, `stuff` must give the same cone dims and sizes, and `eval_data` the
same dense (A, b, q, q0, P) for the same numpy-seeded parameter values.
Numpy and scipy on the host; no solve.
"""

from dataclasses import astuple

import numpy as np
import pytest

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.canon import stuffer as j_stuffer
from cvxpylayers_tpu_torch.canon import stuffer as t_stuffer


def _vec(mod, n=3, **kw):
    return mod.Variable(n), mod.Parameter(n, **kw)


def lasso(m):
    x, b = m.Variable(3), m.Parameter(4)
    A, lam = m.Parameter((4, 3)), m.Parameter(nonneg=True)
    return (m.Minimize(m.norm(A @ x - b, 2) + lam * m.norm(x, 1)), [],
            [A, b, lam])


def ridge_constant_matrix(m):
    x, b = m.Variable(3), m.Parameter(4)
    A = m.Constant(np.arange(12.0).reshape(4, 3) / 7.0 - 0.5)
    return m.Minimize(m.sum_squares(A @ x - b) + 0.1 * m.sum_squares(x)), \
        [], [b]


def soc_constraint(m):
    x, c = _vec(m)
    r = m.Parameter(nonneg=True)
    return m.Minimize(c @ x), [m.norm(x, 2) <= r, m.sum(x) == 1], [c, r]


def explicit_soc(m):
    x, c = _vec(m)
    t = m.Variable()
    return m.Minimize(t + c @ x), [m.SOC(t, x - c)], [c]


def huber_regression(m):
    x, b = m.Variable(2), m.Parameter(4)
    A = m.Parameter((4, 2))
    return m.Minimize(m.sum(m.huber(A @ x - b, 1.0))), [], [A, b]


def logistic_regression(m):
    x, A = m.Variable(2), m.Parameter((4, 2))
    return m.Minimize(m.sum(m.logistic(A @ x)) + 0.1 * m.sum_squares(x)), \
        [], [A]


def entropy_maximization(m):
    x, c = _vec(m)
    return m.Maximize(m.sum(m.entr(x)) + c @ x), [m.sum(x) == 1], [c]


def log_sum_exp_bound(m):
    x, c = _vec(m)
    return m.Minimize(c @ x + m.sum_squares(x)), \
        [m.log_sum_exp(x) <= 1.0], [c]


def exp_cone_direct(m):
    x, c = _vec(m)
    return m.Minimize(c @ x), [m.ExpCone(x[0], x[1], x[2]), x <= 5,
                               x >= -5], [c]


def geometric_mean(m):
    x, w = _vec(m, pos=True)
    return m.Maximize(m.geo_mean(x)), [w @ x <= 1], [w]


def power_cone_direct(m):
    x, c = _vec(m)
    return m.Minimize(c @ x), [m.PowCone3D(x[0], x[1], x[2], 0.3),
                               x <= 2], [c]


def psd_projection(m):
    X, C = m.Variable((3, 3), symmetric=True), m.Parameter((3, 3))
    return m.Minimize(m.sum_squares(X - C)), [X >> 0, m.trace(X) == 1], [C]


def max_eigenvalue(m):
    x, c = _vec(m, n=2)
    F0 = m.Constant(np.diag([1.0, 2.0, 3.0]))
    F1 = m.Constant(np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1.0]]))
    F2 = m.Constant(np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0.0]]))
    return m.Minimize(m.lambda_max(F0 + x[0] * F1 + x[1] * F2)
                      + m.sum_squares(x - c)), [], [c]


def log_det_cover(m):
    X, C = m.Variable((2, 2), symmetric=True), m.Parameter((2, 2))
    return m.Maximize(m.log_det(X) - m.trace(C @ X)), [X << 4 * np.eye(2)], \
        [C]


def portfolio(m):
    x, mu = _vec(m, n=4)
    F = m.Constant(np.arange(8.0).reshape(2, 4) / 5.0 - 0.6)
    gamma = m.Parameter(nonneg=True)
    return m.Maximize(mu @ x - gamma * m.sum_squares(F @ x)
                      - 0.05 * m.norm(x, 1)), [m.sum(x) == 1, x >= 0], \
        [mu, gamma]


def mixed_cones(m):
    x, c = _vec(m, n=4)
    return m.Minimize(c @ x + m.norm(x[:2], 2) + m.exp(x[2])
                      + m.inv_pos(x[3])), [x >= -3, x[3] <= 3], [c]


_PROGRAMS = [
    lasso, ridge_constant_matrix, soc_constraint, explicit_soc,
    huber_regression, logistic_regression, entropy_maximization,
    log_sum_exp_bound, exp_cone_direct, geometric_mean, power_cone_direct,
    psd_projection, max_eigenvalue, log_det_cover, portfolio, mixed_cones,
]


def _values(params, seed):
    r = np.random.default_rng(seed)
    vals = []
    for p in params:
        v = r.standard_normal(p.shape)
        if p.shape == (3, 3) or p.shape == (2, 2):
            v = v @ v.T + np.eye(p.shape[0])  # symmetric where it matters
        sign = p.sign().name
        vals.append(np.abs(v) + 0.1 if sign in ("NONNEG", "POS") else v)
    return vals


@pytest.mark.parametrize("build", _PROGRAMS, ids=lambda f: f.__name__)
def test_stuffed_program_carries_across(build):
    oj, cons_j, par_j = build(cj)
    ot, cons_t, par_t = build(ct)
    prog_j = j_stuffer.stuff(cj.Problem(oj, cons_j), par_j)
    prog_t = t_stuffer.stuff(ct.Problem(ot, cons_t), par_t)
    assert astuple(prog_t.dims) == astuple(prog_j.dims)
    assert (prog_t.n, prog_t.m) == (prog_j.n, prog_j.m)
    assert prog_t.m == prog_t.dims.total
    assert prog_t.A_is_constant == prog_j.A_is_constant
    assert prog_t.P_is_constant == prog_j.P_is_constant
    vals = _values(par_t, seed=_PROGRAMS.index(build))
    want = j_stuffer.eval_data(prog_j, vals)
    got = t_stuffer.eval_data(prog_t, vals)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-12, rtol=0)
    # not an empty program (an unconstrained quadratic has no rows at all)
    assert np.abs(got[0]).sum() + np.abs(got[4]).sum() > 0
