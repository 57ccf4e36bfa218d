"""The port's cvxpy interop shim: tests/test_interop_stub.py's fourteen
conformance cases, solved by the port.

Each case builds a cvxpy problem on `tests/_cvxpy_stub.py` (put under
`sys.modules["cvxpy"]` through monkeypatch), converts it with both
packages' shims, holds the two converted programs equal field for field
(maps to 1e-14, tests/_port_programs.py), then hands the cvxpy Problem
to the port's `CvxpyLayer(..., device="cpu")` and holds its f64 solution
to the case's closed form or independent oracle at the tolerance the
reference's case uses (1e-7 to 1e-4; the LAD case against a twin layer
declared in the port's own DSL).
"""

import importlib
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from _port_programs import assert_same_program
from scipy.optimize import linprog
from scipy.optimize import minimize as spmin

import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.canon import cvxpy_interop as j_interop
from cvxpylayers_tpu.canon import stuff as j_stuff
from cvxpylayers_tpu_torch.canon import cvxpy_interop as interop
from cvxpylayers_tpu_torch.canon import stuff

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

try:
    import cvxpy as _real_cvxpy  # noqa: F401

    HAVE_REAL = True
except ImportError:
    HAVE_REAL = False

rng = np.random.default_rng(7)
_TIGHT = {"eps_abs": 1e-8, "eps_rel": 1e-8}


@pytest.fixture
def cp(monkeypatch):
    """The stub as `cvxpy` (skipped when the real one exists)."""
    if HAVE_REAL:
        pytest.skip("real cvxpy installed; the stub stands in for it only")
    stub = importlib.import_module("_cvxpy_stub")
    monkeypatch.setitem(sys.modules, "cvxpy", stub)
    yield stub


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def layer_of(prob, parameters, variables, **kw):
    """The port's layer on the cvxpy problem, after holding both shims'
    conversions to the same cone program."""
    out = interop.convert_problem(prob, parameters, variables)
    ref = j_interop.convert_problem(prob, parameters, variables)
    assert_same_program(stuff(out[0], out[1]), j_stuff(ref[0], ref[1]))
    return ct.CvxpyLayer(prob, parameters=parameters, variables=variables,
                         device="cpu", **kw)


def test_lad_regression(cp):
    n, m = 2, 4
    x = cp.Variable(n)
    A = cp.Parameter((m, n))
    b = cp.Parameter(m)
    prob = cp.Problem(cp.Minimize(cp.norm(A @ x - b, 1)), [x >= 0])
    layer = layer_of(prob, [A, b], [x])
    Av = rng.standard_normal((m, n))
    bv = rng.standard_normal(m)
    (xs,) = layer(_t(Av), _t(bv))
    # oracle: the twin layer declared in the port's own DSL
    xn = ct.Variable(n)
    An = ct.Parameter((m, n))
    bn = ct.Parameter(m)
    twin = ct.CvxpyLayer(
        ct.Problem(ct.Minimize(ct.pnorm(An @ xn - bn, 1)), [xn >= 0]),
        parameters=[An, bn], variables=[xn], device="cpu",
    )
    (xt,) = twin(_t(Av), _t(bv))
    np.testing.assert_allclose(xs.numpy(), xt.numpy(), atol=1e-7)


def test_least_squares_with_gradients(cp):
    n, m = 3, 6
    beta = cp.Variable(n)
    X = cp.Parameter((m, n))
    y = cp.Parameter(m)
    prob = cp.Problem(cp.Minimize(cp.sum_squares(X @ beta - y)))
    layer = layer_of(prob, [X, y], [beta])
    Xv = rng.standard_normal((m, n))
    yv = rng.standard_normal(m)
    (bs,) = layer(_t(Xv), _t(yv))
    ref = np.linalg.lstsq(Xv, yv, rcond=None)[0]
    np.testing.assert_allclose(bs.numpy(), ref, atol=1e-6)

    def loss(y_):
        return (layer(_t(Xv), y_)[0] ** 2).sum()

    yt = _t(yv).requires_grad_()
    loss(yt).backward()
    eps = 1e-6
    for i in range(0, m, 2):
        e = np.zeros(m)
        e[i] = eps
        fd = (float(loss(_t(yv + e))) - float(loss(_t(yv - e)))) / (2 * eps)
        np.testing.assert_allclose(float(yt.grad[i]), fd, atol=1e-4)


def test_simplex_projection_with_eq_dual(cp):
    n = 5
    x = cp.Variable(n)
    v = cp.Parameter(n)
    cons = [cp.sum(x) == 1, x >= 0]
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x - v)), cons)
    layer = layer_of(prob, [v], [x, cons[0]])
    vv = rng.standard_normal(n)
    xs, nu = layer(_t(vv))
    xs = xs.numpy()
    assert abs(xs.sum() - 1.0) < 1e-6 and xs.min() > -1e-7
    # KKT: on the support nu = -2(x - v)_i, sign convention modulo
    active = xs > 1e-6
    kkt = 2 * (xs - vv)[active]
    assert np.allclose(kkt, kkt[0], atol=1e-5)
    assert abs(abs(float(nu)) - abs(kkt[0])) < 1e-4


def test_logistic_regression_exp_cone(cp):
    nf, ns = 2, 6
    beta = cp.Variable(nf)
    Xy = cp.Parameter((ns, nf))
    prob = cp.Problem(
        cp.Minimize(cp.sum(cp.logistic(Xy @ beta))
                    + 0.1 * cp.sum_squares(beta))
    )
    layer = layer_of(prob, [Xy], [beta])
    Xv = rng.standard_normal((ns, nf))
    (bs,) = layer(_t(Xv), solver_args={"solve_method": "ipm"})

    def f(b_):
        return float(np.logaddexp(0, Xv @ b_).sum() + 0.1 * (b_ @ b_))

    ref = spmin(f, np.zeros(nf), method="BFGS", tol=1e-12).x
    np.testing.assert_allclose(bs.numpy(), ref, atol=1e-5)


def test_sdp_trace_objective(cp):
    s = 3
    X = cp.Variable((s, s), symmetric=True)
    C = cp.Parameter((s, s))
    prob = cp.Problem(cp.Minimize(cp.trace(C @ X)),
                      [cp.trace(X) == 1, X >> 0])
    layer = layer_of(prob, [C], [X])
    Cv = rng.standard_normal((s, s))
    Cv = (Cv + Cv.T) / 2
    (Xs,) = layer(_t(Cv))
    w = np.linalg.eigvalsh(Cv)
    np.testing.assert_allclose(float(np.trace(Cv @ Xs.numpy())), w[0],
                               atol=1e-6)


def test_socp_norm_constraint(cp):
    n = 4
    x = cp.Variable(n)
    v = cp.Parameter(n)
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x - v)),
                      [cp.norm(x, 2) <= 1.0])
    layer = layer_of(prob, [v], [x])
    vv = rng.standard_normal(n) * 2
    (xs,) = layer(_t(vv))
    np.testing.assert_allclose(xs.numpy(),
                               vv / max(np.linalg.norm(vv), 1.0), atol=1e-6)


def test_optnet_box_qp_matrix_param_constraint(cp):
    """A matrix parameter inside a constraint, a batched call with one
    unbatched (broadcast) parameter."""
    n, m = 4, 3
    x = cp.Variable(n)
    vv = cp.Parameter(n)
    G = cp.Parameter((m, n))
    h = cp.Parameter(m)
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x - vv)),
                      [G @ x <= h, x >= 0, x <= 1])
    layer = layer_of(prob, [vv, G, h], [x])
    B = 3
    v_b = rng.standard_normal((B, n))
    G_u = rng.standard_normal((m, n)) * 0.3
    h_b = np.abs(rng.standard_normal((B, m))) + 1.0
    (xs,) = layer(_t(v_b), _t(G_u), _t(h_b))
    assert xs.shape == (B, n)
    for i in range(B):
        ref = spmin(
            lambda z: float(((z - v_b[i]) ** 2).sum()), np.clip(v_b[i], 0, 1),
            constraints=[{"type": "ineq",
                          "fun": lambda z: h_b[i] - G_u @ z}],
            bounds=[(0.0, 1.0)] * n, method="SLSQP",
            options={"ftol": 1e-12},
        ).x
        np.testing.assert_allclose(xs[i].numpy(), ref, atol=1e-4)


def test_entropy_projection_with_entr(cp):
    """max c'y + sum(entr(y)) s.t. sum(y) = 1: y* = softmax(c)."""
    n = 6
    y = cp.Variable(n, nonneg=True)
    c = cp.Parameter(n)
    prob = cp.Problem(cp.Maximize(c @ y + cp.sum(cp.entr(y))),
                      [cp.sum(y) == 1])
    layer = layer_of(prob, [c], [y])
    cv = rng.standard_normal(n)
    (ys,) = layer(_t(cv), solver_args={"solve_method": "ipm", **_TIGHT})
    np.testing.assert_allclose(ys.numpy(), np.exp(cv) / np.exp(cv).sum(),
                               atol=1e-5)


def test_scipy_sparse_constant(cp):
    """A cvxpy Constant holding a scipy.sparse matrix is densified."""
    n = 4
    x = cp.Variable(n)
    v = cp.Parameter(n)
    D = sp.diags([2.0, 1.0, 0.5, 0.25]).tocsr()
    prob = cp.Problem(cp.Minimize(cp.sum_squares(cp.Constant(D) @ x - v)))
    layer = layer_of(prob, [v], [x])
    vv = rng.standard_normal(n)
    (xs,) = layer(_t(vv))
    np.testing.assert_allclose(xs.numpy(), vv / np.array([2, 1, 0.5, 0.25]),
                               atol=1e-6)


def test_scalene_composition_and_promote(cp):
    n = 3
    x = cp.Variable(n)
    p = cp.Parameter(n)
    t = cp.Parameter()  # scalar, Promote-broadcast to (n,)
    obj = (cp.sum(cp.scalene(x - p, 2.0, 3.0))
           + cp.sum_squares(x - cp.Promote(t, (n,))))
    layer = layer_of(cp.Problem(cp.Minimize(obj)), [p, t], [x])
    pv = rng.standard_normal(n)
    tv = 0.3
    (xs,) = layer(_t(pv), _t(tv), solver_args=_TIGHT)

    def f(z):
        r = z - pv
        return float(2.0 * np.maximum(r, 0).sum()
                     + 3.0 * np.maximum(-r, 0).sum() + ((z - tv) ** 2).sum())

    ref = spmin(f, pv, method="Nelder-Mead",
                options={"xatol": 1e-10, "fatol": 1e-12}).x
    np.testing.assert_allclose(xs.numpy(), ref, atol=1e-4)


def test_index_slicing_constraints(cp):
    n = 4
    x = cp.Variable(n)
    v = cp.Parameter(n)
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x - v)),
                      [x[0] == x[3], x[1:3] <= 0.5])
    layer = layer_of(prob, [v], [x])
    vv = rng.standard_normal(n) + 0.5
    (xs,) = layer(_t(vv), solver_args=_TIGHT)
    ref = spmin(
        lambda z: float(((z - vv) ** 2).sum()), vv, method="SLSQP",
        constraints=[{"type": "eq", "fun": lambda z: z[0] - z[3]},
                     {"type": "ineq", "fun": lambda z: 0.5 - z[1:3]}],
        options={"ftol": 1e-12},
    ).x
    np.testing.assert_allclose(xs.numpy(), ref, atol=1e-5)


def test_huber_robust_regression(cp):
    m, n, M = 6, 3, 0.6
    A = rng.standard_normal((m, n))
    x = cp.Variable(n)
    b = cp.Parameter(m)
    prob = cp.Problem(cp.Minimize(cp.sum(cp.huber(A @ x - b, M))
                                  + 0.01 * cp.sum_squares(x)))
    layer = layer_of(prob, [b], [x])
    bv = rng.standard_normal(m) * 2.0
    (xs,) = layer(_t(bv), solver_args=_TIGHT)

    def f(z):
        r = np.abs(A @ z - bv)
        h = np.where(r <= M, r ** 2, M * (2 * r - M))
        return float(h.sum() + 0.01 * (z ** 2).sum())

    ref = spmin(f, np.zeros(n), method="Nelder-Mead",
                options={"xatol": 1e-10, "fatol": 1e-13,
                         "maxiter": 20000}).x
    np.testing.assert_allclose(xs.numpy(), ref, atol=1e-4)


def test_quad_over_lin_closed_form(cp):
    """min qol(x - v, t) + t s.t. sum(x) = 1, t >= 0.1: the mean-shift
    projection, t = |1 - sum(v)| / sqrt(n)."""
    n = 4
    x = cp.Variable(n)
    t = cp.Variable(nonneg=True)
    v = cp.Parameter(n)
    prob = cp.Problem(cp.Minimize(cp.quad_over_lin(x - v, t) + t),
                      [cp.sum(x) == 1, t >= 0.1])
    layer = layer_of(prob, [v], [x, t])
    vv = rng.standard_normal(n) + 2.0
    xs, ts = layer(_t(vv), solver_args=_TIGHT)
    ref_t = np.abs(1.0 - vv.sum()) / np.sqrt(n)
    assert ref_t > 0.1  # the bound is inactive by construction
    np.testing.assert_allclose(xs.numpy(), vv + (1.0 - vv.sum()) / n,
                               atol=1e-5)
    np.testing.assert_allclose(float(ts), ref_t, atol=1e-5)


def test_norm_inf_chebyshev(cp):
    m, n = 5, 2
    A = rng.standard_normal((m, n))
    x = cp.Variable(n)
    b = cp.Parameter(m)
    prob = cp.Problem(cp.Minimize(cp.norm(A @ x - b, "inf")))
    layer = layer_of(prob, [b], [x])
    bv = rng.standard_normal(m)
    (xs,) = layer(_t(bv), solver_args=_TIGHT)
    c = np.r_[np.zeros(n), 1.0]
    A_ub = np.block([[A, -np.ones((m, 1))], [-A, -np.ones((m, 1))]])
    lp = linprog(c, A_ub=A_ub, b_ub=np.r_[bv, -bv],
                 bounds=[(None, None)] * (n + 1))
    obj = float(np.max(np.abs(A @ xs.numpy() - bv)))
    np.testing.assert_allclose(obj, lp.fun, atol=1e-5)
