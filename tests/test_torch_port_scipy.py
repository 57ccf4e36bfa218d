"""The port's layer against scipy's solvers, with no reference in between.

Small linear and quadratic programs, made from a seed, go through
CvxpyLayer(device="cpu") in f64 by both of its routes (ADMM and the
interior-point method, each followed by the polish) and through an
independent host solver: HiGHS for the linear programs, NNLS, bounded
least squares, a sort-based simplex projection and a direct KKT solve for
the quadratic ones. Optimal values agree to 1e-7 and, where the solution
is unique, the solutions to 1e-6.
"""

import numpy as np
import pytest
import scipy.optimize as sopt
import torch

import cvxpylayers_tpu_torch as ct

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_B = 2


def _layer(objective, constraints, params, x):
    return ct.CvxpyLayer(ct.Problem(objective, constraints),
                         parameters=params, variables=[x], device="cpu")


def box_lp(r):
    n = 4
    c, G = r.standard_normal((_B, n)), r.standard_normal((_B, 3, n))
    x, pc, pG = ct.Variable(n), ct.Parameter(n), ct.Parameter((3, n))
    layer = _layer(ct.Minimize(pc @ x), [pG @ x <= 1, x >= -1, x <= 1],
                   [pc, pG], x)

    def host(i):
        res = sopt.linprog(c[i], A_ub=G[i], b_ub=np.ones(3),
                           bounds=[(-1, 1)] * n, method="highs")
        return res.x, res.fun
    return layer, [c, G], lambda xs, i: c[i] @ xs, host


def lad(r):
    m, n = 6, 2
    A, b = r.standard_normal((_B, m, n)), r.standard_normal((_B, m))
    x, pA, pb = ct.Variable(n), ct.Parameter((m, n)), ct.Parameter(m)
    layer = _layer(ct.Minimize(ct.norm(pA @ x - pb, 1)), [x >= 0],
                   [pA, pb], x)

    def host(i):
        # min 1't  s.t.  -t <= A x - b <= t,  x >= 0
        cost = np.r_[np.zeros(n), np.ones(m)]
        A_ub = np.block([[A[i], -np.eye(m)], [-A[i], -np.eye(m)]])
        res = sopt.linprog(cost, A_ub=A_ub, b_ub=np.r_[b[i], -b[i]],
                           bounds=[(0, None)] * n + [(None, None)] * m,
                           method="highs")
        return res.x[:n], res.fun
    return layer, [A, b], lambda xs, i: np.abs(A[i] @ xs - b[i]).sum(), host


def chebyshev(r):
    m, n = 6, 2
    A, b = r.standard_normal((_B, m, n)), r.standard_normal((_B, m))
    x, pA, pb = ct.Variable(n), ct.Parameter((m, n)), ct.Parameter(m)
    layer = _layer(ct.Minimize(ct.norm(pA @ x - pb, "inf")), [], [pA, pb], x)

    def host(i):
        cost = np.r_[np.zeros(n), 1.0]
        ones = np.ones((m, 1))
        A_ub = np.block([[A[i], -ones], [-A[i], -ones]])
        res = sopt.linprog(cost, A_ub=A_ub, b_ub=np.r_[b[i], -b[i]],
                           bounds=[(None, None)] * (n + 1), method="highs")
        return res.x[:n], res.fun
    return layer, [A, b], lambda xs, i: np.abs(A[i] @ xs - b[i]).max(), host


def equality_lp(r):
    n = 5
    c = np.abs(r.standard_normal((_B, n))) + 0.1
    F = r.standard_normal((_B, 2, n))
    g = np.einsum("bij,bj->bi", F, np.abs(r.standard_normal((_B, n))))
    x, pc, pF, pg = (ct.Variable(n), ct.Parameter(n), ct.Parameter((2, n)),
                     ct.Parameter(2))
    layer = _layer(ct.Minimize(pc @ x), [pF @ x == pg, x >= 0],
                   [pc, pF, pg], x)

    def host(i):
        res = sopt.linprog(c[i], A_eq=F[i], b_eq=g[i],
                           bounds=[(0, None)] * n, method="highs")
        return res.x, res.fun
    return layer, [c, F, g], lambda xs, i: c[i] @ xs, host


def simplex_projection(r):
    n = 6
    v = r.standard_normal((_B, n))
    x, pv = ct.Variable(n), ct.Parameter(n)
    layer = _layer(ct.Minimize(ct.sum_squares(x - pv)),
                   [ct.sum(x) == 1, x >= 0], [pv], x)

    def host(i):
        u = np.sort(v[i])[::-1]
        css = np.cumsum(u) - 1.0
        k = np.nonzero(u - css / np.arange(1, n + 1) > 0)[0][-1]
        xs = np.maximum(v[i] - css[k] / (k + 1), 0.0)
        return xs, ((xs - v[i]) ** 2).sum()
    return layer, [v], lambda xs, i: ((xs - v[i]) ** 2).sum(), host


def nonneg_least_squares(r):
    # the matrix is a constant of the program (a quadratic objective keeps
    # its parameters out of the products), the right-hand side a parameter
    m, n = 7, 4
    A, b = r.standard_normal((m, n)), r.standard_normal((_B, m))
    x, pb = ct.Variable(n), ct.Parameter(m)
    layer = _layer(ct.Minimize(ct.sum_squares(ct.Constant(A) @ x - pb)),
                   [x >= 0], [pb], x)

    def host(i):
        xs, rnorm = sopt.nnls(A, b[i])
        return xs, rnorm ** 2
    return layer, [b], lambda xs, i: ((A @ xs - b[i]) ** 2).sum(), host


def bounded_least_squares(r):
    # the matrix is a constant of the program (a quadratic objective keeps
    # its parameters out of the products), the right-hand side a parameter
    m, n = 7, 4
    A, b = r.standard_normal((m, n)), r.standard_normal((_B, m))
    x, pb = ct.Variable(n), ct.Parameter(m)
    layer = _layer(ct.Minimize(ct.sum_squares(ct.Constant(A) @ x - pb)),
                   [x >= -0.2, x <= 0.3], [pb], x)

    def host(i):
        res = sopt.lsq_linear(A, b[i], bounds=(-0.2, 0.3), method="bvls",
                              tol=1e-14)
        return res.x, 2.0 * res.cost
    return layer, [b], lambda xs, i: ((A @ xs - b[i]) ** 2).sum(), host


def equality_qp(r):
    n = 5
    c, F = r.standard_normal((_B, n)), r.standard_normal((_B, 2, n))
    g = r.standard_normal((_B, 2))
    x, pc, pF, pg = (ct.Variable(n), ct.Parameter(n), ct.Parameter((2, n)),
                     ct.Parameter(2))
    layer = _layer(ct.Minimize(ct.sum_squares(x) + pc @ x), [pF @ x == pg],
                   [pc, pF, pg], x)

    def host(i):
        # stationarity 2x + c + F'nu = 0 with F x = g, solved directly
        K = np.block([[2 * np.eye(n), F[i].T], [F[i], np.zeros((2, 2))]])
        xs = np.linalg.solve(K, np.r_[-c[i], g[i]])[:n]
        return xs, xs @ xs + c[i] @ xs
    return layer, [c, F, g], lambda xs, i: xs @ xs + c[i] @ xs, host


_LINEAR = [box_lp, lad, chebyshev, equality_lp]
_QUADRATIC = [simplex_projection, nonneg_least_squares,
              bounded_least_squares, equality_qp]


@pytest.mark.parametrize("method", ["admm", "ipm"])
@pytest.mark.parametrize("program", _LINEAR + _QUADRATIC,
                         ids=lambda f: f.__name__)
def test_layer_matches_host_solver(program, method):
    seed = 100 + (_LINEAR + _QUADRATIC).index(program)
    layer, values, objective, host = program(np.random.default_rng(seed))
    args = {"solve_method": method}
    if method == "ipm" and program in _LINEAR:
        args["ipm_mode"] = "pd"  # a linear program: the primal-dual form
    (x,), status, _ = layer.solve_with_info(
        *(torch.as_tensor(a) for a in values), solver_args=args)
    assert (status == 0).all(), status
    for i in range(_B):
        x_host, f_host = host(i)
        xs = x[i].numpy()
        assert abs(objective(xs, i) - f_host) < 1e-7 * (1 + abs(f_host))
        np.testing.assert_allclose(xs, x_host, atol=1e-6, rtol=0)
