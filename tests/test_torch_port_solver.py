"""Port solver: batched ADMM and the polished solve against the reference.

Identical dense (P, q, A, b) go through the reference's make_admm_solver /
make_polished_solver under jax.vmap and through the port's batched
counterparts, in f64 on the CPU. Statuses and iteration counts must be
equal and (x, y, s) agree to 1e-8: the two run the same arithmetic, and
reassociated sums at f64 stay far below the solver tolerances.

The pieces under the solvers go through the same comparison on their own:
the cone projection and its derivative, the KKT residual map and its
generalized Jacobian, and the KKT solve the polish and the adjoint share.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.cones import jacobians as j_jac
from cvxpylayers_tpu.cones.projections import make_cone_projector as j_proj
from cvxpylayers_tpu.solver import kkt as j_kkt
from cvxpylayers_tpu.solver.admm import make_admm_solver as j_admm
from cvxpylayers_tpu.solver.refine import make_polished_solver as j_polished
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones import jacobians as t_jac
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.cones.projections import (
    make_cone_projector as t_proj,
)
from cvxpylayers_tpu_torch.solver import kkt as t_kkt
from cvxpylayers_tpu_torch.solver.admm import make_admm_solver as t_admm
from cvxpylayers_tpu_torch.solver.refine import (
    make_polished_solver as t_polished,
)
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings
from cvxpylayers_tpu_torch.solver.settings import (
    DUAL_INFEASIBLE,
    PRIMAL_INFEASIBLE,
    SOLVED,
)

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-8


def _random_qps(B, n, n_zero, n_nonneg, seed, lp=False):
    """Feasible, bounded QPs: b = A x0 + s0 with s0 in K."""
    r = np.random.default_rng(seed)
    m = n_zero + n_nonneg
    L = r.standard_normal((B, n, n)) * 0.3
    P = (np.zeros((B, n, n)) if lp
         else L @ L.transpose(0, 2, 1) + 0.1 * np.eye(n))
    A = r.standard_normal((B, m, n))
    if lp:
        # box rows keep the LP bounded: x <= 1 and -x <= 1
        A[:, n_zero:n_zero + 2 * n] = np.concatenate([np.eye(n), -np.eye(n)])
    x0 = r.standard_normal((B, n)) * 0.5
    s0 = np.concatenate(
        [np.zeros((B, n_zero)), np.abs(r.standard_normal((B, n_nonneg)))],
        axis=1,
    )
    s0[:, n_zero:] *= r.random((B, n_nonneg)) > 0.4  # some active rows
    b = np.einsum("bmn,bn->bm", A, x0) + s0
    if lp:
        b[:, n_zero:n_zero + 2 * n] = 1.0
    q = r.standard_normal((B, n))
    return P, q, A, b


@functools.lru_cache(maxsize=None)
def _jax_solver(which, n, n_zero, n_nonneg, kw, p_diag_full):
    """One jitted, vmapped reference solver per structure and settings:
    compiling it is the cost of this module, so tests share structures."""
    jd = JDims(zero=n_zero, nonneg=n_nonneg)
    js = JSettings().replace(**dict(kw))
    jsolve = (j_admm(jd, n, js) if which == "admm"
              else j_polished(jd, n, js, p_diag_full=p_diag_full))
    return jax.jit(jax.vmap(jsolve))


def _run_both(which, data, n_zero, settings_kw, p_diag_full=True,
              warm=None):
    P, q, A, b = data
    B, n = q.shape
    m = b.shape[1]
    td = TDims(zero=n_zero, nonneg=m - n_zero)
    ts = TSettings().replace(**settings_kw)
    tsolve = (t_admm(td, n, ts) if which == "admm"
              else t_polished(td, n, ts, p_diag_full=p_diag_full))
    init = warm or (np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m)))
    args = tuple(data) + tuple(init)
    jr = _jax_solver(which, n, n_zero, m - n_zero,
                     tuple(sorted(settings_kw.items())), p_diag_full)(
        *(jnp.asarray(a) for a in args))
    tr = tsolve(*(torch.as_tensor(a) for a in args))
    return jr, tr


def _assert_same(jr, tr, fields=("x", "y", "s")):
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jr.iters))
    for f in fields:
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)),
                                   atol=_ATOL, rtol=0)


@pytest.mark.parametrize("which", ["admm", "polished"])
@pytest.mark.parametrize("n_zero", [0, 2])
def test_qp_matches_reference(which, n_zero):
    data = _random_qps(4, 5, n_zero, 7, seed=20 + n_zero)
    jr, tr = _run_both(which, data, n_zero, {})
    _assert_same(jr, tr)
    assert tr.x.dtype == torch.float64


def test_lp_polish_on_cg_normal_route_matches_reference():
    # an LP (no curvature) takes the p_diag_full=False KKT route
    data = _random_qps(3, 3, 1, 8, seed=31, lp=True)
    jr, tr = _run_both("polished", data, 1, {}, p_diag_full=False)
    _assert_same(jr, tr)


def test_infeasible_and_unbounded_statuses_match_reference():
    # lane 0: x1 >= 1 and x1 <= -1 (primal infeasible, P = I);
    # lane 1: minimize -x1 with x1 free (unbounded, P = 0);
    # lane 2: minimize x1 over x1 >= -1 (solved).
    # Padded to the LP test's shapes (B = 3, n = 3, one equality row, 8
    # nonneg rows) with x3 = 0 and trivial rows 0 <= 1, so that its
    # compiled reference serves here too.
    n, m = 3, 9
    P = np.zeros((3, n, n))
    P[0, :2, :2] = np.eye(2)
    P[2] = np.eye(n)
    q = np.array([[0.3, -0.2, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    A = np.zeros((3, m, n))
    b = np.ones((3, m))
    A[2, 1, 0] = -1.0                       # x1 >= -1
    A[:, 0, 2], b[:, 0] = 1.0, 0.0          # x3 = 0
    A[0, 1, 0], b[0, 1] = -1.0, -1.0        # x1 >= 1
    A[0, 2, 0], b[0, 2] = 1.0, -1.0         # x1 <= -1
    A[1, 1, 1], b[1, 1] = 1.0, 1.0          # x2 <= 1
    b[1, 2] = 0.0                           # 0 <= 0
    for which in ("admm", "polished"):
        jr, tr = _run_both(which, (P, q, A, b), 1, {}, p_diag_full=False)
        np.testing.assert_array_equal(tr.status.numpy(),
                                      np.asarray(jr.status))
        np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jr.iters))
        assert tr.status.tolist() == [PRIMAL_INFEASIBLE, DUAL_INFEASIBLE,
                                      SOLVED]


def test_warm_start_and_settings_match_reference():
    # a warm start from a nearby point, a short epoch and no adaptive rho
    data = _random_qps(3, 4, 1, 6, seed=41)
    kw = {"epoch": 10, "adaptive_rho": False, "refine_steps": 3}
    cold_j, _ = _run_both("polished", data, 1, kw)
    r = np.random.default_rng(0)
    warm = tuple(np.asarray(a) + 1e-3 * r.standard_normal(np.shape(a))
                 for a in (cold_j.x, cold_j.y, cold_j.s))
    jr, tr = _run_both("polished", data, 1, kw, warm=warm)
    _assert_same(jr, tr)


# ------------------------------------------- the pieces under the solvers


def _cone_vectors(B, m, seed):
    r = np.random.default_rng(seed)
    w = r.standard_normal((B, m))
    w[0, -1] = 0.0  # on the boundary: both sides take the same branch
    return w, r.standard_normal((B, m))


@pytest.mark.parametrize("n_zero", [0, 2])
def test_cone_projection_and_derivative_match_reference(n_zero):
    m = 6
    jd, td = JDims(zero=n_zero, nonneg=m - n_zero), \
        TDims(zero=n_zero, nonneg=m - n_zero)
    w, v = _cone_vectors(4, m, seed=70 + n_zero)
    wj, vj, wt, vt = jnp.asarray(w), jnp.asarray(v), torch.as_tensor(w), \
        torch.as_tensor(v)
    np.testing.assert_array_equal(
        t_proj(td)(wt).numpy(),
        np.asarray(jax.jit(jax.vmap(j_proj(jd)))(wj)))
    np.testing.assert_array_equal(
        t_jac.make_cone_dproj_dense(td)(wt).numpy(),
        np.asarray(
            jax.jit(jax.vmap(j_jac.make_cone_dproj_dense(jd)))(wj)))
    want = np.asarray(
        jax.jit(jax.vmap(j_jac.make_cone_dproj_apply(jd)))(wj, vj))
    np.testing.assert_array_equal(
        t_jac.make_cone_dproj_apply(td)(wt, vt).numpy(), want)
    factor, apply = t_jac.make_cone_dproj_factored(td)
    np.testing.assert_array_equal(apply(factor(wt), vt).numpy(), want)
    # zero rows project to 0 and have no derivative
    assert not t_proj(td)(wt)[:, :n_zero].any()
    assert not want[:, :n_zero].any()


def _kkt_point(n_zero, seed):
    """Problem data and a point (x, w) near, not at, a solution."""
    P, q, A, b = _random_qps(3, 4, n_zero, 5, seed=seed)
    r = np.random.default_rng(seed)
    x = r.standard_normal(q.shape) * 0.5
    w = r.standard_normal(b.shape)
    return x, w, P, q, A, b


@pytest.mark.parametrize("n_zero", [0, 2])
def test_kkt_residual_and_jacobian_match_reference(n_zero):
    args = _kkt_point(n_zero, seed=80 + n_zero)
    n, m = args[0].shape[1], args[1].shape[1]
    jres, jjac, jsplit = j_kkt.make_kkt(
        JDims(zero=n_zero, nonneg=m - n_zero), n)
    tres, tjac, tsplit = t_kkt.make_kkt(
        TDims(zero=n_zero, nonneg=m - n_zero), n)
    ja = [jnp.asarray(a) for a in args]
    ta = [torch.as_tensor(a) for a in args]
    np.testing.assert_allclose(
        tres(*ta).numpy(), np.asarray(jax.jit(jax.vmap(jres))(*ja)),
        atol=1e-13)
    J = tjac(*ta)
    np.testing.assert_allclose(
        J.numpy(), np.asarray(jax.jit(jax.vmap(jjac))(*ja)), atol=1e-13)
    for g, want in zip(tsplit(ta[1]), jax.jit(jax.vmap(jsplit))(ja[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    # the Jacobian is the derivative of the residual: a central difference
    # along a random direction, away from the kinks of the projection
    d = torch.as_tensor(
        np.random.default_rng(1).standard_normal((3, n + m)))
    step = 1e-6
    hi = [ta[0] + step * d[:, :n], ta[1] + step * d[:, n:]] + ta[2:]
    lo = [ta[0] - step * d[:, :n], ta[1] - step * d[:, n:]] + ta[2:]
    fd = (tres(*hi) - tres(*lo)) / (2 * step)
    np.testing.assert_allclose(
        torch.einsum("bij,bj->bi", J, d).numpy(),
        fd.numpy(), atol=1e-7)


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["newton", "adjoint"])
def test_kkt_solve_matches_reference_and_the_f32_split(transpose):
    n_zero = 1
    args = _kkt_point(n_zero, seed=90)
    n, m = args[0].shape[1], args[1].shape[1]
    rhs = np.random.default_rng(2).standard_normal((3, n + m))
    jsolve = j_kkt.make_kkt_solver(JDims(zero=n_zero, nonneg=m - n_zero), n)
    tsolve = t_kkt.make_kkt_solver(TDims(zero=n_zero, nonneg=m - n_zero), n)
    want = np.asarray(jax.jit(jax.vmap(
        lambda *a: jsolve(*a, transpose=transpose)))(
            *(jnp.asarray(a) for a in args), jnp.asarray(rhs)))
    ta = [torch.as_tensor(a) for a in args]
    got = tsolve(*ta, torch.as_tensor(rhs), transpose=transpose)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)
    # the f64 answer solves the dense system
    _, tjac, _ = t_kkt.make_kkt(TDims(zero=n_zero, nonneg=m - n_zero), n)
    J = tjac(*ta)
    M = J.mT if transpose else J
    np.testing.assert_allclose(
        torch.einsum("bij,bj->bi", M, got).numpy(), rhs, atol=1e-9)
    # f32 takes the range-space Schur split with CG; with one refinement
    # pass it reaches the f64 answer to f32 accuracy
    got32 = tsolve(*(a.float() for a in ta), torch.as_tensor(rhs).float(),
                   transpose=transpose, iter_refine=True)
    assert got32.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got32.numpy(), want, atol=2e-4 * scale)
