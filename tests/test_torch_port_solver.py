"""Port solver: batched ADMM and the polished solve against the reference.

Identical dense (P, q, A, b) go through the reference's make_admm_solver /
make_polished_solver under jax.vmap and through the port's batched
counterparts, in f64 on the CPU. Statuses and iteration counts must be
equal and (x, y, s) agree to 1e-8: the two run the same arithmetic, and
reassociated sums at f64 stay far below the solver tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.solver.admm import make_admm_solver as j_admm
from cvxpylayers_tpu.solver.refine import make_polished_solver as j_polished
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.solver.admm import make_admm_solver as t_admm
from cvxpylayers_tpu_torch.solver.refine import (
    make_polished_solver as t_polished,
)
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings
from cvxpylayers_tpu_torch.solver.settings import (
    DUAL_INFEASIBLE,
    PRIMAL_INFEASIBLE,
)

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


def _run_both(which, data, n_zero, settings_kw, p_diag_full=True):
    P, q, A, b = data
    B, n = q.shape
    m = b.shape[1]
    jd = JDims(zero=n_zero, nonneg=m - n_zero)
    td = TDims(zero=n_zero, nonneg=m - n_zero)
    js = JSettings().replace(**settings_kw)
    ts = TSettings().replace(**settings_kw)
    if which == "admm":
        jsolve = j_admm(jd, n, js)
        tsolve = t_admm(td, n, ts)
    else:
        jsolve = j_polished(jd, n, js, p_diag_full=p_diag_full)
        tsolve = t_polished(td, n, ts, p_diag_full=p_diag_full)
    zeros = (np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m)))
    jr = jax.jit(jax.vmap(jsolve))(*(jnp.asarray(a) for a in data + zeros))
    tr = tsolve(*(torch.as_tensor(a) for a in data + zeros))
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
    # lane 1: minimize -x1 with x1 free (unbounded, P = 0)
    P = np.stack([np.eye(2), np.zeros((2, 2))])
    q = np.array([[0.3, -0.2], [-1.0, 0.0]])
    A = np.array([[[-1.0, 0.0], [1.0, 0.0]], [[0.0, 1.0], [0.0, 0.0]]])
    b = np.array([[-1.0, -1.0], [1.0, 0.0]])
    for which in ("admm", "polished"):
        jr, tr = _run_both(which, (P, q, A, b), 0, {}, p_diag_full=False)
        np.testing.assert_array_equal(tr.status.numpy(),
                                      np.asarray(jr.status))
        np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jr.iters))
        assert tr.status.tolist() == [PRIMAL_INFEASIBLE, DUAL_INFEASIBLE]


def test_warm_start_and_settings_match_reference():
    # a warm start from a nearby point, a short epoch and no adaptive rho
    data = _random_qps(3, 4, 1, 6, seed=41)
    P, q, A, b = data
    kw = {"epoch": 10, "adaptive_rho": False, "refine_steps": 3}
    cold_j, _ = _run_both("polished", data, 1, kw)
    r = np.random.default_rng(0)
    warm = tuple(np.asarray(a) + 1e-3 * r.standard_normal(np.shape(a))
                 for a in (cold_j.x, cold_j.y, cold_j.s))
    B, n = q.shape
    m = b.shape[1]
    js = JSettings().replace(**kw)
    ts = TSettings().replace(**kw)
    jsolve = j_polished(JDims(zero=1, nonneg=m - 1), n, js)
    tsolve = t_polished(TDims(zero=1, nonneg=m - 1), n, ts)
    jr = jax.jit(jax.vmap(jsolve))(*(jnp.asarray(a) for a in data + warm))
    tr = tsolve(*(torch.as_tensor(a) for a in data + warm))
    _assert_same(jr, tr)
