"""The port's kernel K2 (plain version) and its interior-point solver
against the reference.

The Householder R factor: the port's plain version (what `qr_r` runs on a
CPU tensor) against both of the reference's Householder functions, the
vmapped `house_qr_r` and the Pallas kernel in interpret mode. Row signs
are a convention, so R is compared through R'R and |diag R|. The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py; here a CPU tensor must never launch it.

The IPM: identical dense (P, q, A, b) go through the reference's
make_ipm_solver under jax.vmap and through the port's batched solver.
At f64 both take the exact LU route, so statuses and iteration counts
must be equal and (x, y, s) agree to 1e-8. At f32 the port's condensed
route (Cholesky, the QR of the stacked factor, one refinement pass) is
held to 1e-4, the accuracy the f32 IPM reaches before the polish.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.solver.batched_linalg import house_qr_r as j_house_qr_r
from cvxpylayers_tpu.solver.ipm import make_ipm_solver as j_ipm
from cvxpylayers_tpu.solver.pallas_linalg import qr_r_pallas
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.diff.derivative import make_diff_solver
from cvxpylayers_tpu_torch.solver import cuda_linalg
from cvxpylayers_tpu_torch.solver import ipm as ipm_module
from cvxpylayers_tpu_torch.solver.batched_linalg import (
    MASKED_MAX_DIM,
    house_qr_r_plain,
    use_masked,
)
from cvxpylayers_tpu_torch.solver.ipm import make_ipm_solver as t_ipm
from cvxpylayers_tpu_torch.solver.settings import (
    DUAL_INFEASIBLE,
    PRIMAL_INFEASIBLE,
    SOLVED,
)
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

# ------------------------------------------------------------------ K2


def _gram_err(R, M):
    M = np.asarray(M, np.float64)
    R = np.asarray(R, np.float64)
    G = np.einsum("bmi,bmj->bij", M, M)
    return np.abs(np.einsum("bki,bkj->bij", R, R) - G).max() / np.abs(G).max()


def test_qr_plain_matches_both_reference_householders():
    # the shape and the 2e-4 bound of the reference's own Pallas check
    # (tests/test_batched_linalg.py): f32 Householder on a 21 x 9 matrix
    M = np.random.default_rng(0).standard_normal((128, 21, 9)).astype(
        np.float32)
    before = cuda_linalg.LAUNCHES
    R = cuda_linalg.qr_r(torch.as_tensor(M))
    assert cuda_linalg.LAUNCHES == before  # a CPU tensor never launches K2
    assert R.dtype == torch.float32 and tuple(R.shape) == (128, 9, 9)
    R = R.numpy()
    assert np.array_equal(R, np.triu(R))
    R_loop = np.asarray(jax.jit(jax.vmap(j_house_qr_r))(jnp.asarray(M)))
    R_pallas = np.asarray(qr_r_pallas(jnp.asarray(M), interpret=True))
    assert _gram_err(R, M) < 2e-4
    for ref in (R_loop, R_pallas):
        np.testing.assert_allclose(
            np.einsum("bki,bkj->bij", R, R),
            np.einsum("bki,bkj->bij", ref, ref), atol=2e-4, rtol=0)
        np.testing.assert_allclose(
            np.abs(np.diagonal(R, axis1=1, axis2=2)),
            np.abs(np.diagonal(ref, axis1=1, axis2=2)), atol=2e-4, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6), (np.float64, 1e-14)])
def test_qr_plain_zero_column_and_lapack(dtype, tol):
    # a zero column is the degenerate case: tau = 0, the diagonal keeps
    # x_j = 0, and R'R = M'M still holds; |diag R| matches LAPACK's
    M = np.random.default_rng(1).standard_normal((6, 12, 5)).astype(dtype)
    M[2, :, 3] = 0.0
    M[4, :, 0] = 0.0
    Mt = torch.as_tensor(M)
    R = house_qr_r_plain(Mt)
    assert bool(torch.isfinite(R).all())
    assert _gram_err(R.numpy(), M) < tol
    assert float(R[4, 0, 0]) == 0.0 and float(R[2, 3, 3].abs()) < 10 * tol
    lapack = torch.linalg.qr(Mt, mode="r").R
    np.testing.assert_allclose(
        R.diagonal(dim1=1, dim2=2).abs().numpy(),
        lapack.diagonal(dim1=1, dim2=2).abs().numpy(), atol=10 * tol)


def test_qr_wrapper_checks_inputs_and_gate():
    M = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="m >= n"):
        cuda_linalg.qr_r(M)
    with pytest.raises(ValueError, match=r"\(B, m, n\)"):
        cuda_linalg.qr_r(M[0])
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_linalg.qr_r(torch.zeros(2, 4, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_linalg.qr_r(M.mT)
    assert use_masked(MASKED_MAX_DIM) and not use_masked(MASKED_MAX_DIM + 1)


# ----------------------------------------------------------------- IPM


def _random_qps(B, n, n_zero, n_nonneg, seed, lp=False):
    """Feasible, bounded programs: b = A x0 + s0 with s0 in K."""
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
def _jax_ipm(n, n_zero, n_nonneg, kw):
    """One jitted, vmapped reference solver per structure and settings:
    tracing and compiling the IPM is the cost of this module."""
    jd = JDims(zero=n_zero, nonneg=n_nonneg)
    return jax.jit(jax.vmap(j_ipm(jd, n, JSettings().replace(**dict(kw)))))


def _run_both(data, n_zero, kw, warm=None, dtype=np.float64):
    P, q, A, b = data
    B, n = q.shape
    m = b.shape[1]
    init = warm or (np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m)))
    args = [np.asarray(a, dtype) for a in tuple(data) + tuple(init)]
    jr = _jax_ipm(n, n_zero, m - n_zero, tuple(sorted(kw.items())))(
        *(jnp.asarray(a) for a in args))
    tsolve = t_ipm(TDims(zero=n_zero, nonneg=m - n_zero), n,
                   TSettings().replace(**kw))
    tr = tsolve(*(torch.as_tensor(a) for a in args))
    return jr, tr


def _assert_same(jr, tr, atol=1e-8):
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jr.iters))
    for f in ("x", "y", "s"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)),
                                   atol=atol, rtol=0)


_QP_KW = {"ipm_max_iters": 30}


def test_ipm_qp_with_equality_rows_matches_reference_f64():
    data = _random_qps(4, 5, 2, 7, seed=50)
    jr, tr = _run_both(data, 2, _QP_KW)
    _assert_same(jr, tr)
    assert tr.status.tolist() == [SOLVED] * 4
    assert tr.x.dtype == torch.float64 and int(tr.iters.max()) < 30


def test_ipm_warm_start_matches_reference_f64():
    # same structure and settings as the cold test: one compile serves both
    data = _random_qps(4, 5, 2, 7, seed=50)
    cold, _ = _run_both(data, 2, _QP_KW)
    r = np.random.default_rng(3)
    warm = tuple(np.asarray(a) + 1e-3 * r.standard_normal(np.shape(a))
                 for a in (cold.x, cold.y, cold.s))
    warm[0][0] = 0.0  # lane 0 keeps the least-squares start:
    warm[1][0] = 0.0  # the select is per lane
    warm[2][0] = 0.0
    jr, tr = _run_both(data, 2, _QP_KW, warm=warm)
    _assert_same(jr, tr)
    assert int(tr.iters[0]) == int(cold.iters[0])


_LP_KW = {"ipm_max_iters": 40, "ipm_mode": "pd"}


def test_ipm_lp_primal_dual_matches_reference_f64():
    data = _random_qps(3, 3, 1, 8, seed=51, lp=True)
    jr, tr = _run_both(data, 1, _LP_KW)
    _assert_same(jr, tr)
    assert tr.status.tolist() == [SOLVED] * 3


def test_ipm_infeasible_and_unbounded_statuses_match_reference():
    # the LP test's shapes (B = 3, n = 3, one equality row, 8 nonneg
    # rows), so its compiled reference serves here.
    # lane 0: x1 >= 1 and x1 <= -1 (primal infeasible);
    # lane 1: minimize -x1 with x1 unbounded above (dual infeasible);
    # lane 2: minimize x1 over x1 >= -1 (solved)
    n, m = 3, 9
    P = np.zeros((3, n, n))
    A = np.zeros((3, m, n))
    b = np.ones((3, m))
    q = np.zeros((3, n))
    A[:, 0] = [0.0, 1.0, 1.0]           # x2 + x3 = 1
    A[0, 1], b[0, 1] = [-1.0, 0, 0], -1.0   # x1 >= 1
    A[0, 2], b[0, 2] = [1.0, 0, 0], -1.0    # x1 <= -1
    for lane in (0, 1, 2):
        A[lane, 3:5, 1:] = -np.eye(2)   # x2, x3 >= -1
        A[lane, 5:7, 1:] = np.eye(2)    # x2, x3 <= 1
    A[1, 1] = [-1.0, 0, 0]              # x1 >= -1, nothing above
    q[1, 0] = -1.0
    A[2, 1] = [-1.0, 0, 0]
    q[2, 0] = 1.0
    jr, tr = _run_both((P, q, A, b), 1, _LP_KW)
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jr.iters))
    assert tr.status.tolist() == [PRIMAL_INFEASIBLE, DUAL_INFEASIBLE,
                                  SOLVED]


@pytest.mark.parametrize("n_zero,seed", [(0, 52), (2, 61)])
def test_ipm_f32_condensed_route_matches_reference(n_zero, seed):
    # f32 takes the condensed route: Cholesky of P, the QR R factor of
    # [Lp'; B A_in] (the plain version of K2 on the CPU), the equality
    # Schur complement and one refinement pass. The seeds give instances
    # with well-determined duals: on a lane without strict
    # complementarity both packages' f32 duals sit ~1e-2 off the f64 ones
    # and differ from each other by rounding amplified to ~1e-3.
    data = _random_qps(4, 5, n_zero, 7, seed=seed)
    kw = {"ipm_max_iters": 30, "eps_abs": 1e-4}
    jr, tr = _run_both(data, n_zero, kw, dtype=np.float32)
    assert tr.x.dtype == torch.float32
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jr.iters))
    assert tr.status.tolist() == [SOLVED] * 4
    for f in ("x", "y", "s"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), atol=1e-4,
                                   rtol=0)


def test_ipm_f32_cholesky_route_above_the_gate(monkeypatch):
    # above MASKED_MAX_DIM ipm_kkt "auto" takes the Jacobi-scaled Cholesky
    # of M'M and never asks for the Householder factor; "qr" asks for it
    # once for the initial point and once per iteration. Both solve the
    # projection of v onto x >= 0; the raw IPM iterate sits within
    # sqrt(mu) ~ 1e-2 of it on entries with v_i near 0.
    n = MASKED_MAX_DIM + 4
    r = np.random.default_rng(7)
    v = r.standard_normal((2, n)).astype(np.float32)
    P = np.broadcast_to(np.eye(n, dtype=np.float32), (2, n, n)).copy()
    A = np.broadcast_to(-np.eye(n, dtype=np.float32), (2, n, n)).copy()
    data = (P, -v, A, np.zeros((2, n), np.float32))
    zeros = (np.zeros((2, n), np.float32),) * 3
    calls = []
    monkeypatch.setattr(
        ipm_module, "qr_r",
        lambda M: (calls.append(tuple(M.shape)), cuda_linalg.qr_r(M))[1])
    out = {}
    for kkt in ("auto", "qr"):
        del calls[:]
        st = TSettings().replace(eps_abs=1e-6, ipm_kkt=kkt, ipm_max_iters=25)
        solve = t_ipm(TDims(nonneg=n), n, st)
        out[kkt] = solve(*(torch.as_tensor(a) for a in data + zeros))
        assert out[kkt].status.tolist() == [SOLVED, SOLVED]
        want = 0 if kkt == "auto" else int(out[kkt].iters.max()) + 1
        assert calls == [(2, 2 * n, n)] * want
        np.testing.assert_allclose(out[kkt].x.numpy(), np.maximum(v, 0.0),
                                   atol=1e-2)
    np.testing.assert_allclose(out["auto"].x.numpy(), out["qr"].x.numpy(),
                               atol=1e-4)


def test_ipm_unported_routes_raise():
    st = TSettings().replace(solve_method="ipm")
    # the self-dual embedding is ported: "auto" on a problem without a
    # quadratic objective and "hsde" build, as in the reference
    t_ipm(TDims(nonneg=3), 2, st, hsde=True)
    make_diff_solver(TDims(nonneg=3), 2, st, p_zero=True)
    make_diff_solver(TDims(nonneg=3), 2, st.replace(ipm_mode="hsde"),
                     p_zero=True)
    make_diff_solver(TDims(nonneg=3), 2, st.replace(ipm_mode="pd"),
                     p_zero=True)
    make_diff_solver(TDims(nonneg=3), 2, st, p_zero=False)
    with pytest.raises(ValueError, match="requires a problem with no quad"):
        make_diff_solver(TDims(nonneg=3), 2, st.replace(ipm_mode="hsde"),
                         p_zero=False)
    with pytest.raises(NotImplementedError, match="zero and nonneg"):
        t_ipm(TDims(nonneg=3, soc=(3,)), 2, st)
    with pytest.raises(NotImplementedError, match="'admm'"):
        make_diff_solver(TDims(nonneg=3), 2,
                         st.replace(solve_method="pdhg"), p_zero=True)
    with pytest.raises(NotImplementedError, match="derivative='adjoint'"):
        make_diff_solver(TDims(nonneg=3), 2,
                         st.replace(derivative="forward"))


@pytest.mark.parametrize("lp", [False, True], ids=["qp", "lp"])
def test_ipm_solution_satisfies_optimality_conditions(lp):
    n_zero = 1
    P, q, A, b = (torch.as_tensor(a)
                  for a in _random_qps(3, 3, n_zero, 8, seed=53, lp=lp))
    kw = dict(_LP_KW if lp else _QP_KW, eps_abs=1e-9, eps_rel=1e-9)
    solve = t_ipm(TDims(zero=n_zero, nonneg=8), 3, TSettings().replace(**kw))
    r = solve(P, q, A, b, *(torch.zeros_like(t) for t in (q, b, b)))
    assert r.status.tolist() == [SOLVED] * 3
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)  # noqa: E731
    assert float((mv(A, r.x) + r.s - b).abs().max()) < 1e-7
    assert float((mv(P, r.x) + q + mv(A.mT, r.y)).abs().max()) < 1e-7
    assert float(r.s[:, :n_zero].abs().max()) < 1e-7
    assert float(r.s[:, n_zero:].min()) >= 0
    assert float(r.y[:, n_zero:].min()) >= 0
    assert float((r.s * r.y).sum(-1).abs().max()) < 1e-7


def test_ipm_lanes_do_not_depend_on_their_batch():
    # lanes stop at different iterations and are frozen from then on: each
    # lane alone gives what it gives inside the batch, bit for bit in
    # status and count
    data = _random_qps(4, 5, 2, 7, seed=54)
    solve = t_ipm(TDims(zero=2, nonneg=7), 5, TSettings().replace(**_QP_KW))
    args = [torch.as_tensor(a) for a in data]
    zeros = [torch.zeros(4, 5), torch.zeros(4, 9), torch.zeros(4, 9)]
    zeros = [z.double() for z in zeros]
    whole = solve(*args, *zeros)
    assert len(set(whole.iters.tolist())) > 1  # the lanes do differ
    for i in range(4):
        one = solve(*(t[i:i + 1] for t in args + zeros))
        assert int(one.status) == int(whole.status[i])
        assert int(one.iters) == int(whole.iters[i])
        for f in ("x", "y", "s"):
            np.testing.assert_allclose(getattr(one, f)[0].numpy(),
                                       getattr(whole, f)[i].numpy(),
                                       atol=1e-10, rtol=0)
