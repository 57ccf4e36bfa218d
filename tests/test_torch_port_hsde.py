"""The port's homogeneous self-dual embedding (HSDE) against the reference.

`solve_method="ipm"` on a program with no quadratic objective takes the
embedding in both packages under the default `ipm_mode="auto"`. The same
dense (P = 0, q, A, b) go through the reference's make_ipm_solver(...,
hsde=True) under jax.vmap and the port's batched solver: at f64 both
factor the KKT matrix by LU, so statuses and iteration counts must be
equal and (x, y, s) agree to 1e-8, infeasible programs included. Through
the layer, the LAD fit's outputs and gradients are held to the reference
at 1e-6. In f32 the embedding factors through the plain version of K2 on
the CPU, once per iteration.

Each JAX reference is compiled once per module (one per structure, and
one jitted gradient of the LAD layer that also gives its forward).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.diff.derivative import make_diff_solver as j_diff
from cvxpylayers_tpu.solver.ipm import make_ipm_solver as j_ipm
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.diff.derivative import make_diff_solver
from cvxpylayers_tpu_torch.solver import cuda_linalg
from cvxpylayers_tpu_torch.solver import ipm as ipm_module
from cvxpylayers_tpu_torch.solver.ipm import make_ipm_solver as t_ipm
from cvxpylayers_tpu_torch.solver.settings import (
    DUAL_INFEASIBLE,
    PRIMAL_INFEASIBLE,
    SOLVED,
)
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

_ATOL = 1e-8
_GRAD_ATOL = 1e-6
_KW = (("ipm_max_iters", 40),)
_IPM = {"solve_method": "ipm"}


def lad(mod, n=2, m=3, **kw):
    x = mod.Variable(n)
    A = mod.Parameter((m, n))
    b = mod.Parameter(m)
    nonneg = x >= 0
    prob = mod.Problem(mod.Minimize(0.5 * mod.pnorm(A @ x - b, p=1)),
                       [nonneg])
    return mod.CvxpyLayer(prob, parameters=[A, b],
                          variables=[x, nonneg.dual_variables[0]], **kw)


def lad_values(B=4, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, 3, 2)), r.standard_normal((B, 3))]


def lad_data(B=4, seed=0):
    """The LAD layer's stuffed (P, q, A, b): an LP with nonneg rows."""
    layer = lad(ct, device="cpu")
    vals = [torch.as_tensor(a) for a in lad_values(B, seed)]
    p_ext = layer._stack_params(vals, B, [True, True])
    P, q, A, b, _ = layer._assemble(p_ext)
    return (tuple(t.numpy() for t in (P, q, A, b)), layer.prog.dims.zero,
            layer.prog.dims.nonneg)


def random_lp(B, n, n_zero, n_nonneg, seed):
    """A feasible LP kept bounded by the box rows x <= 1, -x <= 1 after
    the equality rows: b = A x0 + s0 with s0 in K."""
    r = np.random.default_rng(seed)
    m = n_zero + n_nonneg
    A = r.standard_normal((B, m, n))
    A[:, n_zero:n_zero + 2 * n] = np.concatenate([np.eye(n), -np.eye(n)])
    x0 = r.standard_normal((B, n)) * 0.5
    s0 = np.concatenate([np.zeros((B, n_zero)),
                         np.abs(r.standard_normal((B, n_nonneg)))], axis=1)
    b = np.einsum("bmn,bn->bm", A, x0) + s0
    b[:, n_zero:n_zero + 2 * n] = 1.0
    return np.zeros((B, n, n)), r.standard_normal((B, n)), A, b


def _cases():
    return {
        "lad": lad_data(),
        "box_lp": (random_lp(4, 4, 0, 10, seed=5), 0, 10),
        # the shapes of the infeasible and warm-start tests below
        "eq_lp": (random_lp(3, 3, 1, 8, seed=51), 1, 8),
    }


@functools.lru_cache(maxsize=None)
def _jax_hsde(n, n_zero, n_nonneg, kw=_KW):
    jd = JDims(zero=n_zero, nonneg=n_nonneg)
    return jax.jit(jax.vmap(j_ipm(jd, n, JSettings().replace(**dict(kw)),
                                  hsde=True)))


def _run_both(data, n_zero, n_nonneg, warm=None, kw=_KW):
    B, n = data[1].shape
    m = n_zero + n_nonneg
    init = warm or (np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m)))
    args = tuple(data) + tuple(init)
    jr = _jax_hsde(n, n_zero, n_nonneg, kw)(*(jnp.asarray(a) for a in args))
    tr = t_ipm(TDims(zero=n_zero, nonneg=n_nonneg), n,
               TSettings().replace(**dict(kw)), hsde=True)(
        *(torch.as_tensor(a) for a in args))
    return jr, tr


def _assert_same(jr, tr, atol=_ATOL):
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jr.iters))
    for f in ("x", "y", "s", "pobj"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("case", ["lad", "box_lp", "eq_lp"])
def test_hsde_matches_reference_f64(case):
    data, n_zero, n_nonneg = _cases()[case]
    jr, tr = _run_both(data, n_zero, n_nonneg)
    _assert_same(jr, tr)
    assert tr.status.tolist() == [SOLVED] * data[1].shape[0]
    assert tr.x.dtype == torch.float64 and int(tr.iters.max()) < 40


def _infeasible_lps():
    """The equality-row LP's shapes (B = 3, n = 3, one equality row, 8
    nonneg rows). Lane 0: x1 >= 1 and x1 <= -1 (primal infeasible);
    lane 1: minimize -x1 with x1 unbounded above (dual infeasible);
    lane 2: minimize x1 over x1 >= -1 (solved)."""
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
    return P, q, A, b


def test_hsde_infeasible_and_unbounded_match_reference():
    jr, tr = _run_both(_infeasible_lps(), 1, 8)
    _assert_same(jr, tr)
    assert tr.status.tolist() == [PRIMAL_INFEASIBLE, DUAL_INFEASIBLE,
                                  SOLVED]


def test_hsde_certificates_are_the_last_iterate():
    # on an infeasibility verdict the returned iterate is the certificate
    # itself, unscaled: A'y ~ 0 with b'y < 0, or A x + s ~ 0 with q'x < 0
    P, q, A, b = (torch.as_tensor(a) for a in _infeasible_lps())
    solve = t_ipm(TDims(zero=1, nonneg=8), 3,
                  TSettings().replace(**dict(_KW)), hsde=True)
    r = solve(P, q, A, b, *(torch.zeros_like(t) for t in (q, b, b)))
    y, x, s = r.y[0], r.x[1], r.s[1]
    assert float(b[0] @ y) < 0
    assert float((A[0].T @ y).abs().max()) <= 1e-6 * float(-(b[0] @ y)) * 3
    assert float(q[1] @ x) < 0
    assert float((A[1] @ x + s).abs().max()) <= 1e-6 * float(-(q[1] @ x)) * 3


def test_hsde_warm_start_matches_reference():
    data, n_zero, n_nonneg = _cases()["eq_lp"]
    cold, _ = _run_both(data, n_zero, n_nonneg)
    r = np.random.default_rng(3)
    warm = tuple(np.asarray(a) + 1e-3 * r.standard_normal(np.shape(a))
                 for a in (cold.x, cold.y, cold.s))
    for w in warm:
        w[0] = 0.0  # lane 0 keeps the canonical start: the select is per lane
    jr, tr = _run_both(data, n_zero, n_nonneg, warm=warm)
    _assert_same(jr, tr)
    assert int(tr.iters[0]) == int(cold.iters[0])


@pytest.fixture(scope="module")
def jax_lad():
    """One reference LAD layer and ONE jitted gradient of a weighted sum
    of its outputs, with the forward (outputs, statuses, counts) as
    aux, under the default ipm_mode."""
    lj = lad(cj)
    r = np.random.default_rng(98)
    w = [r.standard_normal((4, 2)), r.standard_normal((4, 2))]

    def loss(A, b):
        outs, status, iters = lj.solve_with_info(A, b, solver_args=_IPM)
        return (sum(jnp.sum(o * wi) for o, wi in zip(outs, w)),
                (outs, status, iters))

    return jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True)), w


def _port_lad(vals, args=_IPM, grad=False):
    lt = lad(ct, device="cpu")
    tin = [torch.as_tensor(a).requires_grad_(grad) for a in vals]
    return lt, tin, lt.solve_with_info(*tin, solver_args=args)


def test_auto_on_an_lp_takes_hsde_through_the_layer(jax_lad):
    vals = lad_values()
    _, (oj, sj, ij) = jax_lad[0](*(jnp.asarray(a) for a in vals))
    lt, _, (ot, st, it) = _port_lad(vals)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    for a, b in zip(oj, ot):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=_ATOL,
                                   rtol=0)
    assert (st == SOLVED).all()
    # "auto" is the embedding: the same counts as asking for it by name,
    # and other counts than the primal-dual form
    _, _, (oh, sh, ih) = _port_lad(vals, dict(_IPM, ipm_mode="hsde"))
    assert torch.equal(ih, it) and torch.equal(oh[0], ot[0])
    _, _, (op, sp, ip) = _port_lad(vals, dict(_IPM, ipm_mode="pd"))
    assert not torch.equal(ip, it)
    # both forms polish to the same solution
    np.testing.assert_allclose(op[0].numpy(), ot[0].numpy(), atol=1e-6)


def test_layer_gradients_through_hsde_match_reference(jax_lad):
    vals = lad_values()
    fn, w = jax_lad
    gj, (oj, sj, _) = fn(*(jnp.asarray(a) for a in vals))
    lt, tin, (ot, st, _) = _port_lad(vals, grad=True)
    sum((o * torch.as_tensor(wi)).sum() for o, wi in zip(ot, w)).backward()
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for g, t in zip(gj, tin):
        assert t.grad is not None and tuple(t.grad.shape) == tuple(g.shape)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=_GRAD_ATOL, rtol=0)
    assert float(tin[0].grad.abs().max()) > 1e-3  # not trivially zero


def test_hsde_on_a_qp_raises_value_error():
    msgs = []
    for make, dims, st in ((j_diff, JDims(nonneg=3), JSettings()),
                           (make_diff_solver, TDims(nonneg=3), TSettings())):
        st = st.replace(solve_method="ipm", ipm_mode="hsde")
        with pytest.raises(ValueError) as err:
            make(dims, 2, st, p_zero=False)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "no quadratic objective" in msgs[1]
    # through the layer: a projection has a quadratic objective
    x = ct.Variable(3)
    v = ct.Parameter(3)
    layer = ct.CvxpyLayer(
        ct.Problem(ct.Minimize(ct.sum_squares(x - v)), [x >= 0]),
        parameters=[v], variables=[x], device="cpu")
    with pytest.raises(ValueError, match="no quadratic objective"):
        layer(torch.ones(3, dtype=torch.float64),
              solver_args=dict(_IPM, ipm_mode="hsde"))


def test_hsde_f32_factors_through_k2_plain_version_once_per_iteration(
        monkeypatch):
    data, n_zero, n_nonneg = _cases()["box_lp"]
    B, n = data[1].shape
    m = n_zero + n_nonneg
    kw = dict(_KW, eps_abs=1e-4)
    shapes = []
    monkeypatch.setattr(
        ipm_module, "qr_r",
        lambda M: (shapes.append(tuple(M.shape)), cuda_linalg.qr_r(M))[1])
    zeros = (np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m)))
    out = {}
    before = cuda_linalg.LAUNCHES
    for dtype in (torch.float32, torch.float64):
        del shapes[:]
        solve = t_ipm(TDims(zero=n_zero, nonneg=n_nonneg), n,
                      TSettings().replace(**kw), hsde=True)
        out[dtype] = solve(*(torch.as_tensor(a, dtype=dtype)
                             for a in tuple(data) + zeros))
    assert cuda_linalg.LAUNCHES == before  # CPU tensors: the plain version
    assert shapes == []  # f64 factors by LU
    r32, r64 = out[torch.float32], out[torch.float64]
    assert r32.x.dtype == torch.float32
    assert r32.status.tolist() == [SOLVED] * B
    # f32 again, counting: one factor (n + m_ineq, n) per loop iteration
    solve = t_ipm(TDims(zero=n_zero, nonneg=n_nonneg), n,
                  TSettings().replace(**kw), hsde=True)
    solve(*(torch.as_tensor(a, dtype=torch.float32)
            for a in tuple(data) + zeros))
    assert shapes == [(B, n + n_nonneg, n)] * int(r32.iters.max())
    for f in ("x", "y", "s"):
        np.testing.assert_allclose(getattr(r32, f).numpy(),
                                   getattr(r64, f).numpy(), atol=2e-3)


def test_hsde_factors_once_and_solves_three_times_per_iteration(
        monkeypatch):
    data, n_zero, n_nonneg = _cases()["box_lp"]
    B, n = data[1].shape
    m = n_zero + n_nonneg
    counts = {"factor": 0, "solve": 0}
    real_f, real_s = torch.linalg.lu_factor_ex, torch.linalg.lu_solve

    def factor(*a, **k):
        counts["factor"] += 1
        return real_f(*a, **k)

    def solve_(*a, **k):
        counts["solve"] += 1
        return real_s(*a, **k)

    monkeypatch.setattr(torch.linalg, "lu_factor_ex", factor)
    monkeypatch.setattr(torch.linalg, "lu_solve", solve_)
    solve = t_ipm(TDims(zero=n_zero, nonneg=n_nonneg), n,
                  TSettings().replace(**dict(_KW)), hsde=True)
    r = solve(*(torch.as_tensor(a) for a in tuple(data) + (
        np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m)))))
    loops = int(r.iters.max())
    assert counts == {"factor": loops, "solve": 3 * loops}


def test_hsde_lanes_do_not_depend_on_their_batch():
    data, n_zero, n_nonneg = _cases()["eq_lp"]
    B, n = data[1].shape
    m = n_zero + n_nonneg
    solve = t_ipm(TDims(zero=n_zero, nonneg=n_nonneg), n,
                  TSettings().replace(**dict(_KW)), hsde=True)
    args = [torch.as_tensor(a) for a in tuple(data) + (
        np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m)))]
    mixed = [torch.cat([a, b]) for a, b in zip(
        args, [torch.as_tensor(t) for t in _infeasible_lps()] + [
            torch.zeros(3, n, dtype=torch.float64),
            torch.zeros(3, m, dtype=torch.float64),
            torch.zeros(3, m, dtype=torch.float64)])]
    whole = solve(*mixed)
    assert len(set(whole.iters.tolist())) > 1  # the lanes do differ
    for i in range(2 * B):
        one = solve(*(t[i:i + 1] for t in mixed))
        assert int(one.status) == int(whole.status[i])
        assert int(one.iters) == int(whole.iters[i])
        for f in ("x", "y", "s"):
            np.testing.assert_allclose(getattr(one, f)[0].numpy(),
                                       getattr(whole, f)[i].numpy(),
                                       atol=1e-10, rtol=0)


def test_hsde_solution_satisfies_optimality_conditions():
    data, n_zero, n_nonneg = _cases()["eq_lp"]
    P, q, A, b = (torch.as_tensor(a) for a in data)
    kw = dict(_KW, eps_abs=1e-10)
    solve = t_ipm(TDims(zero=n_zero, nonneg=n_nonneg), 3,
                  TSettings().replace(**kw), hsde=True)
    r = solve(P, q, A, b, *(torch.zeros_like(t) for t in (q, b, b)))
    assert r.status.tolist() == [SOLVED] * 3
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)  # noqa: E731
    assert float((mv(A, r.x) + r.s - b).abs().max()) < 1e-8
    assert float((q + mv(A.mT, r.y)).abs().max()) < 1e-8
    assert float(r.s[:, :n_zero].abs().max()) < 1e-8
    assert float(r.s[:, n_zero:].min()) >= 0
    assert float(r.y[:, n_zero:].min()) >= 0
    assert float((r.s * r.y).sum(-1).abs().max()) < 1e-8
    np.testing.assert_allclose(r.pobj.numpy(), (q * r.x).sum(-1).numpy())
