"""Layers through the port's interior-point method on every cone family,
against the reference.

bench.py's Markowitz risk-budget SOCP (n=10, k=3) by `solve_method="ipm"`
(the self-dual embedding: P = 0 and only symmetric cones) with the
spectral polish, and through solve_with_rescue with that IPM as its
stage; the entropy softmax (exp cones, the primal-dual form, which "auto"
takes for nonsymmetric cones) with its equality dual; and a 4x4
spectahedron SDP (a PSD block, the embedding). At f64 statuses and
iteration counts are equal lane for lane, and outputs and gradients agree
within 1e-6 (the polished Markowitz and SDP within 1e-14; the softmax's
raw IPM iterate within ~3e-8).

The rescue's fast route fails on purpose (one epoch, no polish) and its
capacity is the batch, so its stage re-solves every lane in order, cold:
the stage's result is the direct IPM call's, which the reference's same
call gives (the rescue's own mechanics, gather and combine, are held
against the reference's solve_with_rescue in test_torch_port_rescue.py).
The softmax goes without the polish: its raw IPM iterate is the output
(the reference compiles the exp polish with gradients for about 20 s
more). The rest runs the port alone: the form "auto" picks, the f32 route
through K2's plain version, the SDP's closed-form solution, the power
cone's projection, the IPM against the ADMM route, the warm start,
infeasibility certificates on cone blocks, the structural block apply,
the eigh calls an iteration, and lanes independent of their batch.

Reference configurations compiled: the Markowitz IPM with gradients, the
softmax IPM with gradients, the SDP IPM with gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.cones.projections import project_pow3
from cvxpylayers_tpu_torch.solver import ipm as tipm
from cvxpylayers_tpu_torch.solver.settings import (
    DUAL_INFEASIBLE,
    PRIMAL_INFEASIBLE,
    SOLVED,
)
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_B = 4
_ATOL = 1e-6
_GRAD_ATOL = 1e-6
# bench.py's markowitz_socp rescue stage, at an IPM target for f64
_MK_IPM = {"solve_method": "ipm", "kkt_mode": "spectral",
           "refine_steps": 15, "ipm_eps": 1e-9}
# the softmax through the IPM, its raw iterate as the output
_SM_IPM = {"solve_method": "ipm", "refine_steps": 0, "eps_abs": 1e-6,
           "eps_rel": 1e-6, "ipm_eps": 1e-10}
_IPM = {"solve_method": "ipm"}


def markowitz(mod, n=10, k=3, **kw):
    w = mod.Variable(n, nonneg=True)
    mu = mod.Parameter(n)
    F = mod.Parameter((k, n))
    prob = mod.Problem(mod.Maximize(mu @ w),
                       [mod.norm(F @ w, 2) <= 0.25, mod.sum(w) == 1])
    return mod.CvxpyLayer(prob, parameters=[mu, F], variables=[w], **kw)


def _markowitz_values(seed=40, n=10, k=3, B=_B):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, n)) * 0.1,
            r.standard_normal((B, k, n)) / np.sqrt(n)]


def softmax(mod, n=6, **kw):
    y = mod.Variable(n, nonneg=True)
    c = mod.Parameter(n)
    con = mod.sum(y) == 1
    prob = mod.Problem(mod.Maximize(c @ y + mod.sum(mod.entr(y))), [con])
    return mod.CvxpyLayer(prob, parameters=[c],
                          variables=[y, con.dual_variables[0]], **kw)


def _softmax_values(seed=41, n=6):
    return [np.random.default_rng(seed).standard_normal((_B, n))]


def sdp(mod, s=4, **kw):
    X = mod.Variable((s, s), PSD=True)
    C = mod.Parameter((s, s))
    prob = mod.Problem(mod.Minimize(mod.trace(C @ X)), [mod.trace(X) == 1])
    return mod.CvxpyLayer(prob, parameters=[C], variables=[X], **kw)


def _sdp_values(seed=42, s=4):
    C = np.random.default_rng(seed).standard_normal((_B, s, s))
    return [0.5 * (C + C.transpose(0, 2, 1))]


def pow3(mod, alpha=0.4, **kw):
    x = mod.Variable(3)
    v = mod.Parameter(3)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [mod.PowCone3D(x[0], x[1], x[2], alpha)])
    return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)


def _t(vals, grad=False, dtype=torch.float64):
    return [torch.as_tensor(a, dtype=dtype).requires_grad_(grad)
            for a in vals]


def _weights(shapes, seed=25):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s) for s in shapes]


def _loss(outs, weights):
    return sum((o * torch.as_tensor(w)).sum() for o, w in zip(outs, weights))


def _reference(build, vals, args, weights):
    """ONE jitted reference: gradients of sum(w_i * out_i) with the
    forward (outputs, statuses, counts) as aux."""
    lj = build(cj)

    def loss(*ps):
        outs, status, iters = lj.solve_with_info(*ps, solver_args=args)
        total = sum(jnp.sum(o * w) for o, w in zip(outs, weights))
        return total, (outs, status, iters)

    fn = jax.jit(jax.grad(loss, argnums=tuple(range(len(vals))),
                          has_aux=True))
    grads, (outs, status, iters) = fn(*(jnp.asarray(a) for a in vals))
    return ([np.asarray(g) for g in grads], [np.asarray(o) for o in outs],
            np.asarray(status), np.asarray(iters))


def _assert_matches(ref, outs, status, iters, params, extra_iters=0):
    grads_j, outs_j, st_j, it_j = ref
    np.testing.assert_array_equal(status.numpy(), st_j)
    np.testing.assert_array_equal(iters.numpy(), it_j + extra_iters)
    assert (status.numpy() == SOLVED).all()
    for o, oj in zip(outs, outs_j):
        np.testing.assert_allclose(o.detach().numpy(), oj, atol=_ATOL,
                                   rtol=0)
    for p, gj in zip(params, grads_j):
        np.testing.assert_allclose(p.grad.numpy(), gj, atol=_GRAD_ATOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def markowitz_ref():
    vals = _markowitz_values()
    weights = _weights([(_B, 10)])
    return vals, weights, _reference(markowitz, vals, _MK_IPM, weights)


def test_markowitz_ipm_matches_reference(markowitz_ref):
    vals, weights, ref = markowitz_ref
    lt = markowitz(ct, device="cpu")
    assert lt.prog.dims.soc == (4,) and lt.prog.P_rows.size == 0
    tin = _t(vals, grad=True)
    outs, status, iters = lt.solve_with_info(*tin, solver_args=_MK_IPM)
    _loss(outs, weights).backward()
    _assert_matches(ref, outs, status, iters, tin)


def test_markowitz_rescue_ipm_stage_matches_reference(markowitz_ref):
    # a fast route of one epoch without polish fails every lane; the
    # stage (capacity = the batch) re-solves all of them in order, cold
    vals, weights, ref = markowitz_ref
    lt = markowitz(ct, device="cpu")
    fast = {"max_iters": 25, "epoch": 25, "refine_steps": 0}
    _, st_fast, it_fast = lt.solve_with_info(*_t(vals), solver_args=fast)
    assert (st_fast.numpy() != SOLVED).all()
    tin = _t(vals, grad=True)
    outs, status, iters = ct.solve_with_rescue(
        lt, *tin, solver_args=fast, rescue_args=_MK_IPM, capacity=_B)
    _loss(outs, weights).backward()
    _assert_matches(ref, outs, status, iters, tin,
                    extra_iters=it_fast.numpy())


def test_softmax_ipm_primal_dual_form_matches_reference():
    vals = _softmax_values()
    weights = _weights([(_B, 6), (_B,)])
    ref = _reference(softmax, vals, _SM_IPM, weights)
    lt = softmax(ct, device="cpu")
    assert lt.prog.dims.exp == 6
    tin = _t(vals, grad=True)
    outs, status, iters = lt.solve_with_info(*tin, solver_args=_SM_IPM)
    _loss(outs, weights).backward()
    _assert_matches(ref, outs, status, iters, tin)
    # the softmax of c, and its equality dual
    y = outs[0].detach().numpy()
    e = np.exp(vals[0] - vals[0].max(1, keepdims=True))
    np.testing.assert_allclose(y, e / e.sum(1, keepdims=True), atol=1e-6)


def test_sdp_ipm_matches_reference():
    vals = _sdp_values()
    weights = _weights([(_B, 4, 4)])
    ref = _reference(sdp, vals, _IPM, weights)
    lt = sdp(ct, device="cpu")
    assert lt.prog.dims.psd == (4,)
    tin = _t(vals, grad=True)
    outs, status, iters = lt.solve_with_info(*tin, solver_args=_IPM)
    _loss(outs, weights).backward()
    _assert_matches(ref, outs, status, iters, tin)


# ------------------------------------------------------ the port alone


def test_auto_form_is_the_embedding_only_for_symmetric_cones(monkeypatch):
    forms = []
    make = tipm.make_ipm_solver
    monkeypatch.setattr(tipm, "make_ipm_solver", lambda *a, hsde=False: (
        forms.append(hsde), make(*a, hsde=hsde))[1])
    x = ct.Variable(2)
    v = ct.Parameter(2)
    # an SOC program with a quadratic objective: the primal-dual form
    qp_soc = ct.CvxpyLayer(
        ct.Problem(ct.Minimize(ct.sum_squares(x - v)),
                   [ct.norm(x, 2) <= 1]),
        parameters=[v], variables=[x], device="cpu")
    cases = ((markowitz(ct, device="cpu"), _markowitz_values(), True),
             (sdp(ct, device="cpu"), _sdp_values(), True),
             (softmax(ct, device="cpu"), _softmax_values(), False),
             (pow3(ct, device="cpu"), [np.ones((_B, 3))], False),
             (qp_soc, [np.ones((_B, 2))], False))
    for layer, vals, hsde in cases:
        del forms[:]
        layer.solve_with_info(*_t(vals), solver_args=_IPM)
        assert forms == [hsde]


def test_markowitz_f32_condenses_through_k2_once_per_iteration(monkeypatch):
    # f32: the stacked factor [Lp'; B A_in] of n + 62 rows (51 nonneg, an
    # SOC of 11) goes through K2's plain version on a CPU tensor, once an
    # iteration (the embedding starts from its canonical point)
    shapes = []
    qr_r = tipm.qr_r
    monkeypatch.setattr(tipm, "qr_r", lambda M: (
        shapes.append(tuple(M.shape)), qr_r(M))[1])
    vals = _markowitz_values(seed=43, n=50, k=10)
    lt = markowitz(ct, n=50, k=10, device="cpu")
    args = dict(_MK_IPM, ipm_eps=1e-5, eps_abs=1e-4, eps_rel=1e-4)
    (w,), status, iters = lt.solve_with_info(
        *_t(vals, dtype=torch.float32), solver_args=args)
    assert w.dtype == torch.float32
    assert shapes == [(_B, 113, 51)] * int(iters.max())
    del shapes[:]
    (w64,), st64, _ = lt.solve_with_info(*_t(vals), solver_args=args)
    both = (status == SOLVED) & (st64 == SOLVED)
    assert int(both.sum()) >= 3
    np.testing.assert_allclose(w.double()[both].numpy(),
                               w64[both].numpy(), atol=1e-4)


def test_sdp_ipm_solution_is_the_least_eigenvector_projector():
    vals = _sdp_values(seed=44, s=5)
    (X,), status, _ = sdp(ct, s=5, device="cpu").solve_with_info(
        *_t(vals), solver_args=_IPM)
    assert (status.numpy() == SOLVED).all()
    lam, U = np.linalg.eigh(vals[0])
    want = np.einsum("bi,bj->bij", U[:, :, 0], U[:, :, 0])
    np.testing.assert_allclose(X.numpy(), want, atol=1e-6)


def test_power_cone_layer_by_ipm_is_the_projection():
    v = np.random.default_rng(45).standard_normal((_B, 3))
    (x,), status, _ = pow3(ct, device="cpu").solve_with_info(
        *_t([v]), solver_args=_IPM)
    assert (status.numpy() == SOLVED).all()
    want = project_pow3(torch.as_tensor(v), 0.4)
    np.testing.assert_allclose(x.numpy(), want.numpy(), atol=1e-7)


@pytest.mark.parametrize("program", ["markowitz", "sdp", "softmax"])
def test_ipm_and_admm_layers_agree(program):
    build, vals, args = {
        "markowitz": (markowitz, _markowitz_values(seed=46), _MK_IPM),
        "sdp": (sdp, _sdp_values(seed=47), _IPM),
        "softmax": (softmax, _softmax_values(seed=48), _IPM),
    }[program]
    lt = build(ct, device="cpu")
    got = {}
    for method, a in (("ipm", args), ("admm", {"eps_abs": 1e-10,
                                               "eps_rel": 1e-10})):
        tin = _t(vals, grad=True)
        outs, status, _ = lt.solve_with_info(*tin, solver_args=a)
        assert (status.numpy() == SOLVED).all(), method
        _loss(outs, _weights([tuple(o.shape) for o in outs])).backward()
        got[method] = ([o.detach() for o in outs], [p.grad for p in tin])
    for u, w in zip(*(got[m][0] for m in ("ipm", "admm"))):
        np.testing.assert_allclose(u.numpy(), w.numpy(), atol=1e-6)
    for u, w in zip(*(got[m][1] for m in ("ipm", "admm"))):
        np.testing.assert_allclose(u.numpy(), w.numpy(), atol=1e-5)


def test_warm_start_cache_on_an_interior_point_cone_layer():
    lt = markowitz(ct, device="cpu")
    vals = _t(_markowitz_values(seed=49))
    (w0,), _, it0 = lt.solve_with_info(*vals, solver_args=_MK_IPM,
                                       warm_start=True)
    assert lt._warm is not None
    (w1,), st1, it1 = lt.solve_with_info(*vals, solver_args=_MK_IPM,
                                         warm_start=True)
    assert (st1.numpy() == SOLVED).all()
    assert int(it1.sum()) < int(it0.sum())
    np.testing.assert_allclose(w1.numpy(), w0.numpy(), atol=1e-7)


def test_infeasible_cone_programs_are_certified():
    # ||x|| <= t with t <= -1 has no point; min -t under ||x|| <= t is
    # unbounded. Both forms of the IPM certify the SOC program, the
    # primal-dual form through its projection onto the cone blocks
    x = ct.Variable(3)
    t = ct.Variable()
    c = ct.Parameter(3)
    infeasible = ct.CvxpyLayer(
        ct.Problem(ct.Minimize(c @ x), [ct.norm(x, 2) <= t, t <= -1]),
        parameters=[c], variables=[x], device="cpu")
    unbounded = ct.CvxpyLayer(
        ct.Problem(ct.Minimize(c @ x - t), [ct.norm(x, 2) <= t]),
        parameters=[c], variables=[x], device="cpu")
    cvals = _t([np.random.default_rng(50).standard_normal((_B, 3))])
    for mode in ("pd", "hsde"):
        args = dict(_IPM, ipm_mode=mode)
        _, st, _ = infeasible.solve_with_info(*cvals, solver_args=args)
        assert (st.numpy() == PRIMAL_INFEASIBLE).all(), mode
        _, st, _ = unbounded.solve_with_info(*cvals, solver_args=args)
        assert (st.numpy() == DUAL_INFEASIBLE).all(), mode


def test_structural_block_apply_above_the_gate():
    # mi >= 512 inequality rows in at most 8 blocks: the scaling is applied
    # block by block (the nonneg diagonal and the SOC tile), never as a
    # dense (mi, mi) matrix; f32 agrees with f64
    r = np.random.default_rng(51)
    n, nn, d = 3, 509, 3
    dims = TDims(nonneg=nn, soc=(d,))
    assert tipm._block_layout(dims)[1] == 512
    A = np.concatenate([r.standard_normal((2, nn, n)) / np.sqrt(n),
                        np.concatenate([np.zeros((2, 1, n)),
                                        -np.broadcast_to(np.eye(n)[:d - 1],
                                                         (2, d - 1, n))],
                                       1)], 1)
    b = np.concatenate([np.abs(r.standard_normal((2, nn))) + 0.5,
                        np.full((2, 1), 1.0), np.zeros((2, d - 1))], 1)
    P = np.broadcast_to(np.eye(n), (2, n, n)).copy()
    q = r.standard_normal((2, n))
    zero = (np.zeros((2, n)), np.zeros((2, nn + d)), np.zeros((2, nn + d)))
    dense_used = []
    bmv = tipm.bmv
    out = {}
    for dtype in (np.float64, np.float32):
        st = TSettings().replace(eps_abs=1e-5, eps_rel=1e-5)
        solve = tipm.make_ipm_solver(dims, n, st)
        args = [torch.as_tensor(np.asarray(a, dtype))
                for a in (P, q, A, b) + zero]
        tipm.bmv = lambda M, v: (dense_used.append(
            tuple(M.shape)) if M.shape[-1] == nn + d else None, bmv(M, v))[1]
        try:
            out[dtype] = solve(*args)
        finally:
            tipm.bmv = bmv
        assert (out[dtype].status.numpy() == SOLVED).all()
    assert not dense_used
    np.testing.assert_allclose(out[np.float32].x.double().numpy(),
                               out[np.float64].x.numpy(), atol=1e-3)


def test_eigh_calls_an_iteration_on_a_psd_block(monkeypatch):
    # each is a host read on the card: build_T three (Z, its congruence,
    # W), the predictor's and corrector's step lengths two each (S and
    # the congruence, s and z stacked), the step acceptance one (four
    # candidates, s and z stacked), and in the primal-dual form the
    # certificate's projection one; besides, the primal-dual form's
    # initial and warm-start shifts four, and the polish's status check
    # one (its residual's projection)
    calls = []
    for name in ("eigh", "eigvalsh"):
        fn = getattr(torch.linalg, name)
        monkeypatch.setattr(torch.linalg, name, (lambda f: lambda *a, **k: (
            calls.append(1), f(*a, **k))[1])(fn))
    vals = _sdp_values(seed=52)
    lt = sdp(ct, device="cpu")
    for hsde, per_it in ((True, 8), (False, 9)):
        del calls[:]
        (_,), status, iters = lt.solve_with_info(
            *_t(vals), solver_args=dict(
                _IPM, refine_steps=0, ipm_mode="hsde" if hsde else "pd"))
        setup = 1 if hsde else 5
        assert len(calls) == per_it * int(iters.max()) + setup, hsde


def test_cone_lanes_do_not_depend_on_their_batch():
    dims = dict(zero=1, nonneg=2, exp=2, psd=(2,), pow3=(0.5,))
    r = np.random.default_rng(53)
    td = TDims(**dims)
    m, n, B = td.total, 4, 3
    A = r.standard_normal((B, m, n)) / 2.0
    L = r.standard_normal((B, n, n)) * 0.3
    P = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(n)
    s0 = tipm.make_ipm_solver(td, n, TSettings())  # build once
    interior = np.concatenate([
        np.zeros((B, 1)), np.ones((B, 2)),
        np.tile([-1.051383, 0.556409, 1.258967], (B, 2)) + 0.5,
        np.tile([1.0, 0.0, 1.0], (B, 1)), np.tile([1.0, 1.0, 0.0], (B, 1))],
        1)
    b = np.einsum("bmn,bn->bm", A, r.standard_normal((B, n))) + interior
    q = r.standard_normal((B, n))
    args = [torch.as_tensor(a) for a in (P, q, A, b, np.zeros((B, n)),
                                          np.zeros((B, m)), np.zeros((B, m)))]
    whole = s0(*args)
    assert (whole.status.numpy() == SOLVED).all()
    for i in range(B):
        one = s0(*(t[i:i + 1] for t in args))
        assert int(one.iters) == int(whole.iters[i])
        for f in ("x", "y", "s"):
            np.testing.assert_allclose(getattr(one, f)[0].numpy(),
                                       getattr(whole, f)[i].numpy(),
                                       atol=1e-10, rtol=0)
