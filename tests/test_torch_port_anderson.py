"""The port's Anderson-accelerated ADMM against the reference's.

With `accel_lookback` L > 0 both packages run type-II Anderson
acceleration of the ADMM step on the pre-projection state v = [x; w],
with an epoch-local history of L differences, a restart when the residual
grows, a Tikhonov-regularized Gram solve through the masked SPD inverse,
and the plain step where the mixing weights are wild. The same dense
(P, q, A, b) go through the reference's make_admm_solver under
jax.jit(jax.vmap(...)) and the port's batched solver at f64: statuses must
be equal on every lane, and per-lane iteration counts equal and (x, y, s)
within 1e-8 on every lane whose result the reference itself pins down.
The mixing weights solve a Gram system regularized only to a condition of
about 1e8, so on a few lanes the reference's own outputs move by up to
~4e-7, and its count by an epoch, when q changes by 1e-15 relative
(`_shadow_moves` finds those lanes with two such runs); there the port is
held to the status, one epoch and 1e-6.

One batch carries three problem classes in one structure (n = 5, one
equality row, 11 nonneg rows), so that one reference compile per L covers
them all: LAD fits and box-QPs padded with inert rows and variables (a
zero equality row, 0 <= 1 rows, a variable with cost x^2 and no
constraint), and LPs with an equality row. Through the layer, the LAD
fit's outputs and gradients are held to the reference at 1e-8 and 1e-6.
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
from cvxpylayers_tpu.solver import batched_linalg as j_linalg
from cvxpylayers_tpu.solver.admm import make_admm_solver as j_admm
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.solver import admm as admm_module
from cvxpylayers_tpu_torch.solver import batched_linalg as t_linalg
from cvxpylayers_tpu_torch.solver import cuda_admm
from cvxpylayers_tpu_torch.solver.admm import make_admm_solver as t_admm
from cvxpylayers_tpu_torch.solver.settings import SOLVED
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-8
_GRAD_ATOL = 1e-6
_N, _ZERO, _NONNEG = 5, 1, 11
_KW = (("admm_eps_abs", 1e-7), ("admm_eps_rel", 1e-7), ("epoch", 25),
       ("max_iters", 1000))
_LAD_ARGS = {"eps_abs": 1e-7, "eps_rel": 1e-7, "admm_eps_abs": 1e-6,
             "admm_eps_rel": 1e-6, "max_iters": 2000, "epoch": 50,
             "accel_lookback": 3}


def lad(mod, **kw):
    x = mod.Variable(2, nonneg=True)
    A = mod.Parameter((3, 2))
    b = mod.Parameter(3)
    prob = mod.Problem(mod.Minimize(0.5 * mod.pnorm(A @ x - b, 1)))
    return mod.CvxpyLayer(prob, parameters=[A, b], variables=[x], **kw)


def box_qp(mod, **kw):
    x = mod.Variable(4)
    v = mod.Parameter(4)
    G = mod.Parameter((3, 4))
    h = mod.Parameter(3)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [G @ x <= h, x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v, G, h], variables=[x], **kw)


def lad_values(B, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, 3, 2)), r.standard_normal((B, 3))]


def _stuffed(layer, vals):
    """The layer's dense (P, q, A, b) and its cone sizes."""
    ps = [torch.as_tensor(a) for a in vals]
    p_ext = layer._stack_params(ps, ps[0].shape[0], [True] * len(ps))
    P, q, A, b, _ = layer._assemble(p_ext)
    d = layer.prog.dims
    return [t.numpy() for t in (P, q, A, b)], d.zero, d.nonneg


def _pad(data, n_zero, n_nonneg, p_new=2.0):
    """Pad a program into the common structure: variables with cost
    p_new x^2 / 2 and no constraint, zero equality rows in front, and
    0 <= 1 rows at the end. Each pad is inert: its variable stays at 0,
    its rows' duals at 0."""
    P, q, A, b = data
    B, n = q.shape
    dn, dz, dk = _N - n, _ZERO - n_zero, _NONNEG - n_nonneg
    P2 = np.zeros((B, _N, _N))
    P2[:, :n, :n] = P
    P2[:, range(n, _N), range(n, _N)] = p_new
    q2 = np.concatenate([q, np.zeros((B, dn))], axis=1)
    A2 = np.zeros((B, _ZERO + _NONNEG, _N))
    A2[:, dz:dz + n_zero + n_nonneg, :n] = A
    b2 = np.concatenate([np.zeros((B, dz)), b, np.ones((B, dk))], axis=1)
    return P2, q2, A2, b2


def _eq_lp(B, seed):
    """A feasible LP with one equality row, kept bounded by the box rows
    x <= 1, -x <= 1: b = A x0 + s0 with s0 in K."""
    r = np.random.default_rng(seed)
    n, m = _N, _ZERO + _NONNEG
    A = r.standard_normal((B, m, n))
    A[:, _ZERO:_ZERO + 2 * n] = np.concatenate([np.eye(n), -np.eye(n)])
    x0 = r.standard_normal((B, n)) * 0.5
    s0 = np.concatenate([np.zeros((B, _ZERO)),
                         np.abs(r.standard_normal((B, _NONNEG)))], axis=1)
    b = np.einsum("bmn,bn->bm", A, x0) + s0
    b[:, _ZERO:_ZERO + 2 * n] = 1.0
    return np.zeros((B, n, n)), r.standard_normal((B, n)), A, b


@functools.lru_cache(maxsize=None)
def batch():
    """Four LAD fits, four box-QPs and four LPs with an equality row."""
    lad_data, lz, ln = _stuffed(lad(ct, device="cpu"), lad_values(4, 3))
    r = np.random.default_rng(4)
    qp_vals = [r.standard_normal((4, 4)), r.standard_normal((4, 3, 4)) * 0.3,
               np.abs(r.standard_normal((4, 3))) + 1.0]
    qp_data, qz, qn = _stuffed(box_qp(ct, device="cpu"), qp_vals)
    parts = [_pad(lad_data, lz, ln, p_new=0.0), _pad(qp_data, qz, qn),
             _eq_lp(4, 5)]
    return tuple(np.concatenate(arrs, axis=0) for arrs in zip(*parts))


@functools.lru_cache(maxsize=None)
def _jax_admm(lookback):
    js = JSettings().replace(accel_lookback=lookback, **dict(_KW))
    return jax.jit(jax.vmap(j_admm(JDims(zero=_ZERO, nonneg=_NONNEG), _N,
                                   js)))


def _warm_zero(B):
    m = _ZERO + _NONNEG
    return np.zeros((B, _N)), np.zeros((B, m)), np.zeros((B, m))


def _shadow_moves(fn, args, perturbed, outs):
    """Lanes the reference cannot pin down: where its own outputs move by
    more than 1e-10, or its iteration count changes, when the argument at
    `perturbed` is scaled by 1 + 1e-15 noise (two draws). `outs(res)`
    gives (outputs, iters) of a reference result."""
    base_out, base_it = outs(fn(*args))
    moved = np.zeros(base_it.shape, bool)
    for seed in (1, 2):
        a = list(args)
        noise = np.random.default_rng(seed).standard_normal(a[perturbed].shape)
        a[perturbed] = a[perturbed] * (1 + 1e-15 * noise)
        out, it = outs(fn(*(jnp.asarray(t) for t in a)))
        for u, v in zip(out, base_out):
            dev = np.abs(np.asarray(u) - np.asarray(v))
            moved |= dev.reshape(dev.shape[0], -1).max(1) > 1e-10
        moved |= np.asarray(it) != np.asarray(base_it)
    return moved


def _run_both(lookback, warm=None, **kw):
    data = batch()
    args = tuple(data) + (warm or _warm_zero(data[1].shape[0]))
    fn = _jax_admm(lookback)
    jr = fn(*(jnp.asarray(a) for a in args))
    ts = TSettings().replace(accel_lookback=lookback, **dict(_KW), **kw)
    tr = t_admm(TDims(zero=_ZERO, nonneg=_NONNEG), _N, ts)(
        *(torch.as_tensor(a) for a in args))
    sensitive = _shadow_moves(fn, args, 1,
                              lambda r: ((r.x, r.y, r.s), r.iters))
    return jr, tr, sensitive


def _assert_same(jr, tr, sensitive):
    """Equal statuses on every lane; equal counts and (x, y, s) within
    1e-8 where the reference pins its own result down to 1e-10. On the
    few lanes it does not (Anderson mixing amplifies rounding there: the
    reference's own outputs move by up to ~4e-7 under a 1e-15 change of
    q), counts within one epoch and (x, y, s) within 1e-6."""
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    it_t, it_j = tr.iters.numpy(), np.asarray(jr.iters)
    np.testing.assert_array_equal(it_t[~sensitive], it_j[~sensitive])
    assert np.all(np.abs(it_t - it_j) <= dict(_KW)["epoch"])
    assert sensitive.sum() <= 2
    for f in ("x", "y", "s"):
        got, want = getattr(tr, f).numpy(), np.asarray(getattr(jr, f))
        np.testing.assert_allclose(got[~sensitive], want[~sensitive],
                                   atol=_ATOL, rtol=0)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("lookback", [1, 3, 5])
def test_anderson_admm_matches_reference(lookback):
    jr, tr, sensitive = _run_both(lookback)
    _assert_same(jr, tr, sensitive)
    assert tr.status.tolist() == [SOLVED] * 12
    # the accelerated run is not the plain one
    plain = t_admm(TDims(zero=_ZERO, nonneg=_NONNEG), _N,
                   TSettings().replace(**dict(_KW)))(
        *(torch.as_tensor(a) for a in batch() + _warm_zero(12)))
    assert not torch.equal(plain.iters, tr.iters)


def test_anderson_cuts_iterations_as_the_reference_does():
    # the reference's contract: the same solutions in fewer iterations;
    # here per class, with the reference's counts beside the port's
    jr, tr, _ = _run_both(3)
    plain = t_admm(TDims(zero=_ZERO, nonneg=_NONNEG), _N,
                   TSettings().replace(**dict(_KW)))(
        *(torch.as_tensor(a) for a in batch() + _warm_zero(12)))
    assert tr.iters.sum() < 0.75 * plain.iters.sum()
    assert np.asarray(jr.iters).sum() < 0.75 * plain.iters.sum()
    np.testing.assert_allclose(tr.x.numpy(), plain.x.numpy(), atol=1e-5)


def test_anderson_from_a_warm_start_matches_reference():
    r = np.random.default_rng(8)
    B, m = 12, _ZERO + _NONNEG
    warm = (0.3 * r.standard_normal((B, _N)),
            np.abs(r.standard_normal((B, m))),
            np.abs(r.standard_normal((B, m))))
    jr, tr, sensitive = _run_both(3, warm=warm)
    _assert_same(jr, tr, sensitive)


@pytest.mark.parametrize("size", [1, 3, 5])
def test_masked_spd_inverse_matches_reference(size):
    r = np.random.default_rng(size)
    Y = r.standard_normal((6, size, 7))
    gram = Y @ Y.transpose(0, 2, 1)
    gram[1] = 0.0  # an empty history: every pivot clamps to 1e-30
    reg = 1e-8 * np.trace(gram, axis1=1, axis2=2) / size + 1e-30
    regd = gram + reg[:, None, None] * np.eye(size)
    # the reference's factor, inverse and triangular inverse of both
    # matrices, and of the port's factors, from one compile
    jall = jax.jit(jax.vmap(lambda M, L: (j_linalg.chol_masked(M),
                                          j_linalg.spd_inv_via_chol(M),
                                          j_linalg.tri_inv_masked(L))))
    Ms = np.stack([gram, regd])
    Ls = t_linalg.chol_masked(torch.as_tensor(Ms.reshape(-1, size, size)))
    jchol, jinv, jtri = (np.asarray(a).reshape(Ms.shape) for a in jall(
        Ms.reshape(-1, size, size), Ls.numpy()))
    for i, M in enumerate((gram, regd)):
        Mt = torch.as_tensor(M)
        Lt = t_linalg.chol_masked(Mt)
        np.testing.assert_allclose(Lt.numpy(), jchol[i], rtol=1e-12, atol=0)
        np.testing.assert_allclose(t_linalg.tri_inv_masked(Lt).numpy(),
                                   jtri[i], rtol=1e-12, atol=0)
        inv = t_linalg.spd_inv_via_chol(Mt)
        assert bool(torch.isfinite(inv).all())
        np.testing.assert_allclose(inv.numpy(), jinv[i], rtol=1e-10, atol=0)
    # the clamped pivot: an all-zero Gram gives a zero factor and the
    # inverse 1e60 I, where a library Cholesky reports a failure
    assert bool((t_linalg.chol_masked(torch.as_tensor(gram))[1] == 0).all())
    assert int(torch.linalg.cholesky_ex(torch.as_tensor(gram))[1][1]) != 0
    # away from the clamp it is the inverse
    np.testing.assert_allclose(
        t_linalg.spd_inv_via_chol(torch.as_tensor(regd))[0].numpy(),
        np.linalg.inv(regd[0]), rtol=1e-8)


def test_restart_and_wild_guard_fire_lane_by_lane(monkeypatch):
    # spy on the mixing step: a lane restarted where its residual grew,
    # and took the plain step without a restart where its weights were
    # wild; those lanes still match the reference
    grew, plain = [], []

    def spy(S, Yb, v, vT, v_prev, g_prev, gn_prev, k):
        out = mix(S, Yb, v, vT, v_prev, g_prev, gn_prev, k)
        g = vT - v
        grew.append(((g * g).sum(-1) > gn_prev).numpy())
        plain.append((out[0] == vT).all(-1).numpy())
        return out

    mix = admm_module.anderson_mix
    monkeypatch.setattr(admm_module, "anderson_mix", spy)
    jr, tr, sensitive = _run_both(5)
    grew, plain = np.array(grew), np.array(plain)
    wild = plain & ~grew
    wild[::25] = False  # an epoch's first step has no history yet
    restarted = np.flatnonzero(grew.any(axis=0))
    wild_lanes = np.flatnonzero(wild.any(axis=0))
    assert restarted.size and wild_lanes.size
    for lanes in (restarted, wild_lanes):
        lanes = lanes[~sensitive[lanes]]
        assert lanes.size
        np.testing.assert_array_equal(tr.status.numpy()[lanes],
                                      np.asarray(jr.status)[lanes])
        np.testing.assert_array_equal(tr.iters.numpy()[lanes],
                                      np.asarray(jr.iters)[lanes])
        np.testing.assert_allclose(tr.x.numpy()[lanes],
                                   np.asarray(jr.x)[lanes], atol=_ATOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def jax_lad():
    """The reference LAD layer's gradients of sum(x^2) and (x, status,
    iters) with acceleration, from one jitted function, and the lanes
    whose count the reference does not pin down (_shadow_moves)."""
    lj = lad(cj)

    def loss(A, b):
        (x,), status, iters = lj.solve_with_info(A, b,
                                                 solver_args=_LAD_ARGS)
        return jnp.sum(x ** 2), (x, status, iters)

    fn = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))
    vals = lad_values(8, 9)
    res = jax.tree_util.tree_map(np.asarray, fn(
        *(jnp.asarray(a) for a in vals)))
    moved = _shadow_moves(fn, vals, 1,
                          lambda r: ((r[1][0],) + tuple(r[0]), r[1][2]))
    return res, moved


def _port_lad(args, grad=True, dtype=torch.float64):
    lt = lad(ct, device="cpu")
    ps = [torch.as_tensor(a, dtype=dtype).requires_grad_(grad)
          for a in lad_values(8, 9)]
    (x,), status, iters = lt.solve_with_info(*ps, solver_args=args)
    if grad:
        (x ** 2).sum().backward()
    return x, status, iters, [p.grad for p in ps]


def test_layer_outputs_and_gradients_match_reference(jax_lad):
    # the polish takes every lane to the solution, so outputs and
    # gradients hold on every lane; the ADMM count only where the
    # reference pins its own down
    (grads, (xj, sj, ij)), sensitive = jax_lad
    x, status, iters, g = _port_lad(_LAD_ARGS)
    np.testing.assert_array_equal(status.numpy(), sj)
    np.testing.assert_array_equal(iters.numpy()[~sensitive], ij[~sensitive])
    assert sensitive.sum() <= 2
    np.testing.assert_allclose(x.detach().numpy(), xj, atol=_ATOL, rtol=0)
    for a, b in zip(g, grads):
        np.testing.assert_allclose(a.numpy(), b, atol=_GRAD_ATOL, rtol=0)


def test_acceleration_lookback_alias_gives_identical_output():
    args = dict(_LAD_ARGS)
    del args["accel_lookback"]
    a = _port_lad(dict(args, accel_lookback=3))
    b = _port_lad(dict(args, acceleration_lookback=3))
    plain = _port_lad(args, grad=False)
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)
    for u, v in zip(a[3], b[3]):
        assert torch.equal(u, v)
    assert not torch.equal(a[2], plain[2])  # the knob reached the epoch


def test_accelerated_call_never_reaches_k1(monkeypatch):
    calls = []
    monkeypatch.setattr(admm_module, "polyhedral_inner_epoch",
                        lambda *a, **kw: (calls.append(1),
                                          cuda_admm.polyhedral_inner_epoch(
                                              *a, **kw))[1])
    before = cuda_admm.LAUNCHES
    _port_lad(_LAD_ARGS, grad=False)
    assert calls == [] and cuda_admm.LAUNCHES == before
    args = dict(_LAD_ARGS, accel_lookback=0)
    _port_lad(args, grad=False)
    assert calls and cuda_admm.LAUNCHES == before  # CPU: the plain version


def test_accelerated_call_on_constant_pa_takes_the_dense_route():
    x_t, x_j = ct.Variable(6), cj.Variable(6)
    layers = []
    for mod, x in ((ct, x_t), (cj, x_j)):
        v = mod.Parameter(6)
        prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                           [mod.sum(x) == 1, x >= 0])
        kw = {"device": "cpu"} if mod is ct else {}
        layers.append(mod.CvxpyLayer(prob, parameters=[v], variables=[x],
                                     **kw))
    lt, lj = layers
    st = TSettings().replace(accel_lookback=3)
    assert lt._pa_constant and not lt._use_shared(st)
    assert lt._use_shared(TSettings())
    msgs = []
    for layer, settings in ((lt, st.replace(shared_setup="on")),
                            (lj, JSettings().replace(accel_lookback=3,
                                                     shared_setup="on"))):
        with pytest.raises(ValueError) as err:
            layer._use_shared(settings)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    # the default call with acceleration solves on the dense route
    v = torch.as_tensor(np.random.default_rng(0).standard_normal((4, 6)))
    (x,), status, _ = lt.solve_with_info(
        v, solver_args={"accel_lookback": 3})
    assert status.tolist() == [SOLVED] * 4
    np.testing.assert_allclose(x.sum(-1).numpy(), 1.0, atol=1e-6)


def test_relaxation_is_rounded_once_as_the_reference_compiles_it():
    # the reference's compiler fuses alpha * new + (1 - alpha) * old into
    # a multiply-add; in f32 the port forms it in f64 and rounds once
    alpha = TSettings().alpha
    new, old = np.random.default_rng(3).standard_normal(
        (2, 100000)).astype(np.float32)
    want = jax.jit(lambda a, b: alpha * a + (1 - alpha) * b)(new, old)
    got = admm_module.relax(alpha, torch.as_tensor(new), torch.as_tensor(old))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # at a fixed point (new == old) the fused form returns x itself, where
    # two roundings miss it on about a third of the entries
    x = torch.as_tensor(new)
    assert torch.equal(admm_module.relax(alpha, x, x), x)
    assert float(((alpha * x + (1 - alpha) * x) != x).float().mean()) > 0.3


def test_f32_nonfinite_lanes_match_the_reference_count():
    # In f32 the Gram system's regularization, 1e-8 of its trace, is below
    # the format's resolution: a lane whose history holds only rounding
    # noise gets a mixing inverse that overflows, and ends non-finite and
    # unsolved, in both packages. How often depends on the rounding of the
    # relaxation step (admm.relax): formed with two roundings, as plain
    # torch ops do, the port left 21 of these 1024 LAD lanes non-finite
    # and 31 unsolved, where the reference leaves 10 and 19; fused as the
    # reference's compiler fuses it, 9 and 18. Which lanes fail is
    # chaotic, so the port's counts may exceed the reference's by half of
    # them (at least 5)
    data, n_zero, n_nonneg = _stuffed(lad(ct, device="cpu"),
                                      lad_values(1024, 10))
    data = [a.astype(np.float32) for a in data]
    B, n = data[1].shape
    m = data[3].shape[1]
    warm = [np.zeros((B, k), np.float32) for k in (n, m, m)]
    kw = dict(admm_eps_abs=1e-4, admm_eps_rel=1e-4, max_iters=600,
              epoch=100, accel_lookback=3)
    jr = jax.jit(jax.vmap(j_admm(JDims(zero=n_zero, nonneg=n_nonneg), n,
                                 JSettings().replace(**kw))))(
        *(jnp.asarray(a) for a in data + warm))
    tr = t_admm(TDims(zero=n_zero, nonneg=n_nonneg), n,
                TSettings().replace(**kw))(
        *(torch.as_tensor(a) for a in data + warm))
    assert tr.x.dtype == torch.float32
    bad_t = ~torch.isfinite(tr.x).all(-1).numpy()
    bad_j = ~np.isfinite(np.asarray(jr.x)).all(-1)
    assert bad_j.sum() > 0
    assert (tr.status.numpy()[bad_t] != SOLVED).all()
    for got, want in ((bad_t.sum(), bad_j.sum()),
                      ((tr.status.numpy() != SOLVED).sum(),
                       (np.asarray(jr.status) != SOLVED).sum())):
        assert got <= want + max(5, want // 2), (got, want)


def test_f32_accelerated_call(jax_lad):
    (_, (xj, sj, _)), _ = jax_lad
    x, status, iters, g = _port_lad(_LAD_ARGS, dtype=torch.float32)
    assert x.dtype == torch.float32 and g[0].dtype == torch.float32
    solved = (status.numpy() == SOLVED) & (sj == SOLVED)
    assert solved.sum() >= 6
    np.testing.assert_allclose(x.detach().numpy()[solved], xj[solved],
                               atol=1e-4, rtol=0)
    assert all(bool(torch.isfinite(t).all()) for t in g)
