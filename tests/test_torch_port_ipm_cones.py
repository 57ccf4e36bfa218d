"""The port's interior-point cone blocks against the reference.

cones/barriers.py (the exp and power barriers, their gradients and
Hessians) and the per-block pieces of solver/ipm.py (the NT scalings of
SOC and PSD blocks, their step lengths, the interior tests of the
nonsymmetric cones and their grid step, the block layout, the symmetric
Kronecker product) are held against the reference's module-level
functions under `jax.jit(jax.vmap(f))` on the same numpy-seeded inputs.

make_ipm_solver then runs one structure per family (zero + nonneg + SOC,
PSD, exp, pow3) in the primal-dual form, and one structure with SOC and
PSD blocks in the self-dual embedding, at f64 through the exact LU:
statuses and iteration counts equal on every lane, (x, y, s) within 1e-8
(SOC) and 1e-7 (PSD, exp, pow3, and the embedding's mixed structure).
Where the reference does not pin a lane down that far, the port is held
to what the reference itself gives there (`_spread`): near an active SOC
or PSD boundary the last steps amplify rounding by ~1e9, so when q
changes by 1e-15 relative the reference's own iterate moves by up to
1e-4 and its count by one on such a lane (measured: one embedding lane
takes 11 iterations on the seeded q and 10 on each of six perturbed
ones; the port takes 10). There the port's status and count must be one
the reference takes on the seeded or a perturbed q, and its iterate
within four times the distance the reference's moves. At f32 the SOC
structure goes through the condensed route (the plain version of K2 on
the stacked factor [Lp'; B A_in] with its dense SOC rows, once per
iteration): on the lanes both packages solve, within 1e-4 of the
solution's scale, or of twice the distance the reference's own f32
iterate moves when q changes by 1e-6 relative (f32 lanes near their
precision floor move by 1e-3 in the reference). The f32 statuses are not
compared lane by lane: rounding decides them there (over 192 random SOC
programs at eps 1e-4 the reference solves 134 and the port 149).

Reference configurations compiled: the four primal-dual structures in
one jitted function, the embedding structure, and the f32 structure.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvxpylayers_tpu.cones import barriers as jb
from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.cones.projections import svec_to_sym as j_smat
from cvxpylayers_tpu.cones.projections import sym_to_svec as j_svec
from cvxpylayers_tpu.solver import ipm as jipm
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones import barriers as tb
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.solver import ipm as tipm
from cvxpylayers_tpu_torch.solver.settings import SOLVED
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_B = 4
_N = 5


def _jv(f, *args, **static):
    """The reference's per-block function f over a leading batch axis."""
    return jax.jit(jax.vmap(functools.partial(f, **static)))(
        *(jnp.asarray(a) for a in args))


# -------------------------------------------------------------- inputs


def _svec(M):
    s = M.shape[-1]
    return np.stack([M[..., i, j] * (1.0 if i == j else np.sqrt(2.0))
                     for j in range(s) for i in range(j, s)], axis=-1)


def _exp_points(r, k, dual=False):
    """Strictly interior points of the exp cone (or of its dual)."""
    a = np.exp(r.uniform(-0.5, 0.5, k))
    v = r.standard_normal(k)
    grow = 1.0 + np.abs(r.standard_normal(k))
    if dual:  # u < 0, -u e^{v/u} < e w
        u = -a
        return np.stack([u, v, -u * np.exp(v / u) / np.e * grow + 0.1], 1)
    return np.stack([v, a, a * np.exp(v / a) * grow + 0.1], 1)


def _pow_points(r, k, alpha, dual=False):
    x = np.exp(r.uniform(-0.5, 0.5, k))
    y = np.exp(r.uniform(-0.5, 0.5, k))
    bx, by = (x / alpha, y / (1 - alpha)) if dual else (x, y)
    z = bx ** alpha * by ** (1 - alpha) * r.uniform(-0.9, 0.9, k)
    return np.stack([x, y, z], 1)


def _soc_points(r, k, d):
    x = r.standard_normal((k, d - 1))
    t = np.linalg.norm(x, axis=1, keepdims=True) + np.abs(
        r.standard_normal((k, 1))) + 0.1
    return np.concatenate([t, x], 1)


def _spd(r, k, s):
    L = r.standard_normal((k, s, s))
    return L @ L.transpose(0, 2, 1) / s + 0.1 * np.eye(s)


def _interior(r, B, dims, dual):
    """A strictly interior point of K (or K*) per lane; the zero rows are
    0 in K and free in K*."""
    parts = [r.standard_normal((B, dims["zero"])) if dual
             else np.zeros((B, dims["zero"]))]
    parts.append(np.abs(r.standard_normal((B, dims.get("nonneg", 0)))) + 0.1)
    parts += [_soc_points(r, B, d) for d in dims.get("soc", ())]
    parts += [_exp_points(r, B, dual) for _ in range(dims.get("exp", 0))]
    parts += [_svec(_spd(r, B, s)) for s in dims.get("psd", ())]
    parts += [_pow_points(r, B, a, dual) for a in dims.get("pow3", ())]
    return np.concatenate(parts, 1)


def _program(dims, n, seed, lp):
    """Feasible, bounded programs: b = A x0 + s0 with s0 inside K; a QP
    with P > 0, or an LP whose cost q = -A'y0 with y0 inside K* makes the
    dual feasible too."""
    r = np.random.default_rng(seed)
    m = TDims(**dims).total
    A = r.standard_normal((_B, m, n)) / np.sqrt(n)
    x0 = r.standard_normal((_B, n)) * 0.5
    b = np.einsum("bmn,bn->bm", A, x0) + _interior(r, _B, dims, False)
    if lp:
        P = np.zeros((_B, n, n))
        q = -np.einsum("bmn,bm->bn", A, _interior(r, _B, dims, True))
    else:
        L = r.standard_normal((_B, n, n)) * 0.3
        P = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(n)
        q = r.standard_normal((_B, n))
    m = b.shape[1]
    return (P, q, A, b, np.zeros((_B, n)), np.zeros((_B, m)),
            np.zeros((_B, m)))


# -------------------------------------------------------------- barriers


def _block_rel_err(got, want):
    """max |got - want| over each block's own scale (max |want| there)."""
    got = np.asarray(got).reshape(len(got), -1)
    want = np.asarray(want).reshape(len(want), -1)
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-300)
    return float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("family", ["exp", "pow"])
def test_barrier_values_gradients_and_hessians_match_reference(family):
    r = np.random.default_rng(60)
    if family == "exp":
        S = _exp_points(r, 64)
        cases = [(tb.exp_barrier, jb.exp_barrier), (tb.exp_grad, jb.exp_grad),
                 (tb.exp_hess, jb.exp_hess)]
        extra = ()
    else:
        alpha = r.uniform(0.1, 0.9, 64)
        S = _pow_points(r, 64, alpha)
        cases = [(tb.pow_barrier, jb.pow_barrier), (tb.pow_grad, jb.pow_grad),
                 (tb.pow_hess, jb.pow_hess)]
        extra = (alpha,)
    for port, ref in cases:
        got = port(torch.as_tensor(S), *(torch.as_tensor(a) for a in extra))
        want = _jv(ref, S, *extra)
        assert got.shape == want.shape
        assert _block_rel_err(got.numpy(), want) < 1e-12, port.__name__


def test_barriers_are_logarithmically_homogeneous():
    # H(s) s = -g(s) and s'g(s) = -3 (nu = 3), the identities the IPM uses
    r = np.random.default_rng(61)
    S = torch.as_tensor(_exp_points(r, 32))
    alpha = torch.as_tensor(r.uniform(0.1, 0.9, 32))
    P = torch.as_tensor(_pow_points(r, 32, alpha.numpy()))
    for s, g, H in ((S, tb.exp_grad(S), tb.exp_hess(S)),
                    (P, tb.pow_grad(P, alpha), tb.pow_hess(P, alpha))):
        Hs = torch.einsum("kij,kj->ki", H, s)
        np.testing.assert_allclose(Hs.numpy(), -g.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(g.abs().max()))
        np.testing.assert_allclose((s * g).sum(-1).numpy(), -3.0, rtol=1e-12)
        assert bool((torch.linalg.eigvalsh(H) > 0).all())
    for pt, want in ((tb.EXP_PRIMAL_INTERIOR, jb.EXP_PRIMAL_INTERIOR),
                     (tb.EXP_DUAL_INTERIOR, jb.EXP_DUAL_INTERIOR),
                     (tb.POW_INTERIOR, jb.POW_INTERIOR)):
        assert tuple(pt) == tuple(want)


# ------------------------------------------------------- block helpers


def test_soc_nt_scaling_matches_reference():
    r = np.random.default_rng(62)
    s, z = _soc_points(r, 32, 5), _soc_points(r, 32, 5)
    W, Wi = tipm._soc_nt_w_wi(torch.as_tensor(s), torch.as_tensor(z))
    Wj, Wij = _jv(jipm._soc_nt_w_wi, s, z)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Wi.numpy(), np.asarray(Wij), rtol=0,
                               atol=1e-12)
    # the NT property: W z = W^{-1} s, and W W^{-1} = I
    np.testing.assert_allclose(tipm._mv(W, torch.as_tensor(z)).numpy(),
                               tipm._mv(Wi, torch.as_tensor(s)).numpy(),
                               atol=1e-12)
    np.testing.assert_allclose((W @ Wi).numpy(),
                               np.broadcast_to(np.eye(5), (32, 5, 5)),
                               atol=1e-12)


def test_psd_nt_scaling_matches_reference():
    r = np.random.default_rng(63)
    S, Z = _spd(r, 16, 4), _spd(r, 16, 4)
    sv, zv = _svec(S), _svec(Z)
    W = tipm._psd_nt_w(torch.as_tensor(sv), torch.as_tensor(zv), 4)
    Wj = _jv(jipm._psd_nt_w, sv, zv, side=4)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), atol=1e-11,
                               rtol=0)
    # W Z W = S
    np.testing.assert_allclose((W @ torch.as_tensor(Z) @ W).numpy(), S,
                               atol=1e-10)


def test_symmetric_kronecker_product_is_the_basis_map():
    # the reference builds T = W (x)_s W column by column as
    # svec(W smat(e_q) W) over the svec basis; the port gathers it
    r = np.random.default_rng(64)
    W = _spd(r, 8, 4)
    D = 10
    want = jax.vmap(lambda w: jax.vmap(
        lambda e: j_svec(w @ j_smat(e, 4) @ w))(jnp.eye(D)).T)(
        jnp.asarray(W))
    got = tipm._skron(torch.as_tensor(W), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                               rtol=0)
    # (W (x)_s W) svec(X) = svec(W X W)
    X = _spd(r, 8, 4)
    got_x = torch.einsum("kpq,kq->kp", got, torch.as_tensor(_svec(X)))
    np.testing.assert_allclose(got_x.numpy(), _svec(W @ X @ W), atol=1e-12)


def test_step_lengths_match_reference():
    r = np.random.default_rng(65)
    s = _soc_points(r, 64, 4)
    ds = 2.0 * r.standard_normal((64, 4))
    ds[:16, 0] = np.abs(ds[:16, 0]) + 5.0  # inside for every alpha
    got = tipm._soc_step_len(torch.as_tensor(s), torch.as_tensor(ds))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jv(jipm._soc_step_len, s, ds)), atol=1e-13, rtol=0)
    assert (got.numpy()[:16] == 1.0).all() and (got.numpy() < 1.0).any()
    sv = _svec(_spd(r, 32, 3))
    dsv = 2.0 * r.standard_normal((32, 6))
    got = tipm._psd_step_len(torch.as_tensor(sv), torch.as_tensor(dsv), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jv(jipm._psd_step_len, sv, dsv, side=3)), atol=1e-12, rtol=0)
    assert (got.numpy() < 1.0).any() and (got.numpy() == 1.0).any()
    # the endpoint is on the boundary: the least eigenvalue there is ~0
    end = torch.as_tensor(sv + got.numpy()[:, None] * dsv)
    lmin = torch.linalg.eigvalsh(tipm.svec_to_sym(end, 3)).amin(-1)
    assert float(lmin[got < 1].abs().max()) < 1e-10


def test_interior_tests_and_grid_step_match_reference():
    r = np.random.default_rng(66)
    alpha = 0.35
    V = 1.5 * r.standard_normal((512, 3))  # in and out of every cone
    tests = ((tipm._exp_interior, jipm._exp_interior, {}),
             (tipm._exp_dual_interior, jipm._exp_dual_interior, {}),
             (tipm._pow_interior, jipm._pow_interior, {"alpha": alpha}),
             (tipm._pow_dual_interior, jipm._pow_dual_interior,
              {"alpha": alpha}))
    for port, ref, kw in tests:
        got = port(torch.as_tensor(V), **kw).numpy()
        want = np.asarray(_jv(ref, V, **kw))
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(got)
    # the grid step from interior points along random directions
    P = _exp_points(r, 64)
    dP = 3.0 * r.standard_normal((64, 3))
    got = tipm._grid_max_step(tipm._exp_interior, torch.as_tensor(P),
                              torch.as_tensor(dP))
    want = jax.jit(jax.vmap(lambda v, dv: jipm._grid_max_step(
        lambda a: jipm._exp_interior(v + a * dv), jnp.float64)))(
        jnp.asarray(P), jnp.asarray(dP))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < 1.0).any() and (got.numpy() == 1.0).any()
    assert set(got.numpy().tolist()) <= set(tipm._GRID.tolist())


def test_block_layout_and_groups_match_reference():
    kw = dict(zero=2, nonneg=3, soc=(4, 4, 3), exp=2, psd=(2, 2, 3),
              pow3=(0.3, 0.7))
    got, mi = tipm._block_layout(TDims(**kw))
    want, mi_j = jipm._block_layout(JDims(**kw))
    assert (got, mi) == (want, mi_j)
    assert mi == TDims(**kw).total - 2
    # the groups batch the same blocks: equal family and size, in order
    groups = tipm._block_groups(TDims(**kw))
    assert [(g.fam, g.k, g.d) for g in groups] == [
        ("soc", 2, 4), ("soc", 1, 3), ("exp", 2, 3), ("psd", 2, 3),
        ("psd", 1, 6), ("pow", 2, 3)]
    flat = [(g.fam, g.off + i * g.d) for g in groups for i in range(g.k)]
    assert flat == [(f, off) for f, off, _ in want]


# -------------------------------------------------------------- solvers

# one structure per family, each with an equality row and nonneg rows
_FAMILIES = {
    "soc": dict(zero=1, nonneg=4, soc=(4, 3, 3)),
    "psd": dict(zero=1, nonneg=2, psd=(3, 2)),
    "exp": dict(zero=1, nonneg=2, exp=3),
    "pow3": dict(zero=1, nonneg=2, pow3=(0.3, 0.6)),
}
_TOL = {"soc": 1e-8, "psd": 1e-7, "exp": 1e-7, "pow3": 1e-7, "hsde": 1e-7}
# SOC and PSD blocks for the self-dual embedding (symmetric cones)
_HSDE = dict(zero=1, nonneg=3, soc=(3, 3), psd=(2,))
_F32_KW = dict(eps_abs=1e-4, eps_rel=1e-4, ipm_max_iters=50)
_DRAWS = 4


def _perturbed(args, rel, seed):
    """args with q scaled by 1 + rel * noise."""
    a = list(args)
    noise = np.random.default_rng(seed).standard_normal(a[1].shape)
    a[1] = (a[1] * (1 + rel * noise)).astype(a[1].dtype)
    return a


def _lane_err(res, ref):
    return np.max([np.abs(np.asarray(res[f]) - np.asarray(ref[f])).max(1)
                   for f in "xys"], axis=0)


def _as_dict(r):
    return {f: np.asarray(getattr(r, f)) for f in
            ("x", "y", "s", "status", "iters")}


def _ref_batch(structures, hsde, dtype=np.float64, kw=None):
    """ONE jitted reference function over several structures: a dict of
    (name -> vmapped make_ipm_solver) evaluated together."""
    st = JSettings().replace(**(kw or {}))
    fns = {f: jax.vmap(jipm.make_ipm_solver(JDims(**d), _N, st, hsde=hsde))
           for f, d in structures.items()}
    jitted = jax.jit(lambda args: {f: fns[f](*args[f]) for f in fns})

    def run(args):
        out = jitted({f: tuple(jnp.asarray(a, dtype) for a in args[f])
                      for f in fns})
        return {f: _as_dict(r) for f, r in out.items()}

    return run


def _spread(ref, args, rel):
    """The reference on the seeded programs, and per structure and lane
    how far its own (x, y, s) move, and which statuses and counts it
    takes, when q is scaled by 1 + rel * noise (_DRAWS draws)."""
    base = ref(args)
    env = {f: 0.0 for f in args}
    seen = {f: [(b["status"], b["iters"])] for f, b in base.items()}
    for seed in range(1, _DRAWS + 1):
        moved = ref({f: _perturbed(a, rel, seed) for f, a in args.items()})
        for f in args:
            env[f] = np.maximum(env[f], _lane_err(moved[f], base[f]))
            seen[f].append((moved[f]["status"], moved[f]["iters"]))
    return base, env, seen


def _runs(structures, hsde, lp):
    """The reference's spread and the port's results at f64."""
    args = {f: _program(d, _N, seed=70 + i, lp=lp)
            for i, (f, d) in enumerate(structures.items())}
    base, env, seen = _spread(_ref_batch(structures, hsde), args, 1e-15)
    port = {}
    for f, d in structures.items():
        solve = tipm.make_ipm_solver(TDims(**d), _N, TSettings(), hsde=hsde)
        port[f] = _as_dict(solve(*(torch.as_tensor(a) for a in args[f])))
    return base, env, seen, port


@pytest.fixture(scope="module")
def pd_runs():
    return _runs(_FAMILIES, hsde=False, lp=False)


def _assert_lanes_match(runs, name):
    base, env, seen, port = runs
    ref, got = base[name], port[name]
    pinned = np.ones(len(got["iters"]), bool)
    for lane in range(len(pinned)):
        taken = {(int(st[lane]), int(it[lane])) for st, it in seen[name]}
        pinned[lane] = len(taken) == 1
        assert (int(got["status"][lane]), int(got["iters"][lane])) in taken, (
            name, lane, taken)
    assert (got["status"] == SOLVED).sum() >= 2
    tol = np.maximum(_TOL[name], 4.0 * env[name])
    err = _lane_err(got, ref)
    assert (err <= tol).all(), (name, err, env[name])
    # most lanes are pinned down and held at the family's own tolerance
    assert (pinned & (err <= _TOL[name])).sum() >= 2, (name, err, pinned)


@pytest.mark.parametrize("family", list(_FAMILIES))
def test_primal_dual_form_matches_reference_f64(pd_runs, family):
    _assert_lanes_match(pd_runs, family)


def test_self_dual_embedding_matches_reference_f64():
    _assert_lanes_match(_runs({"hsde": _HSDE}, hsde=True, lp=True), "hsde")


def test_f32_condensed_route_matches_reference(monkeypatch):
    dims = _FAMILIES["soc"]
    args = _program(dims, _N, seed=80, lp=False)
    args32 = [a.astype(np.float32) for a in args]
    ref = _ref_batch({"soc": dims}, False, np.float32, _F32_KW)
    base, env, _ = _spread(ref, {"soc": args32}, 1e-6)
    base, env = base["soc"], env["soc"]
    shapes = []
    qr_r = tipm.qr_r
    monkeypatch.setattr(tipm, "qr_r", lambda M: (
        shapes.append(tuple(M.shape)), qr_r(M))[1])
    solve = tipm.make_ipm_solver(TDims(**dims), _N,
                                 TSettings().replace(**_F32_KW))
    got = _as_dict(solve(*(torch.as_tensor(a) for a in args32)))
    assert got["x"].dtype == np.float32
    # K2's plain version on the stacked factor [Lp'; B A_in]: one call for
    # the initial point and one an iteration
    mi = TDims(**dims).total - 1
    assert shapes == [(_B, _N + mi, _N)] * (int(got["iters"].max()) + 1)
    both = (got["status"] == SOLVED) & (base["status"] == SOLVED)
    assert both.sum() >= 2
    scale = max(float(np.abs(base[f]).max()) for f in "xys")
    err = _lane_err(got, base)[both]
    assert (err <= np.maximum(1e-4 * scale, 2.0 * env[both])).all(), (
        err, env)
    # and the port's f32 iterate is as close to the f64 one as the
    # reference's f32 iterate is
    f64 = _as_dict(tipm.make_ipm_solver(
        TDims(**dims), _N, TSettings().replace(**_F32_KW))(
        *(torch.as_tensor(a) for a in args)))
    assert _lane_err(got, f64)[both].max() <= max(
        1e-4 * scale, 2.0 * _lane_err(base, f64)[both].max())
