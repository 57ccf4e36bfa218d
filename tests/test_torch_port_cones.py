"""The port's general-cone projections and Jacobians against the reference.

cvxpylayers_tpu_torch/cones/projections.py and cones/jacobians.py carry
the SOC, exponential, PSD (exact and Newton-Schulz) and power-cone
projections, the product and dual projectors, the factored and dense
generalized Jacobians and the spectral form that the KKT solves take. The
same numpy-seeded inputs go through each JAX function (jitted and vmapped
over the rows) and its port on the CPU: projections within 1e-10 in f64
and 1e-5 of the input's scale in f32, Jacobians within 1e-9 in f64.
Every branch of each projection is covered: SOC inside, polar and
boundary; exp in the cone, in the polar, in the degenerate quadrant and
at cliff points with a large root; pow3 at z = 0 and alpha in
{0.3, 0.5, 0.8}; PSD blocks with zero and repeated eigenvalues.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvxpylayers_tpu.cones import jacobians as jjac
from cvxpylayers_tpu.cones import projections as jproj
from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu_torch.cones import jacobians as tjac
from cvxpylayers_tpu_torch.cones import projections as tproj
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_DTYPES = {"f64": (np.float64, 1e-10), "f32": (np.float32, 1e-5)}

# one jitted reference per function, shared by the tests
_j_soc = jax.jit(jax.vmap(jproj.project_soc))
_j_exp = jax.jit(jax.vmap(jproj.project_exp))
_j_pow = jax.jit(jax.vmap(jproj.project_pow3))
_j_dexp = jax.jit(jax.vmap(jax.jacfwd(jproj.project_exp)))
_j_dpow = jax.jit(jax.vmap(jax.jacfwd(jproj.project_pow3, argnums=0)))

# a product cone with every family, two SOC runs and two PSD sizes
_MIXED = dict(zero=2, nonneg=3, soc=(4, 4, 3), exp=3, psd=(3, 2),
              pow3=(0.3, 0.5, 0.8))


def _rows_close(got, want, v, tol):
    """|got - want| within tol of each row's scale max(1, max |v|)."""
    err = np.abs(got - want) / np.maximum(
        1.0, np.abs(v).max(axis=1, keepdims=True))
    assert err.max() <= tol, (err.max(), np.unravel_index(err.argmax(),
                                                           err.shape))


def _shadow_tol(fn, x, tol):
    """Per-lane tolerance max(tol, 4 x the distance the reference's own
    result moves when its input moves by one ulp). Near the exponential
    cliff (a large root) the implicit derivative of the root is
    ill-conditioned: there the reference's Jacobian moves by up to ~5e-6
    under a one-ulp change of v, so no port can agree to 1e-9 there."""
    base = np.asarray(fn(jnp.asarray(x)))
    moves = np.zeros(base.shape[0])
    for e in (2.0 ** -52, -(2.0 ** -52)):
        shadow = np.asarray(fn(jnp.asarray(x * (1.0 + e))))
        moves = np.maximum(moves, np.abs(shadow - base).reshape(
            base.shape[0], -1).max(axis=1))
    return base, np.maximum(tol, 4.0 * moves)


def _lanes_close(got, want, tols):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
    assert (err <= tols).all(), (err, tols)


def _close(got, want, tol, scale=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if scale is None else scale
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _exp_points(r):
    """Triples in the cone, in the polar, in the degenerate quadrant, the
    reference's known cliff points (a large root) and random ones over
    four decades."""
    cases = [
        [0.5, 1.0, 3.0], [-1.0, 0.0, 2.0],        # in the cone
        [0.5, -1.0, -3.0], [1.0, -1.0, -3.0],     # in the polar
        [-1.0, -2.0, 0.5], [-0.3, -0.1, -0.4],    # degenerate quadrant
        [0.12754856, -30.64533796, 0.15325743],   # cliff points
        [0.0027298, -0.65002007, 0.18004724],
        [0.00070501, -0.11257819, 0.35997929],
        [1.0, 1.0, 1.0], [3.0, 0.1, 0.2],
    ]
    rand = r.standard_normal((24, 3)) * 10.0 ** r.uniform(-2, 2, (24, 1))
    return np.concatenate([np.array(cases), rand])


def _soc_points(r, d=5):
    """Blocks inside the cone, in the polar, on both boundaries and
    between them."""
    x = r.standard_normal((12, d - 1))
    nx = np.linalg.norm(x, axis=1)
    t = np.concatenate([nx[:3] + 0.5, -nx[3:6] - 0.5, nx[6:8], -nx[8:9],
                        0.3 * nx[9:]])
    return np.concatenate([t[:, None], x], axis=1)


@pytest.mark.parametrize("prec", sorted(_DTYPES))
def test_soc_projection_matches_reference_in_every_region(prec):
    dtype, tol = _DTYPES[prec]
    v = _soc_points(np.random.default_rng(1)).astype(dtype)
    want = _j_soc(jnp.asarray(v))
    got = tproj.project_soc(torch.as_tensor(v))
    assert got.dtype == torch.as_tensor(v).dtype
    _close(got, want, tol)
    # the regions land where they should: identity, zero, the boundary
    g = got.numpy()
    np.testing.assert_array_equal(g[:3], v[:3])
    np.testing.assert_array_equal(g[3:6], 0.0)
    np.testing.assert_allclose(np.linalg.norm(g[9:, 1:], axis=1), g[9:, 0],
                               rtol=10 * tol)


@pytest.mark.parametrize("prec", sorted(_DTYPES))
def test_exp_projection_matches_reference_in_every_case(prec):
    dtype, tol = _DTYPES[prec]
    v = _exp_points(np.random.default_rng(2)).astype(dtype)
    want = np.asarray(_j_exp(jnp.asarray(v)))
    got = tproj.project_exp(torch.as_tensor(v)).numpy()
    assert np.isfinite(got).all()
    _rows_close(got, want, v, tol)
    # in the cone: identity; in the polar: zero; degenerate: (r, 0, t+)
    np.testing.assert_array_equal(got[:2], v[:2])
    np.testing.assert_array_equal(got[2:4], 0.0)
    np.testing.assert_array_equal(got[4], [v[4, 0], 0.0, v[4, 2]])


@pytest.mark.parametrize("prec", sorted(_DTYPES))
def test_pow3_projection_matches_reference_at_z_zero_and_each_alpha(prec):
    dtype, tol = _DTYPES[prec]
    r = np.random.default_rng(3)
    v = r.standard_normal((30, 3)) * 10.0 ** r.uniform(-1, 1, (30, 1))
    v[:6, 2] = 0.0  # z = 0: x and y clamp at 0
    v[6] = [1.0, 1.0, 0.5]  # in the cone for every alpha
    v[7] = [-1.0, -1.0, 0.1]  # in the polar
    alphas = np.resize([0.3, 0.5, 0.8], 30)
    v, alphas = v.astype(dtype), alphas.astype(dtype)
    want = np.asarray(_j_pow(jnp.asarray(v), jnp.asarray(alphas)))
    got = tproj.project_pow3(torch.as_tensor(v),
                             torch.as_tensor(alphas)).numpy()
    _rows_close(got, want, v, tol)
    np.testing.assert_allclose(got[:6], np.maximum(v[:6], 0.0),
                               atol=tol * 10)
    np.testing.assert_array_equal(got[6], v[6])
    np.testing.assert_array_equal(got[7], 0.0)


def _psd_blocks(s=4):
    """svec blocks of matrices with a zero eigenvalue, a repeated one, a
    repeated negative one, and random spectra."""
    r = np.random.default_rng(4)
    spectra = [[0.0, 1.0, 2.0, -1.0], [1.5, 1.5, -0.5, 0.0],
               [-2.0, -2.0, 1.0, 3.0], [0.0, 0.0, 0.0, 1.0]]
    mats = []
    for lam in spectra + [r.standard_normal(s) for _ in range(4)]:
        U, _ = np.linalg.qr(r.standard_normal((s, s)))
        mats.append((U * lam) @ U.T)
    rows, cols = jproj.svec_indices(s)
    rows, cols = np.asarray(rows), np.asarray(cols)
    scale = np.where(rows == cols, 1.0, np.sqrt(2.0))
    return np.stack([M[rows, cols] * scale for M in mats]), s


def test_psd_projection_matches_reference_with_zero_and_repeated_eigenvalues():
    v, s = _psd_blocks()
    for dtype, tol in _DTYPES.values():
        want = jax.jit(jax.vmap(lambda b: jproj.project_psd_svec(b, s)))(
            jnp.asarray(v.astype(dtype)))
        got = tproj.project_psd_svec(torch.as_tensor(v.astype(dtype)), s)
        _close(got, want, 10 * tol)
    # svec and back is the identity, and sym_to_svec inverts svec_to_sym
    t = torch.as_tensor(v)
    np.testing.assert_allclose(
        tproj.sym_to_svec(tproj.svec_to_sym(t, s)).numpy(), v, atol=1e-15)
    np.testing.assert_allclose(
        tproj.svec_to_sym(t, s).numpy(),
        np.asarray(jax.vmap(lambda b: jproj.svec_to_sym(b, s))(
            jnp.asarray(v))), atol=1e-15)


def test_newton_schulz_psd_projection_matches_reference_in_f32():
    v, s = _psd_blocks()
    v = v.astype(np.float32)
    want = jax.jit(jax.vmap(lambda b: jproj.project_psd_svec_ns(b, s)))(
        jnp.asarray(v))
    got = tproj.project_psd_svec_ns(torch.as_tensor(v), s)
    _close(got, want, 1e-5)
    assert tproj._NS_SIGN_ITERS == jproj._NS_SIGN_ITERS == 18


def test_product_and_dual_projectors_match_reference():
    jd, td = JDims(**_MIXED), TDims(**_MIXED)
    assert tproj._group_runs(td.soc) == jproj._group_runs(jd.soc)
    r = np.random.default_rng(5)
    v = r.standard_normal((3, td.total)) * 2.0
    # one compile: the reference's dual projector is v + Pi_K(-v)
    ref = np.asarray(jax.jit(jax.vmap(jproj.make_cone_projector(jd)))(
        jnp.asarray(np.concatenate([v, -v]))))
    got = tproj.make_cone_projector(td)(torch.as_tensor(v))
    _close(got, ref[:3], 1e-10)
    got_dual = tproj.make_dual_cone_projector(td)(torch.as_tensor(v))
    _close(got_dual, v + ref[3:], 1e-10)
    # the Newton-Schulz mode differs from the exact one only on PSD rows
    ns = tproj.make_cone_projector(td, psd_mode="ns")(torch.as_tensor(v))
    psd = slice(td.offset_psd, td.offset_pow)
    rest = np.ones(td.total, bool)
    rest[psd] = False
    np.testing.assert_array_equal(ns.numpy()[:, rest], got.numpy()[:, rest])
    np.testing.assert_allclose(ns.numpy()[:, psd], got.numpy()[:, psd],
                               atol=2e-2)
    # Moreau: v = Pi_K(v) - Pi_K*(-v), and the two parts are orthogonal
    pk = got.numpy()
    pd = tproj.make_dual_cone_projector(td)(torch.as_tensor(-v)).numpy()
    np.testing.assert_allclose(pk - pd, v, atol=1e-12)
    assert np.abs((pk * pd).sum(axis=1)).max() < 1e-9


def test_exp_and_pow_jacobian_blocks_match_reference():
    v = _exp_points(np.random.default_rng(6))
    want, tols = _shadow_tol(_j_dexp, v, 1e-9)
    got = tjac.dproj_exp(torch.as_tensor(v)).numpy()
    assert np.isfinite(got).all()
    _lanes_close(got, want, tols)
    assert (tols == 1e-9).mean() > 0.9  # the cliff is a few points
    r = np.random.default_rng(7)
    w = r.standard_normal((12, 3))
    w[:3, 2] = 0.0
    alphas = np.resize([0.3, 0.5, 0.8], 12)
    want = np.asarray(_j_dpow(jnp.asarray(w), jnp.asarray(alphas)))
    got = tjac.dproj_pow3(torch.as_tensor(w), torch.as_tensor(alphas))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)


def _mixed_points(B=3):
    r = np.random.default_rng(8)
    td = TDims(**_MIXED)
    return r.standard_normal((B, td.total)) * 1.5, r.standard_normal(
        (B, td.total))


@pytest.fixture(scope="module")
def mixed_refs():
    """The reference's dense Jacobian, factored apply and spectral action
    at the mixed points, from ONE compile, with each lane's tolerance
    max(1e-9, 4 x the distance they move under a one-ulp change of w)."""
    jd = JDims(**_MIXED)
    w, v = _mixed_points()
    dense = jjac.make_cone_dproj_dense(jd)
    fac, app = jjac.make_cone_dproj_factored(jd)
    spec = jjac.make_cone_dproj_spectral(jd)

    def one(wl, vl):
        Qj, lj = spec(wl)
        return dense(wl), app(fac(wl), vl), Qj @ (lj * (Qj.T @ vl)), lj

    fn = jax.jit(jax.vmap(one))
    outs = [fn(jnp.asarray(w * (1.0 + e)), jnp.asarray(v))
            for e in (0.0, 2.0 ** -52, -(2.0 ** -52))]
    res = {}
    for k, name in enumerate(("dense", "apply", "spectral", "lam")):
        base = np.asarray(outs[0][k])
        moves = np.max([np.abs(np.asarray(o[k]) - base).reshape(
            base.shape[0], -1).max(axis=1) for o in outs[1:]], axis=0)
        res[name] = (base, np.maximum(1e-9, 4.0 * moves))
    return w, v, res


def test_dense_jacobian_matches_reference(mixed_refs):
    w, _, res = mixed_refs
    got = tjac.make_cone_dproj_dense(TDims(**_MIXED))(torch.as_tensor(w))
    _lanes_close(got, *res["dense"])
    # block diagonal and symmetric
    g = got.numpy()
    np.testing.assert_allclose(g, g.transpose(0, 2, 1), atol=1e-9)


def test_factored_apply_matches_reference(mixed_refs):
    w, v, res = mixed_refs
    td = TDims(**_MIXED)
    tf, ta = tjac.make_cone_dproj_factored(td)
    got = ta(tf(torch.as_tensor(w)), torch.as_tensor(v))
    _lanes_close(got, *res["apply"])
    once = tjac.make_cone_dproj_apply(td)(torch.as_tensor(w),
                                          torch.as_tensor(v))
    np.testing.assert_array_equal(once.numpy(), got.numpy())
    # the apply also takes a stack of vectors per lane (the dense-normal
    # KKT route applies it to the identity)
    stack = torch.as_tensor(np.stack([v, 2.0 * v], axis=1))
    np.testing.assert_allclose(ta(tf(torch.as_tensor(w)), stack)[:, 1].numpy(),
                               2.0 * got.numpy(), atol=1e-12)


def test_spectral_form_acts_as_the_jacobian(mixed_refs):
    w, v, res = mixed_refs
    td = TDims(**_MIXED)
    Q, lam = tjac.make_cone_dproj_spectral(td)(torch.as_tensor(w))
    Q, lam = Q.numpy(), lam.numpy()
    assert lam.min() >= 0.0 and lam.max() <= 1.0
    eye = np.eye(td.total)
    np.testing.assert_allclose(Q.transpose(0, 2, 1) @ Q,
                               np.broadcast_to(eye, Q.shape), atol=1e-10)
    # Q diag(lam) Q' v against the reference's spectral form on the same
    # vectors (eigenvectors may differ; the action may not), within 1e-8:
    # XLA's compiled arccos/cos in the closed-form 3x3 eigenvalues move
    # the reference's own action by up to 2.5e-9 on these lanes against
    # its eager evaluation (which the port matches to 1e-15)
    act = np.einsum("bij,bj,bkj,bk->bi", Q, lam, Q, v)
    want, tols = res["spectral"]
    _lanes_close(act, want, np.maximum(tols, 1e-8))
    want_lam, tols = res["lam"]
    _lanes_close(np.sort(lam, axis=1), np.sort(want_lam, axis=1),
                 np.maximum(tols, 1e-8))
    # and it is the Jacobian's action, up to the asymmetry of the exp
    # blocks' implicit derivative (both packages symmetrize those blocks)
    D = tjac.make_cone_dproj_dense(td)(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(act, np.einsum("bij,bj->bi", D, v),
                               atol=1e-7)
