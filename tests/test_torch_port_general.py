"""The port's general-cone KKT solves, ADMM routes and layers against the
reference.

solver/kkt.py solves the generalized-Jacobian systems of programs with
SOC, exponential, PSD and power cones in every mode (f64 LU, and in f32
operator CG, the dense-normal window, the stale-factor PCG and the exact
spectral-Schur solve); solver/admm.py and solver/shared.py run those
cones through the plain ADMM scan (Newton-Schulz PSD in the f32 inner
loop). The same numpy-seeded inputs go through the reference and the
port on the CPU. At f64: statuses and iteration counts equal on every
lane, solver iterates within 1e-8, layer outputs and gradients within
1e-6. In f32: each KKT mode within 1e-3 of the solution's scale of the
reference's same mode (1e-2 for the dense-normal CG, whose f32 normal
matrix floors both packages at ~2e-3; the exact modes also sit within
1e-3 of the f64 solution), and the f32 Newton-Schulz SDP
within 1e-4 with equal statuses.

Each reference configuration is compiled once per module: the f64 and
the f32 KKT solves (one function for every f32 mode), the ADMM solver
on SOC and power cones, one jitted gradient (with the forward as aux)
of each of the Markowitz (dense route) and SDP (shared route) layers and
of the softmax rescue ladder (shared route), and the f32 SDP forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.solver.admm import make_admm_solver as j_admm
from cvxpylayers_tpu.solver.kkt import make_kkt_precond as j_precond
from cvxpylayers_tpu.solver.kkt import make_kkt_solver as j_kkt
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.solver import admm as admm_module
from cvxpylayers_tpu_torch.solver.admm import make_admm_solver as t_admm
from cvxpylayers_tpu_torch.solver.kkt import DENSE_NORMAL_MAX, DENSE_NORMAL_MIN
from cvxpylayers_tpu_torch.solver.kkt import make_kkt_precond as t_precond
from cvxpylayers_tpu_torch.solver.kkt import make_kkt_solver as t_kkt
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-8
_GRAD_ATOL = 1e-6
_B = 4

# ------------------------------------------------------------- KKT solves

# SOC, exp and PSD blocks (the power cone's 3x3 blocks take the exp
# blocks' route in every mode); n + m = 49 sits in the dense-normal window
_KDIMS = dict(zero=2, nonneg=11, soc=(5, 4), exp=3, psd=(3,))
_KN = 12
# each f32 mode in the orientation its first user takes (the polish
# solves J d = r, the adjoint J' d = r); the spectral solve, which has a
# branch for each, in both
_F32_CASES = (("operator", False), ("auto", True), ("pcg", False),
              ("spectral", False), ("spectral", True))
_F64_CASES = ((False, False), (True, True))  # (transpose, regularized)
# CG steps of the two CG modes: 40 (the default) leave these 49-row
# systems far from converged (~0.9 of the solution off in both packages,
# where f32 rounding decides the digits); at 200 the operator CG reaches
# ~1e-4 of the exact solution, and the dense normal matrix H = J'J, formed
# in f32, floors at ~2e-3 (eps * kappa^2) in both
_CG_ITERS = 200
_F32_TOL = {"operator": 1e-3, "auto": 1e-2, "pcg": 1e-3, "spectral": 1e-3}


def _kkt_data(dtype):
    """A well-posed system: w puts every cone block in its projection
    region (so D has eigenvalues strictly inside (0, 1) as well as 0 and
    1) with fewer zero eigenvalues than n, so J is nonsingular."""
    r = np.random.default_rng(20)
    m = TDims(**_KDIMS).total
    L = r.standard_normal((_B, _KN, _KN))
    P = L @ L.transpose(0, 2, 1) / _KN + 0.1 * np.eye(_KN)
    nonneg = np.abs(r.standard_normal((_B, 11)))
    nonneg[:, :2] *= -1.0
    socs = []
    for d in (5, 4):
        x = r.standard_normal((_B, d - 1))
        t = 0.3 * np.linalg.norm(x, axis=1, keepdims=True)
        socs.append(np.concatenate([t, x], axis=1))
    exp = 1.0 + 0.2 * r.standard_normal((_B, 9))
    U, _ = np.linalg.qr(r.standard_normal((_B, 3, 3)))
    S = (U * np.array([2.0, 1.0, -1.0])) @ U.transpose(0, 2, 1)
    psd = np.stack([S[:, 0, 0], np.sqrt(2) * S[:, 1, 0],
                    np.sqrt(2) * S[:, 2, 0], S[:, 1, 1],
                    np.sqrt(2) * S[:, 2, 1], S[:, 2, 2]], axis=1)
    w = np.concatenate([r.standard_normal((_B, 2)), nonneg] + socs
                       + [exp, psd], axis=1)
    arrs = dict(x=r.standard_normal((_B, _KN)), w=w,
                P=P, q=r.standard_normal((_B, _KN)),
                A=r.standard_normal((_B, m, _KN)) / np.sqrt(_KN),
                b=r.standard_normal((_B, m)),
                rhs=r.standard_normal((_B, _KN + m)))
    return {k: v.astype(dtype) for k, v in arrs.items()}


_ORDER = ("x", "w", "P", "q", "A", "b")


@pytest.fixture(scope="module")
def kkt_refs():
    """The reference's solves, both orientations: f64 LU (and its
    regularized least squares) from one compile, every f32 mode from
    another."""
    jd = JDims(**_KDIMS)
    s64 = j_kkt(jd, _KN)
    precond = j_precond(jd, _KN)

    def f64(x, w, P, q, A, b, rhs):
        return {(t, reg): s64(x, w, P, q, A, b, rhs, transpose=t,
                              regularized=reg) for t, reg in _F64_CASES}

    def f32(x, w, P, q, A, b, rhs):
        W = precond(x, w, P, q, A, b)
        out = {("W", False): W}
        for mode, t in _F32_CASES:
            kw = dict(precond=W) if mode == "pcg" else {}
            out[(mode, t)] = j_kkt(jd, _KN, kkt_mode=mode,
                                   cg_iters=_CG_ITERS)(
                x, w, P, q, A, b, rhs, transpose=t, **kw)
        return out

    res = {}
    for name, fn, dtype in (("f64", f64, np.float64),
                            ("f32", f32, np.float32)):
        d = _kkt_data(dtype)
        got = jax.jit(jax.vmap(fn))(*(jnp.asarray(d[k]) for k in
                                      _ORDER + ("rhs",)))
        res[name] = {k: np.asarray(v) for k, v in got.items()}
    return res


def _t_args(d):
    return [torch.as_tensor(d[k]) for k in _ORDER]


def _exact(d, transpose):
    """The f64 solution of the f32 data's system, from the port's LU."""
    d64 = {k: v.astype(np.float64) for k, v in d.items()}
    solve = t_kkt(TDims(**_KDIMS), _KN)
    return solve(*_t_args(d64), torch.as_tensor(d64["rhs"]),
                 transpose=transpose).numpy()


def test_kkt_f64_lu_and_regularized_solves_match_reference(kkt_refs):
    d = _kkt_data(np.float64)
    solve = t_kkt(TDims(**_KDIMS), _KN)
    for (t, reg), want in kkt_refs["f64"].items():
        got = solve(*_t_args(d), torch.as_tensor(d["rhs"]), transpose=t,
                    regularized=reg).numpy()
        np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max())


def _f32_mode(kkt_refs, mode, exact=False):
    assert 0 < DENSE_NORMAL_MIN <= _KN + TDims(**_KDIMS).total \
        <= DENSE_NORMAL_MAX
    d = _kkt_data(np.float32)
    td = TDims(**_KDIMS)
    solve = t_kkt(td, _KN, kkt_mode=mode, cg_iters=_CG_ITERS)
    kw = {}
    if mode == "pcg":
        W = t_precond(td, _KN)(*_t_args(d))
        W_ref = kkt_refs["f32"][("W", False)]
        scale = np.abs(W_ref).max()
        np.testing.assert_allclose(W.numpy(), W_ref,
                                   atol=1e-4 * scale)
        kw = dict(precond=W)
    for t in (t for m_, t in _F32_CASES if m_ == mode):
        got = solve(*_t_args(d), torch.as_tensor(d["rhs"]), transpose=t,
                    **kw).numpy()
        assert got.dtype == np.float32
        want = kkt_refs["f32"][(mode, t)]
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=_F32_TOL[mode] * scale)
        if exact:
            np.testing.assert_allclose(got, _exact(d, t), atol=1e-3 * scale)


def test_kkt_f32_operator_cg_matches_reference(kkt_refs):
    _f32_mode(kkt_refs, "operator")


def test_kkt_f32_dense_normal_window_matches_reference(kkt_refs):
    _f32_mode(kkt_refs, "auto")


def test_kkt_f32_stale_factor_pcg_matches_reference(kkt_refs):
    _f32_mode(kkt_refs, "pcg", exact=True)


def test_kkt_f32_spectral_schur_matches_reference(kkt_refs):
    _f32_mode(kkt_refs, "spectral", exact=True)


# ---------------------------------------------------- the ADMM solver

# SOC and power cones (the layer tests run exp and PSD blocks)
_ADIMS = dict(zero=1, nonneg=3, soc=(3,), pow3=(0.3, 0.6))


def test_admm_general_cones_match_reference_on_every_lane():
    """A feasible random QP (b = A x0 + s0 with s0 in K), the solver
    alone: statuses, counts and iterates."""
    jd, td = JDims(**_ADIMS), TDims(**_ADIMS)
    n, m = 4, td.total
    r = np.random.default_rng(21)
    L = r.standard_normal((_B, n, n))
    P = L @ L.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    A = r.standard_normal((_B, m, n)) / np.sqrt(n)
    s0 = ct.cones.make_cone_projector(td)(
        torch.as_tensor(r.standard_normal((_B, m)))).numpy()
    b = np.einsum("bij,bj->bi", A, r.standard_normal((_B, n))) + s0
    q = r.standard_normal((_B, n))
    z = (np.zeros((_B, n)), np.zeros((_B, m)), np.zeros((_B, m)))
    data = (P, q, A, b) + z
    js = JSettings().replace(max_iters=1000, epoch=25)
    want = jax.jit(jax.vmap(j_admm(jd, n, js)))(
        *(jnp.asarray(a) for a in data))
    got = t_admm(td, n, TSettings().replace(max_iters=1000, epoch=25))(
        *(torch.as_tensor(a) for a in data))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    solved = got.status.numpy() == 0
    assert solved.sum() >= 2
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=_ATOL)
    # Anderson acceleration projects through the same general cones and
    # reaches the same solutions (its counts are held at f64 in
    # tests/test_torch_port_anderson.py, on LPs: the reference's own
    # accelerated counts move with the last bits of its input)
    aa = t_admm(td, n, TSettings().replace(max_iters=1000, epoch=25,
                                           accel_lookback=3))(
        *(torch.as_tensor(a) for a in data))
    both = solved & (aa.status.numpy() == 0)
    assert both.sum() >= 2
    np.testing.assert_allclose(aa.x.numpy()[both], got.x.numpy()[both],
                               atol=1e-4)


def test_general_cone_paths_never_take_the_polyhedral_epoch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the polyhedral epoch ran on general cones")

    monkeypatch.setattr(admm_module, "polyhedral_inner_epoch", refuse)
    layer = markowitz(ct, device="cpu")
    (w,), status, _ = layer.solve_with_info(*_t(_markowitz_values()))
    assert bool((status == 0).all()) and bool(torch.isfinite(w).all())


# -------------------------------------------------------------- layers


def markowitz(mod, n=8, k=3, **kw):
    w = mod.Variable(n, nonneg=True)
    mu = mod.Parameter(n)
    F = mod.Parameter((k, n))
    prob = mod.Problem(mod.Maximize(mu @ w),
                       [mod.norm(F @ w, 2) <= 0.25, mod.sum(w) == 1])
    return mod.CvxpyLayer(prob, parameters=[mu, F], variables=[w], **kw)


def _markowitz_values(seed=22, n=8, k=3):
    r = np.random.default_rng(seed)
    return [r.standard_normal((_B, n)) * 0.1,
            r.standard_normal((_B, k, n)) / np.sqrt(n)]


def softmax(mod, n=6, **kw):
    y = mod.Variable(n, nonneg=True)
    c = mod.Parameter(n)
    con = mod.sum(y) == 1
    prob = mod.Problem(mod.Maximize(c @ y + mod.sum(mod.entr(y))), [con])
    return mod.CvxpyLayer(prob, parameters=[c],
                          variables=[y, con.dual_variables[0]], **kw)


def _softmax_values(seed=23, n=6):
    return [np.random.default_rng(seed).standard_normal((_B, n))]


def sdp(mod, s=3, **kw):
    X = mod.Variable((s, s), PSD=True)
    C = mod.Parameter((s, s))
    prob = mod.Problem(mod.Minimize(mod.trace(C @ X)), [mod.trace(X) == 1])
    return mod.CvxpyLayer(prob, parameters=[C], variables=[X], **kw)


def _sdp_values(seed=24, s=3):
    C = np.random.default_rng(seed).standard_normal((_B, s, s))
    return [0.5 * (C + C.transpose(0, 2, 1))]


def _t(vals, grad=False, dtype=torch.float64):
    return [torch.as_tensor(a, dtype=dtype).requires_grad_(grad)
            for a in vals]


def _weights(outs_shapes, seed=25):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s) for s in outs_shapes]


def _ref_grad(build, vals, weights):
    """ONE jitted reference: gradients of sum(w_i * out_i) with the
    forward (outputs, statuses, counts) as aux."""
    lj = build(cj)

    def loss(*ps):
        outs, status, iters = lj.solve_with_info(*ps)
        total = sum(jnp.sum(o * w) for o, w in zip(outs, weights))
        return total, (outs, status, iters)

    argnums = tuple(range(len(vals)))
    fn = jax.jit(jax.grad(loss, argnums=argnums, has_aux=True))
    return fn(*(jnp.asarray(a) for a in vals))


def _layer_parity(build, vals, out_shapes):
    weights = _weights(out_shapes)
    grads_j, (outs_j, st_j, it_j) = _ref_grad(build, vals, weights)
    lt = build(ct, device="cpu")
    tin = _t(vals, grad=True)
    outs, st, it = lt.solve_with_info(*tin)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_j))
    assert (st.numpy() == 0).all()
    for o, oj in zip(outs, outs_j):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(oj),
                                   atol=_ATOL)
    sum((o * torch.as_tensor(w)).sum() for o, w in zip(outs, weights)
        ).backward()
    for p, gj in zip(tin, grads_j):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gj),
                                   atol=_GRAD_ATOL)
    return lt


def test_markowitz_dense_route_matches_reference_on_every_lane():
    # F is a parameter: the dense per-instance route, SOC in the scan
    lt = _layer_parity(markowitz, _markowitz_values(), [(_B, 8)])
    assert not lt._use_shared(lt._base_settings)
    assert lt.prog.dims.soc == (4,)


def test_sdp_shared_route_matches_reference_on_every_lane():
    # the f64 inner loop keeps the exact eigh projection
    lt = _layer_parity(sdp, _sdp_values(), [(_B, 3, 3)])
    assert lt._use_shared(lt._base_settings)
    assert lt.prog.dims.psd == (3,)


def test_sdp_f32_newton_schulz_inner_loop_matches_reference():
    vals = _sdp_values(seed=26)
    args = {"eps_abs": 1e-4, "eps_rel": 1e-4, "max_iters": 1000,
            "epoch": 100, "refine_steps": 5}
    outs_j, st_j, _ = sdp(cj).solve_with_info(
        *(jnp.asarray(a, jnp.float32) for a in vals), solver_args=args)
    lt = sdp(ct, device="cpu")
    (X,), st, _ = lt.solve_with_info(*_t(vals, dtype=torch.float32),
                                     solver_args=args)
    assert X.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    assert (st.numpy() == 0).all()
    np.testing.assert_allclose(X.numpy(), np.asarray(outs_j[0]), atol=1e-4)
    # the solution is the projector onto C's least eigenvector
    lam, U = np.linalg.eigh(vals[0])
    want = np.einsum("bi,bj->bij", U[:, :, 0], U[:, :, 0])
    np.testing.assert_allclose(X.numpy(), want, atol=1e-3)


def test_softmax_shared_route_and_rescue_ladder_match_reference():
    """bench.py's softmax ladder forced onto both stages, warm, at f64:
    a fast route of one epoch without polish (every lane fails), a first
    stage of two epochs that fails too, then the deep stage in the
    stale-factor PCG mode (its f64 polish takes the exact LU, as the
    reference's; the PCG directions themselves run in f32, in the KKT
    test above). Every solve takes the shared route with exp triples in
    the scan; outputs y and the equality dual, with gradients."""
    fast = {"max_iters": 25, "epoch": 25, "refine_steps": 0}
    stage1 = {"max_iters": 50, "epoch": 25, "refine_steps": 0}
    stage2 = {"eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 3e-4,
              "admm_eps_rel": 3e-4, "max_iters": 700, "epoch": 100,
              "refine_steps": 30, "kkt_mode": "pcg"}
    kw = dict(solver_args=fast, rescue_args=[stage1, stage2], capacity=2,
              warm_start_rescue=True)
    vals = _softmax_values(seed=27)
    weights = _weights([(_B, 6), (_B,)])
    lj = softmax(cj)

    def loss(c):
        outs, status, iters = cj.solve_with_rescue(lj, c, **kw)
        total = sum(jnp.sum(o * w) for o, w in zip(outs, weights))
        return total, (outs, status, iters)

    grad_j, (outs_j, st_j, it_j) = jax.jit(jax.grad(loss, has_aux=True))(
        jnp.asarray(vals[0]))
    lt = softmax(ct, device="cpu")
    assert lt._use_shared(lt._base_settings) and lt.prog.dims.exp == 6
    tin = _t(vals, grad=True)
    outs, st, it = ct.solve_with_rescue(lt, *tin, **kw)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_j))
    # capacity 2: two lanes went through both stages and solved there
    rescued = it.numpy() > 25
    assert rescued.sum() == 2 and (st.numpy()[rescued] == 0).all()
    for o, oj in zip(outs, outs_j):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(oj),
                                   atol=_ATOL)
    sum((o * torch.as_tensor(w)).sum() for o, w in zip(outs, weights)
        ).backward()
    np.testing.assert_allclose(tin[0].grad.numpy(), np.asarray(grad_j),
                               atol=_GRAD_ATOL)


# ------------------------------------------------------ the front end


def test_exp_and_pow_constraint_residuals_match_reference():
    r = np.random.default_rng(28)
    vals = [r.standard_normal(3) for _ in range(3)]
    got, want = [], []
    for mod, out in ((ct, got), (cj, want)):
        x, y, z = (mod.Variable(3) for _ in range(3))
        for var, v in zip((x, y, z), vals):
            var.value = v
        out.append(mod.ExpCone(x, y, z).residual)
        out.append(mod.PowCone3D(x, y, z, [0.3, 0.5, 0.8]).residual)
    for g, w in zip(got, want):
        assert g.shape == (3,)
        np.testing.assert_allclose(g, w, atol=1e-10)
    assert (np.asarray(got) > 0).any()


def test_interior_point_on_general_cones_raises_naming_the_slice():
    # the IPM's cone blocks are ported: the Markowitz call by the IPM (the
    # self-dual embedding) matches the reference's, and so does its IPM
    # rescue stage on the lanes a failing fast route hands it (lanes are
    # independent, so each rescued lane is the direct call's)
    vals = _markowitz_values()
    ipm = {"solve_method": "ipm"}
    lj = markowitz(cj)
    outs_j, st_j, it_j = jax.jit(
        lambda *p: lj.solve_with_info(*p, solver_args=ipm))(
        *(jnp.asarray(a) for a in vals))
    w_j, st_j, it_j = (np.asarray(a) for a in (outs_j[0], st_j, it_j))
    layer = markowitz(ct, device="cpu")
    (w,), st, it = layer.solve_with_info(*_t(vals), solver_args=ipm)
    np.testing.assert_array_equal(st.numpy(), st_j)
    np.testing.assert_array_equal(it.numpy(), it_j)
    assert (st_j == 0).all()
    np.testing.assert_allclose(w.numpy(), w_j, atol=_ATOL)
    fast = {"max_iters": 25, "epoch": 25, "refine_steps": 0}
    (w_f,), st_f, it_f = layer.solve_with_info(*_t(vals), solver_args=fast)
    failed = st_f.numpy() != 0
    assert failed.any()
    (w_r,), st_r, it_r = ct.solve_with_rescue(layer, *_t(vals),
                                              solver_args=fast,
                                              rescue_args=ipm)
    np.testing.assert_array_equal(st_r.numpy()[failed], st_j[failed])
    np.testing.assert_array_equal(it_r.numpy()[failed],
                                  it_f.numpy()[failed] + it_j[failed])
    np.testing.assert_allclose(w_r.numpy()[failed], w_j[failed], atol=_ATOL)
    assert torch.equal(w_r[~torch.as_tensor(failed)],
                       w_f[~torch.as_tensor(failed)])
