"""The port's matrix-free (sparse) route against the reference.

solver/matfree.py keeps each instance as (B, nnz) value tensors of the
stuffer's static pattern. SparseOps (matvecs as a gather, a product and
a segmented sum; maxima by scatter_reduce; scalings; the adjoint's
products at the nnz positions) is held against dense numpy products on a
CSR pattern and on a shuffled one, against a vector with one more axis
(the polish's candidates), and against the reference's SparseOps. Then,
on value tensors made by the port layer's `_assemble_sparse` from
numpy-seeded parameters of tiny LAD, box-QP and transport (OT) programs,
at f64: the Ruiz scaling within 1e-12, the matrix-free ADMM with its
polish (statuses and iteration counts equal on every lane, x, y, s
within 1e-8), the KKT solve on both of its branches (the exact Schur
split for a diagonal P and polyhedral cones; CG on the normal equations
for an SOC program) in both directions, and both derivative rules with
respect to the data vectors (the adjoint through torch.autograd against
jax.vjp, the forward-mode rule against jax.jvp) within 1e-8. Layers with
assembly="sparse" match the reference's outputs and gradients within
1e-6; "auto" takes the route above m n = 2^16 as the reference does;
rescue and warm start run on the route; the IPM refuses it, as in the
reference.

Reference configurations compiled: the operators and the Ruiz scaling in
one function, three polished solvers, two KKT solvers, the two
derivative rules, two sparse layers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.solver import matfree as jm
from cvxpylayers_tpu.solver.admm import _cone_row_groups as j_groups
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.diff.derivative import make_matfree_diff_solver
from cvxpylayers_tpu_torch.solver import matfree as tm
from cvxpylayers_tpu_torch.solver.admm import _cone_row_groups
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_B = 3
_SPARSE = {"assembly": "sparse"}


# --------------------------------------------------------------- programs


def lad(mod, **kw):
    x = mod.Variable(3, nonneg=True)
    A = mod.Parameter((5, 3))
    b = mod.Parameter(5)
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


def ot(mod, s=3, d=4, **kw):
    C = mod.Parameter((s, d))
    P = mod.Variable((s, d), nonneg=True)
    prob = mod.Problem(
        mod.Minimize(mod.sum(mod.multiply(C, P))),
        [P @ mod.Constant(np.ones(d)) == mod.Constant(np.full(s, 1 / s)),
         P.T @ mod.Constant(np.ones(s)) == mod.Constant(np.full(d, 1 / d))])
    return mod.CvxpyLayer(prob, parameters=[C], variables=[P], **kw)


def ball(mod, **kw):
    x = mod.Variable(4)
    v = mod.Parameter(4)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [mod.norm(x, 2) <= 1, x >= 0])
    return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)


def _values(name, seed):
    r = np.random.default_rng(seed)
    if name == "lad":
        return [r.standard_normal((_B, 5, 3)), r.standard_normal((_B, 5))]
    if name == "box_qp":
        return [r.standard_normal((_B, 4)), r.standard_normal((_B, 3, 4)),
                np.abs(r.standard_normal((_B, 3))) + 0.5]
    if name == "ot":
        xs, ys = r.standard_normal((_B, 3)), r.standard_normal((_B, 4))
        return [(xs[:, :, None] - ys[:, None, :]) ** 2]
    return [r.standard_normal((_B, 4))]


_BUILD = {"lad": lad, "box_qp": box_qp, "ot": ot, "ball": ball}


@functools.lru_cache(maxsize=None)
def _program(name, seed=0):
    """The port layer of a program and its sparse data (P_data, q, A_data,
    b) as f64 numpy arrays, from seeded parameters."""
    layer = _BUILD[name](ct, device="cpu")
    vals = [torch.as_tensor(a) for a in _values(name, seed)]
    batch, flags = layer._parse_batch(vals)
    p_ext = layer._stack_params(vals, batch, flags)
    data = layer._assemble_sparse(p_ext)[:4]
    return layer, tuple(d.numpy() for d in data)


def _ops(layer):
    p = layer.prog
    args = (p.A_rows, p.A_cols, p.m, p.n, p.P_rows, p.P_cols)
    return tm.SparseOps(*args), jm.SparseOps(*args)


def _dims(layer):
    d = layer.prog.dims
    kw = dict(zero=d.zero, nonneg=d.nonneg, soc=tuple(d.soc))
    return TDims(**kw), JDims(**kw)


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


# ---------------------------------------------------------------- SparseOps


def _random_pattern(r, m, n, shuffle):
    """A (m, n) pattern in CSR order (or shuffled) and a symmetric P
    pattern with both halves in a scrambled order, with values."""
    mask = r.random((m, n)) < 0.4
    mask[np.arange(m), r.integers(0, n, m)] = True
    ar, ac = np.nonzero(mask)
    Pm = r.random((n, n)) < 0.3
    Pm = Pm | Pm.T
    Pm[np.arange(n), np.arange(n)] = r.random(n) < 0.7
    pr, pc = np.nonzero(Pm)
    pperm = r.permutation(pr.size)
    pr, pc = pr[pperm], pc[pperm]
    if shuffle:
        aperm = r.permutation(ar.size)
        ar, ac = ar[aperm], ac[aperm]
    return ar, ac, pr, pc


@pytest.mark.parametrize("shuffle", [False, True], ids=["csr", "shuffled"])
def test_sparse_ops_match_dense_products(shuffle):
    r = np.random.default_rng(1)
    m, n, B = 7, 5, 2
    ar, ac, pr, pc = _random_pattern(r, m, n, shuffle)
    ops = tm.SparseOps(ar, ac, m, n, pr, pc)
    Ad = r.standard_normal((B, ar.size))
    # symmetric P values: the pattern stores both halves
    Ps = r.standard_normal((B, n, n))
    Ps = Ps + Ps.transpose(0, 2, 1)
    Pd = Ps[:, pr, pc]
    A = np.zeros((B, m, n))
    A[:, ar, ac] = Ad
    P = np.zeros((B, n, n))
    P[:, pr, pc] = Pd
    x, y = r.standard_normal((B, n)), r.standard_normal((B, m))
    xk = r.standard_normal((B, 4, n))  # k candidate points per lane
    tAd, tPd, tx, ty, txk = _t(Ad, Pd, x, y, xk)
    ok = functools.partial(np.testing.assert_allclose, atol=1e-13, rtol=0)
    ok(ops.A_mv(tAd, tx).numpy(), np.einsum("bij,bj->bi", A, x))
    ok(ops.A_mv(tAd, txk).numpy(), np.einsum("bij,bkj->bki", A, xk))
    ok(ops.A_rmv(tAd, ty).numpy(), np.einsum("bij,bi->bj", A, y))
    ok(ops.P_mv(tPd, tx).numpy(), np.einsum("bij,bj->bi", P, x))
    ok(ops.P_mv(tPd, txk).numpy(), np.einsum("bij,bkj->bki", P, xk))
    ok(ops.P_diag(tPd).numpy(), np.diagonal(P, axis1=1, axis2=2))
    ok(ops.P_trace(tPd).numpy(), np.trace(P, axis1=1, axis2=2))
    ok(ops.A_col_max(tAd.abs()).numpy(), np.abs(A).max(axis=1))
    ok(ops.A_row_max(tAd.abs()).numpy(), np.abs(A).max(axis=2))
    ok(ops.P_col_max(tPd.abs()).numpy(), np.abs(P).max(axis=1))
    de, dx = r.random((B, m)) + 0.5, r.random((B, n)) + 0.5
    ok(ops.scale_A(tAd, *_t(de, dx)).numpy(),
       (de[:, :, None] * A * dx[:, None, :])[:, ar, ac])
    ok(ops.scale_P(tPd, torch.as_tensor(dx)).numpy(),
       (dx[:, :, None] * P * dx[:, None, :])[:, pr, pc])
    u, v = r.standard_normal((B, n)), r.standard_normal((B, m))
    ok(ops.A_data_grad(*_t(y, u, v, x)).numpy(),
       (y[:, :, None] * u[:, None, :] + v[:, :, None] * x[:, None, :])
       [:, ar, ac])
    ok(ops.P_data_grad(*_t(u, x)).numpy(),
       (u[:, :, None] * x[:, None, :])[:, pr, pc])


@functools.lru_cache(maxsize=None)
def _reference_ops_and_ruiz():
    """The reference's operators and Ruiz scaling on box_qp's data, one
    jitted function; and the port's, as numpy."""
    layer, (Pd, q, Ad, b) = _program("box_qp")
    t_ops, j_ops = _ops(layer)
    _, jd = _dims(layer)
    gid, ng = j_groups(jd)
    r = np.random.default_rng(2)
    x = r.standard_normal(q.shape)
    y = r.standard_normal(b.shape)

    def ref(Pd, q, Ad, b, x, y):
        return dict(
            A_mv=j_ops.A_mv(Ad, x), A_rmv=j_ops.A_rmv(Ad, y),
            P_mv=j_ops.P_mv(Pd, x), P_diag=j_ops.P_diag(Pd),
            A_grad=j_ops.A_data_grad(y, x, y, x),
            P_grad=j_ops.P_data_grad(x, x),
            ruiz=jm._ruiz_equilibrate_matfree(j_ops, Pd, Ad, q, b, gid, ng,
                                              10))

    out_j = jax.jit(jax.vmap(ref))(*_j(Pd, q, Ad, b, x, y))
    tPd, tq, tAd, tb, tx, ty = _t(Pd, q, Ad, b, x, y)
    tgid, tng = _cone_row_groups(_dims(layer)[0])
    out_t = dict(
        A_mv=t_ops.A_mv(tAd, tx), A_rmv=t_ops.A_rmv(tAd, ty),
        P_mv=t_ops.P_mv(tPd, tx), P_diag=t_ops.P_diag(tPd),
        A_grad=t_ops.A_data_grad(ty, tx, ty, tx),
        P_grad=t_ops.P_data_grad(tx, tx),
        ruiz=tm._ruiz_equilibrate_matfree(t_ops, tPd, tAd, tq, tb, tgid,
                                          tng, 10))
    return out_j, out_t


def test_sparse_ops_and_ruiz_match_reference():
    out_j, out_t = _reference_ops_and_ruiz()
    for k in ("A_mv", "A_rmv", "P_mv", "P_diag", "A_grad", "P_grad"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=1e-13, rtol=0, err_msg=k)
    for a, b_ in zip(out_t["ruiz"], out_j["ruiz"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-12,
                                   rtol=1e-12)


# ------------------------------------------------------------- solvers


_ST = dict(eps_abs=1e-9, eps_rel=1e-9, admm_eps_abs=1e-6, admm_eps_rel=1e-6,
           max_iters=3000)


@pytest.mark.parametrize("name", ["lad", "box_qp", "ot"])
def test_matfree_admm_with_polish_matches_reference(name):
    layer, data = _program(name)
    t_ops, j_ops = _ops(layer)
    td, jd = _dims(layer)
    n = layer.prog.n
    p_diag_only = layer._p_diag_only
    solve_t = tm.make_matfree_polished_solver(
        t_ops, td, n, TSettings(**_ST), p_diag_only=p_diag_only)
    solve_j = jm.make_matfree_polished_solver(
        j_ops, jd, n, JSettings(**_ST), p_diag_only=p_diag_only)
    zeros = (np.zeros_like(data[1]), np.zeros_like(data[3]),
             np.zeros_like(data[3]))
    rj = jax.jit(jax.vmap(solve_j))(*_j(*data, *zeros))
    rt = solve_t(*_t(*data, *zeros))
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    assert (rt.status.numpy() == 0).all()
    for k in ("x", "y", "s"):
        np.testing.assert_allclose(getattr(rt, k).numpy(),
                                   np.asarray(getattr(rj, k)), atol=1e-8,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["box_qp", "ball"],
                         ids=["schur-diag", "cg-normal"])
def test_matfree_kkt_solve_matches_reference(name):
    layer, (Pd, q, Ad, b) = _program(name)
    t_ops, j_ops = _ops(layer)
    td, jd = _dims(layer)
    n, m = layer.prog.n, layer.prog.m
    r = np.random.default_rng(3)
    x = r.standard_normal((_B, n))
    # two rows active (w < 0), the rest inactive: a nonsingular J
    w = np.abs(r.standard_normal((_B, m)))
    w[:, layer.prog.dims.zero:layer.prog.dims.zero + 2] *= -1
    rhs = r.standard_normal((_B, n + m))
    kw = dict(cg_iters=40, p_diag_only=layer._p_diag_only)
    st = tm.make_matfree_kkt_solver(t_ops, td, n, **kw)
    sj = jm.make_matfree_kkt_solver(j_ops, jd, n, **kw)
    ref = jax.jit(jax.vmap(lambda *a: [sj(*a, transpose=tr, iter_refine=it)
                                       for tr in (False, True)
                                       for it in (False, True)]))
    out_j = ref(*_j(x, w, Pd, q, Ad, b, rhs))
    k = 0
    for tr in (False, True):
        for it in (False, True):
            got = st(*_t(x, w, Pd, q, Ad, b, rhs), transpose=tr,
                     iter_refine=it)
            np.testing.assert_allclose(got.numpy(), np.asarray(out_j[k]),
                                       atol=1e-9, rtol=1e-9)
            k += 1


@functools.lru_cache(maxsize=None)
def _diff_rules():
    """Both derivative rules of box_qp's sparse solver with respect to the
    data vectors, in both packages."""
    layer, data = _program("box_qp", seed=4)
    t_ops, j_ops = _ops(layer)
    td, jd = _dims(layer)
    n = layer.prog.n
    r = np.random.default_rng(5)
    zeros = (np.zeros_like(data[1]), np.zeros_like(data[3]),
             np.zeros_like(data[3]))
    cot = r.standard_normal(data[1].shape)
    tang = [r.standard_normal(d.shape) for d in data]
    out = {}
    for rule in ("adjoint", "forward"):
        st = dict(_ST, derivative=rule)
        solve_t = make_matfree_diff_solver(t_ops, td, n, TSettings(**st),
                                           p_diag_only=layer._p_diag_only)
        solve_j = jm.make_matfree_diff_solver(
            j_ops, jd, n, JSettings(**st), p_diag_only=layer._p_diag_only)
        f = jax.vmap(lambda Pd, q, Ad, b: solve_j(
            Pd, q, Ad, b, jnp.zeros_like(q), jnp.zeros_like(b),
            jnp.zeros_like(b))[0])
        if rule == "adjoint":
            _, vjp = jax.vjp(jax.jit(f), *_j(*data))
            out["ref", rule] = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
            ins = [t.requires_grad_() for t in _t(*data)]
            x = solve_t(*ins, *_t(*zeros))[0]
            (x * torch.as_tensor(cot)).sum().backward()
            out["port", rule] = [t.grad.numpy() for t in ins]
        else:
            _, jt = jax.jvp(jax.jit(f), tuple(_j(*data)),
                            tuple(_j(*tang)))
            out["ref", rule] = [np.asarray(jt)]
            with fwAD.dual_level():
                duals = [fwAD.make_dual(a, t)
                         for a, t in zip(_t(*data), _t(*tang))]
                x = solve_t(*duals, *_t(*zeros))[0]
                out["port", rule] = [fwAD.unpack_dual(x).tangent.numpy()]
    return out


@pytest.mark.parametrize("rule", ["adjoint", "forward"])
def test_matfree_derivative_rules_match_reference(rule):
    out = _diff_rules()
    for a, b_ in zip(out["port", rule], out["ref", rule]):
        np.testing.assert_allclose(a, b_, atol=1e-8, rtol=0)
        assert np.abs(a).max() > 1e-3


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("name", ["box_qp", "ball"])
def test_sparse_layer_matches_reference_with_gradients(name):
    vals = _values(name, 6)
    w = np.random.default_rng(7).standard_normal((_B, 4))
    jl = _BUILD[name](cj)
    tl = _BUILD[name](ct, device="cpu")

    def loss_j(*p):
        return (jl(*p, solver_args=_SPARSE)[0] * w).sum()

    xj = jl(*_j(*vals), solver_args=_SPARSE)[0]
    gj = jax.grad(loss_j, argnums=tuple(range(len(vals))))(*_j(*vals))
    ins = [t.requires_grad_() for t in _t(*vals)]
    (xt,), status, _ = tl.solve_with_info(*ins, solver_args=_SPARSE)
    assert (status == 0).all()
    (xt * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj),
                               atol=1e-6, rtol=0)
    for t, g in zip(ins, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6,
                                   rtol=0)


def simplex(mod, n, **kw):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [mod.sum(x) == 1, x >= 0])
    return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)


def test_auto_assembly_takes_the_sparse_route_above_the_limit():
    # m n = 301 * 300 > 2^16: "auto" is sparse, in both packages; P and
    # A are constant, but the shared route is dense-only
    tl = simplex(ct, 300, device="cpu")
    jl = simplex(cj, 300)
    st = tl._base_settings
    assert tl._route(st) == jl._route(jl._base_settings) == "sparse"
    assert not tl._use_shared(st) and not jl._use_shared(jl._base_settings)
    assert simplex(ct, 200, device="cpu")._route(st) == "dense"
    v = torch.as_tensor(np.random.default_rng(8).standard_normal((2, 300)))
    (xs,), s_s, _ = tl.solve_with_info(v)
    (xd,), s_d, _ = tl.solve_with_info(v, solver_args={"assembly": "dense"})
    assert (s_s == 0).all() and (s_d == 0).all()
    np.testing.assert_allclose(xs.numpy(), xd.numpy(), atol=1e-6)
    np.testing.assert_allclose(xs.sum(dim=1).numpy(), 1.0, atol=1e-8)


def test_rescue_and_warm_start_on_the_sparse_route():
    layer = box_qp(ct, device="cpu")
    vals = _t(*_values("box_qp", 9))
    fast = dict(_SPARSE, max_iters=25, refine_steps=0)
    deep = dict(_SPARSE, eps_abs=1e-9, eps_rel=1e-9)
    (x_f,), ws, st_f, it_f = layer.solve_and_state(*vals, solver_args=fast)
    assert (st_f != 0).any()
    (x_r,), st_r, it_r = ct.solve_with_rescue(
        layer, *vals, solver_args=fast, rescue_args=deep, capacity=_B)
    (x_d,), st_d, it_d = layer.solve_with_info(*vals, solver_args=deep)
    assert (st_r == 0).all()
    # the rescued lanes are the deep route's own solves; the iterations
    # add up
    bad = st_f != 0
    np.testing.assert_array_equal(x_r[bad].numpy(), x_d[bad].numpy())
    np.testing.assert_array_equal(it_r[bad].numpy(),
                                  (it_f + it_d)[bad].numpy())
    # warm-started at the solution, the route finishes sooner
    _, ws_d, _, _ = layer.solve_and_state(*vals, solver_args=deep)
    (x_w,), st_w, it_w = layer.solve_with_info(*vals, solver_args=deep,
                                               warm_start=ws_d)
    assert (st_w == 0).all() and int(it_w.max()) < int(it_d.max())
    np.testing.assert_allclose(x_w.numpy(), x_d.numpy(), atol=1e-8)


def test_interior_point_on_the_sparse_route_raises_as_the_reference():
    vals = _values("box_qp", 10)
    args = dict(_SPARSE, solve_method="ipm")
    with pytest.raises(ValueError, match="requires the dense assembly"):
        box_qp(cj)(*_j(*vals), solver_args=args)
    with pytest.raises(ValueError, match="requires the dense assembly"):
        box_qp(ct, device="cpu")(*_t(*vals), solver_args=args)
