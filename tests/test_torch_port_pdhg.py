"""The port's PDHG (dense and matrix-free) against the reference.

solver/pdhg.py runs restarted-averaged Chambolle-Pock (power-iteration
step, Halpern averaging inside each epoch, the restart to the better of
the last iterate and the average, the gap-aware exit, Banjac
certificates) over two matvec callables: batched products on dense data,
and the SpMVs of solver/matfree.py on the sparse route. At f64, on
numpy-seeded data made by the port layer's own assembly, both are held
against the reference's make_pdhg_solver and make_matfree_pdhg_solver
(the raw first-order solve, without the polish): statuses and iteration
counts equal on every lane, x, y, s within 1e-8; on a batch whose lanes
are feasible, primal infeasible and unbounded, the certificates too; on
an SOC program, the dual-cone projection. Layers with
solve_method="pdhg" match the reference's outputs and gradients within
1e-6 on both assembly routes, a 6x5 transport plan's objective matches
scipy's linprog (HiGHS), and both packages refuse a quadratic objective.

Reference configurations compiled: two dense and two matrix-free
solvers, the certificate batch, the SOC program, two layers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.solver import matfree as jm
from cvxpylayers_tpu.solver.pdhg import make_pdhg_solver as j_pdhg
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.solver import matfree as tm
from cvxpylayers_tpu_torch.solver.pdhg import make_pdhg_solver as t_pdhg
from cvxpylayers_tpu_torch.solver.settings import (
    DUAL_INFEASIBLE,
    PRIMAL_INFEASIBLE,
    SOLVED,
)
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_B = 3
_PDHG = {"solve_method": "pdhg"}
_ST = dict(admm_eps_abs=1e-7, admm_eps_rel=1e-7, max_iters=20000,
           epoch=50)


def box_lp(mod, **kw):
    x = mod.Variable(4)
    v = mod.Parameter(4)
    G = mod.Parameter((3, 4))
    h = mod.Parameter(3)
    prob = mod.Problem(mod.Minimize(v @ x), [G @ x <= h, x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v, G, h], variables=[x], **kw)


def lad(mod, **kw):
    x = mod.Variable(3, nonneg=True)
    A = mod.Parameter((5, 3))
    b = mod.Parameter(5)
    prob = mod.Problem(mod.Minimize(0.5 * mod.pnorm(A @ x - b, 1)))
    return mod.CvxpyLayer(prob, parameters=[A, b], variables=[x], **kw)


def ot(mod, s=6, d=5, **kw):
    C = mod.Parameter((s, d))
    P = mod.Variable((s, d), nonneg=True)
    prob = mod.Problem(
        mod.Minimize(mod.sum(mod.multiply(C, P))),
        [P @ mod.Constant(np.ones(d)) == mod.Constant(np.full(s, 1 / s)),
         P.T @ mod.Constant(np.ones(s)) == mod.Constant(np.full(d, 1 / d))])
    return mod.CvxpyLayer(prob, parameters=[C], variables=[P], **kw)


def box_qp(mod, **kw):
    x = mod.Variable(4)
    v = mod.Parameter(4)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)), [x >= 0])
    return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)


def _values(name, seed, B=_B):
    r = np.random.default_rng(seed)
    if name == "box_lp":
        return [r.standard_normal((B, 4)), r.standard_normal((B, 3, 4)),
                np.abs(r.standard_normal((B, 3))) + 0.5]
    if name == "lad":
        return [r.standard_normal((B, 5, 3)), r.standard_normal((B, 5))]
    s, d = 6, 5
    xs, ys = r.standard_normal((B, s)), r.standard_normal((B, d))
    return [(xs[:, :, None] - ys[:, None, :]) ** 2]


_BUILD = {"box_lp": box_lp, "lad": lad, "ot": ot}


@functools.lru_cache(maxsize=None)
def _program(name, sparse, seed=0):
    """The port layer of a program and its data (P, q, A, b) as f64 numpy
    arrays: dense, or the sparse route's value vectors."""
    layer = _BUILD[name](ct, device="cpu")
    vals = [torch.as_tensor(a) for a in _values(name, seed)]
    batch, flags = layer._parse_batch(vals)
    p_ext = layer._stack_params(vals, batch, flags)
    assemble = layer._assemble_sparse if sparse else layer._assemble
    return layer, tuple(d.numpy() for d in assemble(p_ext)[:4])


def _dims(layer):
    d = layer.prog.dims
    kw = dict(zero=d.zero, nonneg=d.nonneg, soc=tuple(d.soc))
    return TDims(**kw), JDims(**kw)


def _starts(q, b):
    return np.zeros_like(q), np.zeros_like(b), np.zeros_like(b)


def _check(rt, rj, atol=1e-8):
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    for k in ("x", "y", "s"):
        np.testing.assert_allclose(getattr(rt, k).numpy(),
                                   np.asarray(getattr(rj, k)), atol=atol,
                                   rtol=0, err_msg=k)


def _solvers(layer, sparse, **extra):
    td, jd = _dims(layer)
    n = layer.prog.n
    ts, js = TSettings(**_ST, **extra), JSettings(**_ST, **extra)
    if not sparse:
        return t_pdhg(td, n, ts), j_pdhg(jd, n, js)
    p = layer.prog
    args = (p.A_rows, p.A_cols, p.m, p.n, p.P_rows, p.P_cols)
    return (tm.make_matfree_pdhg_solver(tm.SparseOps(*args), td, n, ts),
            jm.make_matfree_pdhg_solver(jm.SparseOps(*args), jd, n, js))


def _run(layer, data, sparse):
    solve_t, solve_j = _solvers(layer, sparse)
    full = data + _starts(data[1], data[3])
    rj = jax.jit(jax.vmap(solve_j))(*(jnp.asarray(a) for a in full))
    rt = solve_t(*(torch.as_tensor(a) for a in full))
    return rt, rj


@pytest.mark.parametrize("name", ["box_lp", "lad"])
def test_dense_pdhg_matches_reference(name):
    layer, data = _program(name, False)
    rt, rj = _run(layer, data, False)
    _check(rt, rj)
    assert (rt.status.numpy() == SOLVED).all()


@pytest.mark.parametrize("name", ["box_lp", "ot"])
def test_matfree_pdhg_matches_reference(name):
    layer, data = _program(name, True)
    rt, rj = _run(layer, data, True)
    _check(rt, rj)
    assert (rt.status.numpy() == SOLVED).all()


def test_dense_and_matfree_pdhg_run_the_same_iteration():
    layer, dense = _program("box_lp", False)
    _, sparse = _program("box_lp", True)
    rd = _solvers(layer, False)[0](
        *(torch.as_tensor(a) for a in dense + _starts(dense[1], dense[3])))
    rs = _solvers(layer, True)[0](
        *(torch.as_tensor(a) for a in sparse + _starts(sparse[1],
                                                       sparse[3])))
    np.testing.assert_array_equal(rd.iters.numpy(), rs.iters.numpy())
    np.testing.assert_allclose(rd.x.numpy(), rs.x.numpy(), atol=1e-10)


@functools.lru_cache(maxsize=None)
def _certificates():
    """Three lanes of min q'x over -x <= 0 and a'x <= beta (n=2, m=3):
    feasible, primal infeasible (x1 + x2 <= -1) and unbounded
    (x1 + x2 >= -1 under q < 0), by both packages' dense PDHG."""
    q = np.array([[-1.0, -2.0]] * 3)
    A = np.array([[[-1.0, 0], [0, -1], [1, 1]],
                  [[-1.0, 0], [0, -1], [1, 1]],
                  [[-1.0, 0], [0, -1], [-1, -1]]])
    b = np.array([[0.0, 0, 1], [0, 0, -1], [0, 0, 1]])
    P = np.zeros((3, 2, 2))
    full = (P, q, A, b) + _starts(q, b)
    solve_t = t_pdhg(TDims(nonneg=3), 2, TSettings(**_ST))
    solve_j = j_pdhg(JDims(nonneg=3), 2, JSettings(**_ST))
    rj = jax.jit(jax.vmap(solve_j))(*(jnp.asarray(a) for a in full))
    rt = solve_t(*(torch.as_tensor(a) for a in full))
    return rt, rj


@pytest.mark.parametrize("lane,status", [(1, PRIMAL_INFEASIBLE),
                                         (2, DUAL_INFEASIBLE)],
                         ids=["primal", "dual"])
def test_infeasibility_certificates_match_reference(lane, status):
    rt, rj = _certificates()
    _check(rt, rj)
    assert rt.status.tolist()[0] == SOLVED
    assert rt.status.tolist()[lane] == status
    np.testing.assert_allclose(rt.x.numpy()[0], [0.0, 1.0], atol=1e-6)


def test_soc_program_matches_reference():
    # max v'x over |x| <= 1 (one SOC block of 4 rows, n = 3): x = v/|v|
    r = np.random.default_rng(3)
    v = r.standard_normal((_B, 3))
    q = -v
    A = np.broadcast_to(np.vstack([np.zeros((1, 3)), -np.eye(3)]),
                        (_B, 4, 3)).copy()
    b = np.broadcast_to(np.array([1.0, 0, 0, 0]), (_B, 4)).copy()
    full = (np.zeros((_B, 3, 3)), q, A, b) + _starts(q, b)
    solve_t = t_pdhg(TDims(soc=(4,)), 3, TSettings(**_ST))
    solve_j = j_pdhg(JDims(soc=(4,)), 3, JSettings(**_ST))
    rj = jax.jit(jax.vmap(solve_j))(*(jnp.asarray(a) for a in full))
    rt = solve_t(*(torch.as_tensor(a) for a in full))
    _check(rt, rj)
    np.testing.assert_allclose(
        rt.x.numpy(), v / np.linalg.norm(v, axis=1, keepdims=True),
        atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_pdhg_layer_matches_reference_with_gradients(sparse):
    args = dict(_PDHG, assembly="sparse" if sparse else "dense")
    vals = _values("box_lp", 4)
    w = np.random.default_rng(5).standard_normal((_B, 4))
    jl, tl = box_lp(cj), box_lp(ct, device="cpu")
    jv = [jnp.asarray(a) for a in vals]
    xj = jl(*jv, solver_args=args)[0]
    gj = jax.grad(lambda *p: (jl(*p, solver_args=args)[0] * w).sum(),
                  argnums=(0, 1, 2))(*jv)
    ins = [torch.as_tensor(a).requires_grad_() for a in vals]
    (xt,), status, _ = tl.solve_with_info(*ins, solver_args=args)
    assert (status == 0).all()
    (xt * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj),
                               atol=1e-6, rtol=0)
    for t, g in zip(ins, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6,
                                   rtol=0)


def _linprog_objectives(C):
    _, s, d = C.shape
    A_eq = np.vstack([np.kron(np.eye(s), np.ones(d)),
                      np.kron(np.ones(s), np.eye(d))])
    b_eq = np.r_[np.full(s, 1 / s), np.full(d, 1 / d)]
    return np.array([linprog(c.ravel(), A_eq=A_eq, b_eq=b_eq,
                             bounds=(0, None), method="highs").fun
                     for c in C])


@pytest.mark.parametrize("dtype,args,tol", [
    (torch.float64, {}, 1e-7),
    # bench.py's transport row's settings, at its 1e-3
    (torch.float32, dict(eps_abs=1e-3, eps_rel=1e-3, admm_eps_abs=1e-4,
                         admm_eps_rel=1e-4, max_iters=60000, epoch=500,
                         refine_steps=10), 1e-3),
], ids=["f64", "f32"])
def test_transport_plan_objective_matches_linprog(dtype, args, tol):
    layer = ot(ct, device="cpu")
    (C,) = _values("ot", 6, B=4)
    (X,), status, _ = layer.solve_with_info(
        torch.as_tensor(C, dtype=dtype),
        solver_args=dict(args, solve_method="pdhg", assembly="sparse"))
    assert (status == 0).all()
    obj = (X.double().numpy() * C).sum(axis=(1, 2))
    lp = _linprog_objectives(C)
    assert (np.abs(obj - lp) / np.abs(lp)).max() <= tol
    # a plan: nonnegative with the uniform marginals
    assert X.min() >= -1e-6
    np.testing.assert_allclose(X.double().sum(dim=2).numpy(), 1 / 6,
                               atol=1e-4 if dtype == torch.float32 else 1e-7)


@pytest.mark.parametrize("assembly", ["dense", "sparse"])
def test_quadratic_objective_is_refused_as_the_reference(assembly):
    args = dict(_PDHG, assembly=assembly)
    v = np.random.default_rng(7).standard_normal((_B, 4))
    with pytest.raises(ValueError, match="no quadratic objective"):
        box_qp(cj)(jnp.asarray(v), solver_args=args)
    with pytest.raises(ValueError, match="no quadratic objective"):
        box_qp(ct, device="cpu")(torch.as_tensor(v), solver_args=args)


def test_warm_start_at_the_solution_finishes_sooner():
    layer = box_lp(ct, device="cpu")
    vals = [torch.as_tensor(a) for a in _values("box_lp", 8)]
    (x,), ws, status, iters = layer.solve_and_state(*vals,
                                                    solver_args=_PDHG)
    (x_w,), st_w, it_w = layer.solve_with_info(*vals, solver_args=_PDHG,
                                               warm_start=ws)
    assert (status == 0).all() and (st_w == 0).all()
    assert int(it_w.max()) < int(iters.max())
    np.testing.assert_allclose(x_w.numpy(), x.numpy(), atol=1e-6)
