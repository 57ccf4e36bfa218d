"""The shared constant-P/A route of the port against the reference's.

When P and A depend on no parameter, both packages' default call
(`shared_setup="auto"`) runs a batched ADMM with one factor for the whole
batch (solver/shared.py), then the per-instance polish and adjoint with
the ADMM loop off. The same numpy-seeded parameters go through the
reference layer and the port's on the CPU in f64: statuses and per-lane
iteration counts must be equal, and outputs agree to 1e-8 and gradients
to 1e-6 (the bound of the other layer tests). The simplex projection at
n=20, B=256 is the case where the port once took the dense route and ran
17 epochs where the reference ran 5.

Each JAX reference is compiled once per module: one default call at
B=256, one jitted gradient of the small program (which also gives its
forward, and serves the warm-start and infeasible batches), and the
shared solver on its own.
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
from cvxpylayers_tpu.solver.settings import SolverSettings as JSettings
from cvxpylayers_tpu.solver.shared import (
    make_shared_admm_solver as j_shared,
)
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.solver import admm as admm_module
from cvxpylayers_tpu_torch.solver import cuda_admm
from cvxpylayers_tpu_torch.solver import shared as shared_module
from cvxpylayers_tpu_torch.solver.admm import make_admm_solver as t_admm
from cvxpylayers_tpu_torch.solver.settings import (
    MAX_ITERS,
    PRIMAL_INFEASIBLE,
    SOLVED,
)
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-8
_GRAD_ATOL = 1e-6
_N, _B = 6, 4


def simplex(mod, n=20, **kw):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    eq = mod.sum(x) == 1
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)), [eq, x >= 0])
    return mod.CvxpyLayer(prob, parameters=[v],
                          variables=[x, eq.dual_variables[0]], **kw)


def capped_simplex(mod, n=_N, **kw):
    """Projection onto {x : sum x = t, 0 <= x <= u}: P and A constant,
    q and b parametric (t and u enter b)."""
    x = mod.Variable(n)
    v = mod.Parameter(n)
    t = mod.Parameter()
    u = mod.Parameter(n)
    eq = mod.sum(x) == t
    ub = x <= u
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [eq, x >= 0, ub])
    return mod.CvxpyLayer(
        prob, parameters=[v, t, u],
        variables=[x, eq.dual_variables[0], ub.dual_variables[0]], **kw)


def capped_values(seed=0, infeasible_lane=None):
    r = np.random.default_rng(seed)
    v = r.standard_normal((_B, _N))
    u = 0.3 + r.random((_B, _N))
    t = 0.5 + r.random(_B)
    if infeasible_lane is not None:
        t[infeasible_lane] = u[infeasible_lane].sum() + 1.0
    return [v, t, u]


def box_qp(mod, n=_N, m_ineq=3, **kw):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    G = mod.Parameter((m_ineq, n))
    h = mod.Parameter(m_ineq)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [G @ x <= h, x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v, G, h], variables=[x], **kw)


@pytest.fixture(scope="module")
def weights():
    r = np.random.default_rng(99)
    return [r.standard_normal((_B, _N)), r.standard_normal(_B),
            r.standard_normal((_B, _N))]


@pytest.fixture(scope="module")
def jax_capped(weights):
    """One reference layer and ONE jitted function that returns the
    gradient of a weighted sum of the outputs with the forward (outputs,
    statuses, counts) as aux; the warm start is an argument, zeros for a
    cold start."""
    lj = capped_simplex(cj)

    def loss(v, t, u, wx, wy, ws):
        outs, _, status, iters = lj.solve_and_state(
            v, t, u, warm_start=cj.WarmStart(x=wx, y=wy, s=ws))
        total = sum(jnp.sum(o * w) for o, w in zip(outs, weights))
        return total, (outs, status, iters)

    return lj, jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))


def _ref(jax_capped, vals, warm=None):
    lj, fn = jax_capped
    n, m = lj.prog.n, lj.prog.m
    warm = warm or (np.zeros((_B, n)), np.zeros((_B, m)), np.zeros((_B, m)))
    return fn(*(jnp.asarray(a) for a in tuple(vals) + tuple(warm)))


def _port(vals, layer=None, grad=False, **kw):
    lt = layer or capped_simplex(ct, device="cpu")
    tin = [torch.as_tensor(a).requires_grad_(grad) for a in vals]
    outs, ws, st, it = lt.solve_and_state(*tin, **kw)
    return lt, tin, outs, ws, st, it


def _assert_same(ref, got, atol=_ATOL):
    (oj, sj, ij), (ot, st, it) = ref, got
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    for a, b in zip(oj, ot):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=atol, rtol=0)


def test_simplex_default_call_matches_reference_on_every_lane():
    # n=20, B=256, seed 2, default solver args: the route once differed
    # (51 lanes with other counts, 17 epochs against 5); now both
    # packages take the shared route, lane for lane
    vals = np.random.default_rng(2).standard_normal((256, 20))
    oj, sj, ij = simplex(cj).solve_with_info(jnp.asarray(vals))
    lt = simplex(ct, device="cpu")
    before = cuda_admm.LAUNCHES
    ot, st, it = lt.solve_with_info(torch.as_tensor(vals))
    assert cuda_admm.LAUNCHES == before
    assert lt._use_shared(lt._base_settings)
    _assert_same((oj, sj, ij), (ot, st, it))
    assert (st == SOLVED).all()
    assert int(it.max()) == int(np.asarray(ij).max())


def test_shared_solver_matches_reference_directly():
    layer = capped_simplex(ct, device="cpu")
    prog = layer.prog
    P, A = prog.constant_P(), prog.constant_A()
    vals = [torch.as_tensor(a) for a in capped_values(seed=3)]
    q, b, _ = layer._assemble_qb(
        layer._stack_params(vals, _B, [True] * 3))
    warm = [np.zeros((_B, prog.n)), np.zeros((_B, prog.m)),
            np.zeros((_B, prog.m))]
    warm[0][1] = 0.2  # one lane starts elsewhere
    args = [q.numpy(), b.numpy()] + warm
    jr = jax.jit(j_shared(JDims(**vars(prog.dims)), prog.n, JSettings(),
                          P, A))(*(jnp.asarray(a) for a in args))
    tr = shared_module.make_shared_admm_solver(
        prog.dims, prog.n, TSettings(), P, A)(
        *(torch.as_tensor(a) for a in args))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jr.iters))
    for f in ("x", "y", "s", "pobj"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), atol=_ATOL,
                                   rtol=0)
    assert tr.status.tolist() == [SOLVED] * _B


@pytest.mark.parametrize("k", [3, 4])
def test_pooled_cost_scale_takes_the_reference_median(k):
    # an even batch averages the two middle values (jnp.median); an odd
    # one takes the middle value
    v = torch.tensor([4.0, 1.0, 3.0, 2.0][:k], dtype=torch.float64)
    got = float(shared_module._median(v))
    assert got == float(jnp.median(jnp.asarray(v.numpy())))
    assert got == (2.5 if k == 4 else 3.0)


def test_parametric_b_routes_shared_and_matches_reference(jax_capped):
    vals = capped_values()
    _, (oj, sj, ij) = _ref(jax_capped, vals)
    lt, _, ot, _, st, it = _port(vals)
    assert lt._pa_constant and lt._use_shared(lt._base_settings)
    assert jax_capped[0]._use_shared(jax_capped[0]._base_settings)
    _assert_same((oj, sj, ij), (ot, st, it))
    assert (st == SOLVED).all()
    np.testing.assert_allclose(ot[0].sum(dim=1).numpy(), vals[1],
                               atol=1e-8)


def test_gradients_through_the_shared_route_match_reference(jax_capped,
                                                            weights):
    vals = capped_values()
    gj, (oj, sj, ij) = _ref(jax_capped, vals)
    lt, tin, ot, _, st, it = _port(vals, grad=True)
    loss = sum((o * torch.as_tensor(w)).sum() for o, w in zip(ot, weights))
    loss.backward()
    _assert_same((oj, sj, ij), (ot, st, it))
    for g, t in zip(gj, tin):
        assert t.grad is not None and tuple(t.grad.shape) == tuple(g.shape)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=_GRAD_ATOL, rtol=0)
    assert float(tin[0].grad.abs().max()) > 1e-3  # not trivially zero
    # the constant P and A never enter the autograd graph
    for c in lt._shared_consts[torch.float64]:
        assert not c.requires_grad and c.grad is None


def test_infeasible_lane_is_certified_by_the_shared_phase(jax_capped):
    # lane 2 asks for sum x = t above sum u: primal infeasible
    vals = capped_values(seed=4, infeasible_lane=2)
    _, (_, sj, ij) = _ref(jax_capped, vals)
    lt, _, _, _, st, it = _port(vals)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert st.tolist() == [SOLVED, SOLVED, PRIMAL_INFEASIBLE, SOLVED]
    # the verdict comes from the shared phase (the polish sees residuals
    # only): run that phase alone on the same data
    st_ = lt._base_settings
    p_ext = lt._stack_params([torch.as_tensor(a) for a in vals], _B,
                             [True] * 3)
    q, b, _ = lt._assemble_qb(p_ext)
    zeros = [q.new_zeros(_B, lt.prog.n)] + [b.new_zeros(_B, lt.prog.m)] * 2
    res = lt._shared_solver(st_)(q, b, *zeros)
    assert int(res.status[2]) == PRIMAL_INFEASIBLE
    with pytest.raises(ct.SolverError, match="infeasible"):
        lt(*(torch.as_tensor(a) for a in vals))


def test_warm_start_matches_reference(jax_capped):
    vals = capped_values(seed=5)
    lt, _, _, ws, _, it_cold = _port(vals)
    # the cold solution as the warm start of perturbed data
    warm = tuple(np.asarray(w) for w in ws)
    vals[0] = vals[0] + 0.01
    _, ref = _ref(jax_capped, vals, warm=warm)
    got = _port(vals, layer=lt, warm_start=ct.WarmStart.from_numpy(
        *warm, device="cpu", dtype=torch.float64))
    _assert_same(ref, got[2:3] + got[4:])
    assert int(got[5].max()) < int(it_cold.max())


def test_eager_warm_start_cache_on_the_shared_route():
    vals = [torch.as_tensor(a) for a in capped_values(seed=6)]
    lt = capped_simplex(ct, device="cpu")
    _, _, it1 = lt.solve_with_info(*vals, warm_start=True)
    assert isinstance(lt._warm, ct.WarmStart)
    vals[0] = vals[0] + 0.01
    outs, st, it2 = lt.solve_with_info(*vals, warm_start=True)
    assert (st == SOLVED).all()
    assert int(it2.max()) < int(it1.max())
    cold, _, _ = capped_simplex(ct, device="cpu").solve_with_info(*vals)
    np.testing.assert_allclose(outs[0].numpy(), cold[0].numpy(), atol=1e-7)


def test_f32_call_solves_every_lane(jax_capped):
    vals = capped_values(seed=0)
    _, (oj, _, _) = _ref(jax_capped, vals)
    lt = capped_simplex(ct, device="cpu")
    args = {"eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-3,
            "admm_eps_rel": 1e-3}
    before = cuda_admm.LAUNCHES
    outs, st, _ = lt.solve_with_info(
        *(torch.as_tensor(a, dtype=torch.float32) for a in vals),
        solver_args=args)
    assert cuda_admm.LAUNCHES == before
    assert lt._use_shared(lt._base_settings)
    assert outs[0].dtype == torch.float32
    assert (st == SOLVED).all(), st
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(oj[0]),
                               atol=1e-3)


def test_shared_setup_on_and_off():
    vals = [torch.as_tensor(a) for a in capped_values(seed=7)]
    lt = capped_simplex(ct, device="cpu")
    auto = lt.solve_with_info(*vals)
    on = lt.solve_with_info(*vals, solver_args={"shared_setup": "on"})
    for a, b in zip(auto[0] + auto[1:], on[0] + on[1:]):
        assert torch.equal(a, b)
    # "off" takes the dense per-instance route: other iterates, the same
    # solution
    assert not lt._use_shared(lt._base_settings.replace(shared_setup="off"))
    off = lt.solve_with_info(*vals, solver_args={"shared_setup": "off"})
    assert (off[1] == SOLVED).all()
    for a, b in zip(auto[0], off[0]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


def test_shared_setup_on_raises_where_the_reference_raises():
    r = np.random.default_rng(8)
    vals = [r.standard_normal((2, _N)), r.standard_normal((2, 3, _N)),
            np.ones((2, 3))]
    msgs = []
    for mod, conv in ((cj, jnp.asarray), (ct, torch.as_tensor)):
        kw = {} if mod is cj else {"device": "cpu"}
        layer = box_qp(mod, **kw)  # A holds the parameter G
        assert not layer._pa_constant
        with pytest.raises(ValueError) as err:
            layer.solve_with_info(*(conv(a) for a in vals),
                                  solver_args={"shared_setup": "on"})
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "parameter-independent P and A" in msgs[1]
    # constant P and A but another solve method: also refused
    lt = capped_simplex(ct, device="cpu")
    with pytest.raises(ValueError, match="solve_method='admm'"):
        lt(*(torch.as_tensor(a) for a in capped_values()),
           solver_args={"shared_setup": "on", "solve_method": "ipm"})


def test_constant_detection_matches_reference():
    def no_constraints(mod, **kw):
        x = mod.Variable(3)
        v = mod.Parameter(3)
        prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)))
        return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)

    for build, want in ((simplex, True), (capped_simplex, True),
                        (box_qp, False), (no_constraints, False)):
        lj = build(cj)
        lt = build(ct, device="cpu")
        assert lt._pa_constant == lj._pa_constant == want, build.__name__


def test_admm_with_no_iterations_hands_the_warm_start_through(monkeypatch):
    # the shared route's polish runs the dense ADMM with max_iters=0 and
    # scaling_iters=0: no epoch, no K1 launch, and the warm start comes
    # back as the reference's while_loop gives it back
    r = np.random.default_rng(9)
    B, n, m = 3, 4, 5
    P = np.broadcast_to(np.eye(n), (B, n, n)).copy()
    A = r.standard_normal((B, m, n))
    args = [P, r.standard_normal((B, n)), A, r.standard_normal((B, m)),
            r.standard_normal((B, n)), np.abs(r.standard_normal((B, m))),
            np.abs(r.standard_normal((B, m)))]
    kw = {"max_iters": 0, "scaling_iters": 0}
    jr = jax.jit(jax.vmap(j_admm(JDims(nonneg=m), n,
                                 JSettings().replace(**kw))))(
        *(jnp.asarray(a) for a in args))
    calls = []
    monkeypatch.setattr(admm_module, "polyhedral_inner_epoch",
                        lambda *a, **k: calls.append(1))
    tr = t_admm(TDims(nonneg=m), n, TSettings().replace(**kw))(
        *(torch.as_tensor(a) for a in args))
    assert calls == []
    assert tr.iters.tolist() == [0] * B
    assert tr.status.tolist() == [MAX_ITERS] * B
    np.testing.assert_array_equal(tr.x.numpy(), args[4])
    np.testing.assert_array_equal(tr.y.numpy(), args[5])
    for f in ("x", "y", "s"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)))
    np.testing.assert_allclose(tr.s.numpy(), args[6], atol=1e-15)
