"""The port's whole slice: CvxpyLayer(...)(*params) against the reference.

The same problems, built in both DSLs and fed the same numpy-seeded
parameters, go through the reference layer and the port's layer on the
CPU in f64. Statuses must be equal, and outputs and duals agree to 1e-6
(both polish to ~1e-8 KKT residuals, so 1e-6 bounds solution noise with
margin). Also covers the batching contract, the warm-start carry-across,
an f32 run, and the device and gradient contracts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu_torch.solver import cuda_admm

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-6


def box_qp(mod, n=8, m_ineq=4, **kw):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    G = mod.Parameter((m_ineq, n))
    h = mod.Parameter(m_ineq)
    ineq = G @ x <= h
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [ineq, x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v, G, h],
                          variables=[x, ineq.dual_variables[0]], **kw)


def box_qp_values(B, n=8, m_ineq=4, seed=0, dtype=np.float64):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, n)).astype(dtype),
            (r.standard_normal((B, m_ineq, n)) * 0.3).astype(dtype),
            (np.abs(r.standard_normal((B, m_ineq))) + 1.0).astype(dtype)]


def simplex(mod, n=6, **kw):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    eq = mod.sum(x) == 1
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)), [eq, x >= 0])
    return mod.CvxpyLayer(prob, parameters=[v],
                          variables=[x, eq.dual_variables[0]], **kw)


def lad(mod, n=2, m=3, **kw):
    x = mod.Variable(n)
    A = mod.Parameter((m, n))
    b = mod.Parameter(m)
    nonneg = x >= 0
    prob = mod.Problem(mod.Minimize(0.5 * mod.pnorm(A @ x - b, p=1)),
                       [nonneg])
    return mod.CvxpyLayer(prob, parameters=[A, b],
                          variables=[x, nonneg.dual_variables[0]], **kw)


def _both(build, vals, jax_args=None, torch_args=None):
    lj = build(cj)
    lt = build(ct, device="cpu")
    oj, sj, ij = lj.solve_with_info(*(jnp.asarray(v) for v in vals),
                                    solver_args=jax_args)
    ot, st, it = lt.solve_with_info(*(torch.as_tensor(v) for v in vals),
                                    solver_args=torch_args)
    return (oj, sj, ij), (ot, st, it)


def _assert_match(ref, got):
    (oj, sj, ij), (ot, st, it) = ref, got
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert len(oj) == len(ot)
    for a, b in zip(oj, ot):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=_ATOL,
                                   rtol=0)


def test_box_qp_matches_reference():
    ref, got = _both(box_qp, box_qp_values(4))
    _assert_match(ref, got)
    assert (got[1] == 0).all()


def test_simplex_matches_reference():
    vals = [np.random.default_rng(1).standard_normal((5, 6))]
    # P and A are constant: both packages take the shared route by default
    ref, got = _both(simplex, vals)
    _assert_match(ref, got)
    np.testing.assert_allclose(got[0][0].sum(dim=1).numpy(), 1.0, atol=1e-8)


def test_lad_matches_reference():
    r = np.random.default_rng(2)
    vals = [r.standard_normal((6, 3, 2)), r.standard_normal((6, 3))]
    ref, got = _both(lad, vals)
    _assert_match(ref, got)


def test_infeasible_batch_raises_solver_error():
    def build(mod, **kw):
        x = mod.Variable(2)
        a = mod.Parameter(2)
        prob = mod.Problem(mod.Minimize(mod.sum_squares(x)),
                           [x >= a, x <= 0])
        return mod.CvxpyLayer(prob, parameters=[a], variables=[x], **kw)

    vals = [np.array([[-1.0, -1.0], [1.0, 1.0]])]  # lane 1 is infeasible
    ref, got = _both(build, vals)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[1].tolist() == [0, ct.solver.settings.PRIMAL_INFEASIBLE]
    layer = build(ct, device="cpu")
    with pytest.raises(ct.SolverError, match="infeasible"):
        layer(torch.as_tensor(vals[0]))


def test_batching_contract():
    layer = box_qp(ct, device="cpu")
    v, G, h = (torch.as_tensor(a) for a in box_qp_values(3, seed=3))
    # unbatched in, unbatched out
    x0, d0 = layer(v[0], G[0], h[0])
    assert x0.shape == (8,) and d0.shape == (4,)
    # mixed batched/unbatched: the unbatched ones broadcast
    xb, _ = layer(v, G[0], h[0])
    assert xb.shape == (3, 8)
    np.testing.assert_allclose(xb[0].numpy(), x0.numpy(), atol=1e-9)
    # batch size 1 is preserved, not squeezed
    x1, _ = layer(v[:1], G[:1], h[:1])
    assert x1.shape == (1, 8)
    with pytest.raises(ValueError, match="inconsistent batch"):
        layer(v, G[:2], h)
    with pytest.raises(ValueError, match="expects shape"):
        layer(v[:, :5], G, h)
    with pytest.raises(ValueError, match="expected 3 parameters"):
        layer(v, G)


def test_warm_start_carries_across():
    vals = box_qp_values(4, seed=4)
    kw = {"epoch": 5}
    lj = box_qp(cj)
    lt = box_qp(ct, device="cpu")
    jin = [jnp.asarray(a) for a in vals]
    tin = [torch.as_tensor(a) for a in vals]
    _, ws_j, _, _ = lj.solve_and_state(*jin, solver_args=kw)
    ws_t = ct.WarmStart.from_numpy(
        np.asarray(ws_j.x), np.asarray(ws_j.y), np.asarray(ws_j.s),
        device="cpu", dtype=torch.float64,
    )
    # perturbed parameters: the warm start is near, not at, the solution
    jin[0] = jin[0] + 0.01
    tin[0] = tin[0] + 0.01
    oj, _, sj, ij = lj.solve_and_state(*jin, solver_args=kw, warm_start=ws_j)
    ot, ws_next, st, it = lt.solve_and_state(*tin, solver_args=kw,
                                             warm_start=ws_t)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=_ATOL,
                               rtol=0)
    assert isinstance(ws_next, ct.WarmStart)
    assert ws_next.x.shape == (4, lt.prog.n)
    # warm_start=True keeps the solution on the layer for the next call
    assert lt._warm is None
    lt(*tin, warm_start=True)
    assert isinstance(lt._warm, ct.WarmStart)
    assert lt._warm.x.shape == (4, lt.prog.n)


def test_f32_box_qp_solves_every_lane():
    layer = box_qp(ct, device="cpu")
    vals = [torch.as_tensor(a) for a in
            box_qp_values(16, seed=5, dtype=np.float32)]
    args = {"eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-3,
            "admm_eps_rel": 1e-3, "max_iters": 200}
    before = cuda_admm.LAUNCHES
    (x, _), status, _ = layer.solve_with_info(*vals, solver_args=args)
    assert cuda_admm.LAUNCHES == before  # CPU tensors run the plain version
    assert x.dtype == torch.float32
    assert (status == 0).all(), status
    ref = layer.solve_with_info(*(v.double() for v in vals))[0][0]
    np.testing.assert_allclose(x.numpy(), ref.numpy(), atol=1e-3)


def test_device_and_gradient_contracts(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        box_qp(ct)
    layer = box_qp(ct, device="cpu")
    v, G, h = (torch.as_tensor(a) for a in box_qp_values(2, seed=6))
    with pytest.raises(ValueError, match="is on meta"):
        layer(v.to("meta"), G, h)
    # an input that requires grad gets one; the statuses carry none
    (x, _), status, _ = layer.solve_with_info(v.requires_grad_(), G, h)
    assert x.requires_grad and not status.requires_grad
    x.sum().backward()
    assert tuple(v.grad.shape) == tuple(v.shape)
    assert bool(torch.isfinite(v.grad).all())
    with pytest.raises(TypeError, match="torch.Tensor"):
        layer(np.zeros(8), G[0], h[0])
    with pytest.raises(NotImplementedError, match="later port slice"):
        layer(v.detach(), G, h, solver_args={"assembly": "sparse"})


_ROUTE_CASES = {
    "box_qp": (box_qp, lambda: box_qp_values(3, seed=7), {}),
    "simplex": (simplex,
                lambda: [np.random.default_rng(8).standard_normal((3, 6))],
                {}),
    # an LP: the interior-point route takes the self-dual embedding
    "lad": (lad, lambda: [np.random.default_rng(9).standard_normal((3, 3, 2)),
                          np.random.default_rng(10).standard_normal((3, 3))],
            {}),
}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_admm_and_ipm_routes_agree(case):
    # two solvers, one polish: both routes of the port land on the same
    # primal and dual solution
    build, values, ipm_args = _ROUTE_CASES[case]
    layer = build(ct, device="cpu")
    vals = [torch.as_tensor(a) for a in values()]
    oa, sa, _ = layer.solve_with_info(*vals)
    oi, si, ii = layer.solve_with_info(
        *vals, solver_args={"solve_method": "ipm", **ipm_args})
    assert (sa == 0).all() and (si == 0).all()
    assert int(ii.max()) < 30
    for a, b in zip(oa, oi):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=_ATOL, rtol=0)


def test_solver_args_are_checked():
    layer = simplex(ct, device="cpu")
    v = torch.as_tensor(np.random.default_rng(11).standard_normal(6))
    with pytest.raises(ValueError, match="unknown solver_args key"):
        layer(v, solver_args={"no_such_option": 1})
    with pytest.raises(NotImplementedError, match="'admm'"):
        layer(v, solver_args={"solve_method": "pdhg"})
    with pytest.raises(NotImplementedError, match="derivative='adjoint'"):
        layer(v, solver_args={"derivative": "forward"})
    # arguments given at construction are the defaults of every call, and
    # a call's own arguments override them
    strict = simplex(ct, device="cpu", solver_args={"max_iters": 1,
                                                    "refine_steps": 0})
    with pytest.raises(ct.SolverError):
        strict(v)
    x, _ = strict(v, solver_args={"max_iters": 2000, "refine_steps": 4})
    np.testing.assert_allclose(x.numpy(), layer(v)[0].numpy(), atol=_ATOL)


def test_warm_start_from_numpy_round_trip():
    r = np.random.default_rng(12)
    x, y, s = (r.standard_normal((2, k)).astype(np.float32)
               for k in (3, 5, 5))
    ws = ct.WarmStart.from_numpy(x, y, s, device="cpu", dtype=torch.float64)
    for t, a in zip((ws.x, ws.y, ws.s), (x, y, s)):
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), a.astype(np.float64))
    x[0, 0] = 99.0  # a copy, not a view of the host array
    assert float(ws.x[0, 0]) != 99.0
