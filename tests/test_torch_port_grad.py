"""The port's layer as a whole: gradients through CvxpyLayer, the
interior-point route through the layer, and the eager warm-start cache,
against the reference.

The same problems, built in both DSLs and fed the same numpy-seeded
parameters, go through the reference layer (jax.grad) and the port's
layer (autograd) on the CPU in f64. Both polish to ~1e-8 KKT residuals
and solve the same transposed KKT system exactly, so gradients agree to
1e-6, the bound the layer tests use for the solutions themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu_torch.solver import cuda_admm, cuda_linalg

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-6
_N, _M_INEQ, _B = 6, 3, 3


def box_qp(mod, n=_N, m_ineq=_M_INEQ, **kw):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    G = mod.Parameter((m_ineq, n))
    h = mod.Parameter(m_ineq)
    ineq = G @ x <= h
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [ineq, x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v, G, h],
                          variables=[x, ineq.dual_variables[0]], **kw)


def box_qp_values(B=_B, n=_N, m_ineq=_M_INEQ, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, n)),
            r.standard_normal((B, m_ineq, n)) * 0.3,
            np.abs(r.standard_normal((B, m_ineq))) * 0.3 + 0.1]


def lad(mod, n=2, m=3, **kw):
    x = mod.Variable(n)
    A = mod.Parameter((m, n))
    b = mod.Parameter(m)
    prob = mod.Problem(mod.Minimize(0.5 * mod.pnorm(A @ x - b, p=1)),
                       [x >= 0])
    return mod.CvxpyLayer(prob, parameters=[A, b], variables=[x], **kw)


@pytest.fixture(scope="module")
def jax_box_qp():
    """One reference layer for the module: its jitted cores are cached
    per settings, so each route compiles once."""
    return box_qp(cj)


@pytest.fixture(scope="module")
def loss_weights():
    r = np.random.default_rng(99)
    return r.standard_normal((_B, _N)), r.standard_normal((_B, _M_INEQ))


@pytest.mark.parametrize("method", ["admm", "ipm"])
def test_layer_and_gradients_match_reference(method, jax_box_qp,
                                             loss_weights):
    vals = box_qp_values()
    args = {"solve_method": method}
    wx, wd = loss_weights

    def j_loss(v, G, h):
        outs, status, iters = jax_box_qp.solve_with_info(v, G, h,
                                                         solver_args=args)
        x, d = outs
        return jnp.sum(x * wx) + jnp.sum(d * wd), (outs, status, iters)

    # one trace serves the forward comparison and the gradient
    gj, (oj, sj, ij) = jax.grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in vals))

    lt = box_qp(ct, device="cpu")
    tin = [torch.as_tensor(a).requires_grad_() for a in vals]
    k1, k2 = cuda_admm.LAUNCHES, cuda_linalg.LAUNCHES
    (x, d), st, it = lt.solve_with_info(*tin, solver_args=args)
    loss = (x * torch.as_tensor(wx)).sum() + (d * torch.as_tensor(wd)).sum()
    loss.backward()
    assert (cuda_admm.LAUNCHES, cuda_linalg.LAUNCHES) == (k1, k2)

    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (st == 0).all()
    for a, b in zip(oj, (x, d)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=_ATOL, rtol=0)
    for g, t in zip(gj, tin):
        assert t.grad is not None and tuple(t.grad.shape) == tuple(g.shape)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=_ATOL, rtol=0)
    assert float(tin[0].grad.abs().max()) > 1e-3  # not trivially zero
    assert not st.requires_grad and not it.requires_grad


@pytest.mark.parametrize("method", ["admm", "ipm"])
def test_gradcheck_three_variable_qp(method):
    x = ct.Variable(3)
    c = ct.Parameter(3)
    G = ct.Parameter((2, 3))
    h = ct.Parameter(2)
    F = ct.Parameter((1, 3))
    g = ct.Parameter(1)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x) + c @ x),
                      [G @ x <= h, F @ x == g])
    layer = ct.CvxpyLayer(prob, parameters=[c, G, h, F, g], variables=[x],
                          device="cpu",
                          solver_args={"solve_method": method,
                                       "refine_steps": 3})
    r = np.random.default_rng(5)
    inputs = [torch.as_tensor(a).requires_grad_() for a in (
        r.standard_normal(3), r.standard_normal((2, 3)),
        np.abs(r.standard_normal(2)) * 0.2, r.standard_normal((1, 3)),
        r.standard_normal(1) * 0.1)]
    # the solve is exact to ~1e-9 after the polish, so central differences
    # at 1e-6 resolve the Jacobian to ~1e-4 relative; no active-set change
    # within that step at this seed
    assert torch.autograd.gradcheck(lambda *p: layer(*p)[0], inputs,
                                    eps=1e-6, atol=1e-5, rtol=1e-4)


def test_unbatched_and_partial_gradients():
    # only h requires grad; v and G are plain tensors, G unbatched
    layer = box_qp(ct, device="cpu")
    v, G, h = (torch.as_tensor(a) for a in box_qp_values(seed=2))
    h = h.requires_grad_()
    x, _ = layer(v, G[0], h)
    x.sum().backward()
    assert v.grad is None and G.grad is None
    assert tuple(h.grad.shape) == tuple(h.shape)
    assert bool(torch.isfinite(h.grad).all())
    # one instance alone gives the same gradient as its lane of the batch
    h1 = h[1].detach().clone().requires_grad_()
    x1, _ = layer(v[1], G[0], h1)
    x1.sum().backward()
    np.testing.assert_allclose(h1.grad.numpy(), h.grad[1].numpy(),
                               atol=1e-9)


def test_failed_lane_gets_zero_gradient_others_keep_theirs():
    layer = box_qp(ct, device="cpu")
    vals = box_qp_values(seed=3)
    args = {"solve_method": "ipm"}  # a NaN lane stalls out in 3 iterations
    good = [torch.as_tensor(a).requires_grad_() for a in vals]
    (x, _), st, _ = layer.solve_with_info(*good, solver_args=args)
    x.sum().backward()
    assert (st == 0).all()

    vals_bad = [a.copy() for a in vals]
    vals_bad[0][1] = np.nan  # lane 1 has no solution: its solve is NaN
    bad = [torch.as_tensor(a).requires_grad_() for a in vals_bad]
    (xb, _), stb, _ = layer.solve_with_info(*bad, solver_args=args)
    assert stb[1] != 0 and stb[0] == 0 and stb[2] == 0
    xb[[0, 2]].sum().backward()
    for g_bad, g_good in zip(bad, good):
        assert bool(torch.isfinite(g_bad.grad).all())
        assert float(g_bad.grad[1].abs().max()) == 0.0
        np.testing.assert_allclose(g_bad.grad[[0, 2]].numpy(),
                                   g_good.grad[[0, 2]].numpy(), atol=1e-9)


def test_eager_warm_start_cache_matches_reference(jax_box_qp):
    vals = box_qp_values(seed=4)
    kw = {"epoch": 5}
    lt = box_qp(ct, device="cpu")
    jin = [jnp.asarray(a) for a in vals]
    tin = [torch.as_tensor(a) for a in vals]
    jax_box_qp._warm = None
    _, s1j, i1j = jax_box_qp.solve_with_info(*jin, solver_args=kw,
                                             warm_start=True)
    _, s1t, i1t = lt.solve_with_info(*tin, solver_args=kw, warm_start=True)
    np.testing.assert_array_equal(i1t.numpy(), np.asarray(i1j))
    assert isinstance(lt._warm, ct.WarmStart)
    assert not lt._warm.x.requires_grad
    # second call, perturbed parameters: both start from their caches
    jin[0] = jin[0] + 0.01
    tin[0] = tin[0] + 0.01
    oj, s2j, i2j = jax_box_qp.solve_with_info(*jin, solver_args=kw,
                                              warm_start=True)
    ot, s2t, i2t = lt.solve_with_info(*tin, solver_args=kw, warm_start=True)
    np.testing.assert_array_equal(s2t.numpy(), np.asarray(s2j))
    np.testing.assert_array_equal(i2t.numpy(), np.asarray(i2j))
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=_ATOL,
                               rtol=0)
    assert int(i2t.max()) < int(i1t.max())  # the cache was used
    # a cache of another batch size is ignored, not an error
    o1, _, _ = lt.solve_with_info(*(t[:2] for t in tin), solver_args=kw,
                                  warm_start=True)
    assert tuple(o1[0].shape) == (2, _N)
    jax_box_qp._warm = None


def test_layer_ipm_on_lp_needs_primal_dual_mode():
    r = np.random.default_rng(6)
    vals = [r.standard_normal((3, 3, 2)), r.standard_normal((3, 3))]
    lt = lad(ct, device="cpu")
    tin = [torch.as_tensor(a) for a in vals]
    # ipm_mode="auto" on an LP is the self-dual embedding in both
    # packages; the primal-dual form is asked for by name
    lj = lad(cj)
    for args in ({"solve_method": "ipm"},
                 {"solve_method": "ipm", "ipm_mode": "pd"}):
        oj, sj, ij = lj.solve_with_info(*(jnp.asarray(a) for a in vals),
                                        solver_args=args)
        ot, st, it = lt.solve_with_info(*tin, solver_args=args)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]),
                                   atol=_ATOL, rtol=0)


def _simplex(**kw):
    x = ct.Variable(4)
    v = ct.Parameter(4)
    eq = ct.sum(x) == 1
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x - v)), [eq, x >= 0])
    return ct.CvxpyLayer(prob, parameters=[v],
                         variables=[x, eq.dual_variables[0]], device="cpu",
                         **kw)


@pytest.mark.parametrize("method", ["admm", "ipm"])
def test_gradcheck_simplex_projection_with_its_dual(method):
    # v puts two coordinates strictly inside and two strictly at zero, so
    # the active set holds within the finite-difference step
    layer = _simplex(solver_args={"solve_method": method,
                                  "refine_steps": 3})
    v = torch.tensor([0.9, 0.4, -0.6, -1.1], dtype=torch.float64,
                     requires_grad=True)
    x, _ = layer(v)
    assert (x.detach() > 1e-3).sum() == 2
    assert torch.autograd.gradcheck(lambda p: layer(p), [v], eps=1e-6,
                                    atol=1e-5, rtol=1e-4)


def test_gradcheck_box_qp_dual_output():
    # the gradient of a constraint's dual variable alone
    layer = box_qp(ct, n=3, m_ineq=2, device="cpu",
                   solver_args={"refine_steps": 3})
    # the first row is active with every x strictly inside its box, the
    # second is slack: strict complementarity, so the dual is smooth here
    v = torch.tensor([0.8, 0.5, 0.3], dtype=torch.float64,
                     requires_grad=True)
    G = torch.tensor([[1.0, 1.0, 1.0], [1.0, -1.0, 0.0]],
                     dtype=torch.float64, requires_grad=True)
    h = torch.tensor([0.9, 0.5], dtype=torch.float64, requires_grad=True)
    x, d = layer(v, G, h)
    assert float(x.detach().min()) > 0.05 and float(x.detach().max()) < 0.95
    assert float(d.detach()[0]) > 0.1 and float(d.detach()[1]) < 1e-9
    assert torch.autograd.gradcheck(lambda *p: layer(*p)[1], [v, G, h],
                                    eps=1e-6, atol=1e-5, rtol=1e-4)


def test_admm_and_ipm_gradients_agree():
    layer = box_qp(ct, device="cpu")
    vals = box_qp_values(seed=9)
    grads = {}
    for method in ("admm", "ipm"):
        tin = [torch.as_tensor(a).requires_grad_() for a in vals]
        x, d = layer(*tin, solver_args={"solve_method": method})
        (x.square().sum() + d.sum()).backward()
        grads[method] = [t.grad.numpy() for t in tin]
    for a, b in zip(grads["admm"], grads["ipm"]):
        np.testing.assert_allclose(b, a, atol=_ATOL, rtol=0)
    assert np.abs(grads["admm"][2]).max() > 1e-3


def test_no_graph_without_a_differentiable_input():
    layer = box_qp(ct, device="cpu")
    vals = [torch.as_tensor(a) for a in box_qp_values(seed=10)]
    x, d = layer(*vals)
    assert not x.requires_grad and x.grad_fn is None and d.grad_fn is None
    vals[0].requires_grad_()
    with torch.no_grad():
        x_ng, _ = layer(*vals)
    assert not x_ng.requires_grad
    np.testing.assert_array_equal(x_ng.numpy(), x.numpy())
    # the outputs of a differentiable call can be differentiated twice over
    # only up to first order: the adjoint is not itself recorded
    x2, _ = layer(*vals)
    (g,) = torch.autograd.grad(x2.sum(), vals[0], create_graph=True)
    assert not g.requires_grad
