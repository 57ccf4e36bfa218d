"""The port's recovery of cone duals against the reference.

layer/cvxpylayer.py::_recover maps each requested dual out of the
solver's dual iterate y: a zero or nonneg dual in its constraint's
shape, a PSD dual as the symmetric matrix, an SOC dual as the scalar
t-part (part 0) and the X-shaped rest (part 1), an exponential or power
cone dual as the x, y or z component of its interleaved triples in the
argument's shape; every part keeps the batch axis of a batched call and
carries the gradient. The cases are those of tests/test_dual_structure.py
(the SOC closed form, batched shapes, exp and pow parts, every cone
active at once) plus a 3x3 PSD dual, built in both DSLs.

Three kinds of check, at f64 on the CPU:
- the reference layer against the port end to end (outputs within 1e-8,
  gradients of a seeded weighting of every part within 1e-6), on the SOC
  and PSD layers, one jitted value-and-gradient each;
- the reference's own _recover applied to the port's raw iterates, on
  every route and solve method (shapes equal, values within 1e-8), and
  the vector-Jacobian product of each part against jax.vjp of it;
- closed forms and identities that need no reference: the exp duals of
  test_dual_structure.py, dual-cone membership, and on the every-cone
  layer the envelope identity d f*/d offset = -dual, read from the
  port's own adjoint.

The exponential- and power-cone layers are compared through _recover
only: one reference compile of such a layer takes 30-45 s on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-8
_GRAD_ATOL = 1e-6
_EPS = {"eps": 1e-9}


def _soc_layer(pk, **kw):
    """test_dual_structure.py's SOC closed form: min -v'x, ||x|| <= 1."""
    x = pk.Variable(4)
    v = pk.Parameter(4)
    con = pk.SOC(pk.Constant(1.0), x)
    return pk.CvxpyLayer(
        pk.Problem(pk.Minimize(-(v @ x)), [con]), parameters=[v],
        variables=[x, con.dual_variables[0], con.dual_variables[1]], **kw)


def _psd_layer(pk, **kw):
    """The nearest PSD matrix to C: the dual is a 3x3 matrix."""
    X = pk.Variable((3, 3))
    C = pk.Parameter((3, 3))
    con = X >> 0
    return pk.CvxpyLayer(
        pk.Problem(pk.Minimize(pk.sum_squares(X - C)), [con]),
        parameters=[C], variables=[X, con.dual_variables[0]], **kw)


def _soc_batched_layer(pk, **kw):
    x = pk.Variable(3)
    v = pk.Parameter(3)
    con = pk.SOC(pk.Constant(1.0), x)
    return pk.CvxpyLayer(
        pk.Problem(pk.Minimize(pk.sum_squares(x - v)), [con]),
        parameters=[v],
        variables=[con.dual_variables[0], con.dual_variables[1]], **kw)


def _exp_layer(pk, **kw):
    """min z s.t. (a, 1, z) in Kexp: z* = e^a, duals (-e^a, (a-1)e^a, 1)."""
    z = pk.Variable(())
    a = pk.Parameter(())
    con = pk.ExpCone(a, pk.Constant(1.0), z)
    return pk.CvxpyLayer(pk.Problem(pk.Minimize(z), [con]), parameters=[a],
                         variables=[z] + list(con.dual_variables), **kw)


def _exp_vector_layer(pk, **kw):
    zv = pk.Variable(3)
    av = pk.Parameter(3)
    con = pk.ExpCone(av, pk.Constant(np.ones(3)), zv)
    return pk.CvxpyLayer(pk.Problem(pk.Minimize(pk.sum(zv)), [con]),
                         parameters=[av], variables=list(con.dual_variables),
                         **kw)


def _pow_layer(pk, **kw):
    z = pk.Variable(())
    a = pk.Parameter(())
    con = pk.PowCone3D(a, pk.Constant(1.5), z, 0.4)
    return pk.CvxpyLayer(pk.Problem(pk.Maximize(z), [con]), parameters=[a],
                         variables=[z] + list(con.dual_variables), **kw)


_EVERY_KEYS = ("e", "r", "m", "pz", "po", "pw")


def _every_layer(pk, **kw):
    """test_dual_structure.py's every-cone layer: zero, nonneg, SOC, exp,
    PSD and pow constraints on one variable, each with an offset."""
    x = pk.Variable(5)
    v = pk.Parameter(5)
    e, r, m, pz, po, pw = (pk.Parameter(()) for _ in _EVERY_KEYS)
    cons = [
        pk.sum(x) == e,
        x[:4] >= m,
        pk.SOC(r, x[:3]),
        pk.ExpCone(x[0] - 1.0, pk.Constant(1.0), x[3] + pz),
        pk.PSD(pk.bmat([[x[2] + 3.0 + po, x[3]], [x[3], x[0] + 3.0]])),
        pk.PowCone3D(x[1] + 2.0 + pw, x[2] + 2.0, x[4], 0.6),
    ]
    duals = [d for c in cons for d in c.dual_variables]
    return pk.CvxpyLayer(
        pk.Problem(pk.Minimize(pk.sum_squares(x - v)), cons),
        parameters=[v, e, r, m, pz, po, pw], variables=[x] + duals, **kw)


_EVERY = {
    "soc_exp_psd_pow": (np.array([1.5, -2.0, 0.8, 1.0, -4.0]),
                        dict(e=0.7, r=0.5, m=-0.5, pz=-0.5, po=-3.0,
                             pw=-1.8)),
    "eq_nonneg_exp": (np.array([1.5, -2.0, 0.8, 1.0, -0.5]),
                      dict(e=0.7, r=1.5, m=-0.35, pz=-0.55, po=0.0,
                           pw=0.0)),
}


def _every_args(case):
    vv, th = _EVERY[case]
    return [vv] + [np.float64(th[k]) for k in _EVERY_KEYS]


def _tensors(arrs, grad=False):
    return [torch.tensor(np.asarray(a, dtype=np.float64), requires_grad=grad)
            for a in arrs]


def _weights(outs, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(tuple(o.shape)) for o in outs]


def _run(layer, arrs, args=None, grad=True):
    """The port's call through solve_and_state: (outputs, raw x, raw y,
    status, parameter tensors)."""
    params = _tensors(arrs, grad=grad)
    outs, ws, status, _ = layer.solve_and_state(
        *params, solver_args=dict(_EPS, **(args or {})))
    return outs, ws.x.numpy(), ws.y.numpy(), status, params


def _ref_recover(rlayer, x, y):
    return [np.asarray(o) for o in
            jax.vmap(rlayer._recover)(jnp.asarray(x), jnp.asarray(y))]


def _check_against_ref_recover(rlayer, outs, x, y, batched):
    """The port's outputs equal the reference's _recover of the port's
    own raw iterates: shape and value."""
    want = _ref_recover(rlayer, x, y)
    if not batched:
        want = [w[0] for w in want]
    assert len(outs) == len(want)
    for got, w in zip(outs, want):
        assert tuple(got.shape) == w.shape
        np.testing.assert_allclose(got.detach().numpy(), w, atol=_ATOL,
                                   rtol=0)
    return want


@pytest.fixture(scope="module")
def ref_layers():
    """Reference layers (no solve: _recover needs only the program)."""
    return {name: build(cj) for name, build in (
        ("soc", _soc_layer), ("psd", _psd_layer),
        ("soc_batched", _soc_batched_layer), ("exp", _exp_layer),
        ("exp_vector", _exp_vector_layer), ("pow", _pow_layer),
        ("every", _every_layer))}


def _ref_value_and_grad(rlayer, arrs, weights):
    """One jitted reference value-and-gradient of a seeded weighting of
    every part."""
    def loss(*params):
        outs = rlayer(*params, solver_args=_EPS)
        return sum(jnp.sum(jnp.asarray(w) * o)
                   for w, o in zip(weights, outs)), outs

    grads, outs = jax.jit(jax.grad(
        loss, argnums=tuple(range(len(arrs))), has_aux=True))(
        *(jnp.asarray(a) for a in arrs))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_grads(outs, weights, params):
    loss = sum((torch.as_tensor(w) * o).sum() for w, o in zip(weights, outs))
    loss.backward()
    return [p.grad.numpy() for p in params]


_R = np.random.default_rng(13)
_SOC_V = _R.standard_normal(4)
_SOC_V5 = _R.standard_normal((5, 3)) * 2
_PSD_C = _R.standard_normal((2, 3, 3))


@pytest.fixture(scope="module")
def soc_ref():
    """The reference SOC layer, unbatched, end to end."""
    w = _weights([np.zeros(4), np.zeros(()), np.zeros(4)], 1)
    return w, _ref_value_and_grad(_soc_layer(cj), [_SOC_V], w)


@pytest.fixture(scope="module")
def psd_ref():
    """The reference PSD layer, batched over two C, end to end."""
    w = _weights([np.zeros((2, 3, 3))] * 2, 2)
    return w, _ref_value_and_grad(_psd_layer(cj), [_PSD_C], w)


def test_soc_parts_match_reference_layer(soc_ref, ref_layers):
    """The scalar t-dual and the x-shaped dual, end to end, with the
    closed form of test_dual_structure.py: ||dual_x|| <= dual_t =
    ||v||."""
    w, (want, want_g) = soc_ref
    layer = _soc_layer(ct, device="cpu")
    outs, x, y, status, params = _run(layer, [_SOC_V])
    assert int(status) == 0
    for got, ref in zip(outs, want):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=_ATOL,
                                   rtol=0)
    _check_against_ref_recover(ref_layers["soc"], outs, x, y, False)
    np.testing.assert_allclose(outs[1].item(), np.linalg.norm(_SOC_V),
                               atol=1e-6)
    assert float(outs[2].norm()) <= float(outs[1]) + 1e-7
    for g, ref in zip(_port_grads(outs, w, params), want_g):
        np.testing.assert_allclose(g, ref, atol=_GRAD_ATOL, rtol=0)


def test_psd_dual_is_the_symmetric_matrix_of_the_reference(psd_ref,
                                                           ref_layers):
    """A 3x3 PSD dual comes back as (B, 3, 3), not its svec (B, 6): a
    symmetric PSD matrix with <dual, X> = 0, equal to the reference's."""
    w, (want, want_g) = psd_ref
    layer = _psd_layer(ct, device="cpu")
    outs, x, y, status, params = _run(layer, [_PSD_C])
    assert (status == 0).all()
    for got, ref in zip(outs, want):
        assert tuple(got.shape) == ref.shape == (2, 3, 3)
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=_ATOL,
                                   rtol=0)
    _check_against_ref_recover(ref_layers["psd"], outs, x, y, True)
    Z = outs[1].detach().numpy()
    np.testing.assert_allclose(Z, Z.transpose(0, 2, 1), atol=1e-12)
    assert np.linalg.eigvalsh(Z).min() >= -1e-7
    np.testing.assert_allclose(
        np.einsum("bij,bij->b", Z, outs[0].detach().numpy()), 0.0,
        atol=1e-6)
    for g, ref in zip(_port_grads(outs, w, params), want_g):
        np.testing.assert_allclose(g, ref, atol=_GRAD_ATOL, rtol=0)


# each route and solve method on the SOC and PSD layers: (name, solver
# args, whether rescue wraps the call). Outputs and gradients are held
# against the reference layer's default-route ones; at eps 1e-9 every
# method lands on the same solution
_ROUTES = (
    ("dense", {"shared_setup": "off"}, False),
    ("sparse", {"assembly": "sparse"}, False),
    ("ipm_hsde", {"solve_method": "ipm", "ipm_mode": "hsde"}, False),
    ("ipm_pd", {"solve_method": "ipm", "ipm_mode": "pd"}, False),
    ("pdhg", {"solve_method": "pdhg", "max_iters": 20000}, False),
    ("rescue", {"max_iters": 1, "epoch": 1, "refine_steps": 0}, True),
)


@pytest.mark.parametrize("route,args,rescue", _ROUTES,
                         ids=[r[0] for r in _ROUTES])
def test_soc_parts_on_every_route(route, args, rescue, soc_ref,
                                  ref_layers):
    """The SOC parts by each route and solve method: the reference's
    _recover of the raw iterates, and the reference layer's outputs and
    gradients. The rescue case fails its fast route on purpose (one
    iteration, no polish), so the rescue stage's outputs are the ones
    recovered; it runs batched (rescue gathers along the batch axis)."""
    w, (want, want_g) = soc_ref
    layer = _soc_layer(ct, device="cpu")
    if rescue:
        params = _tensors([_SOC_V[None]], grad=True)
        outs, status, _ = ct.solve_with_rescue(
            layer, *params, solver_args=dict(_EPS, **args),
            rescue_args=_EPS, capacity=1)
        assert int(status[0]) == 0
        assert [tuple(o.shape) for o in outs] == [(1, 4), (1,), (1, 4)]
        outs = [o[0] for o in outs]
        grads = [g[0] for g in _port_grads(outs, w, params)]
    else:
        outs, x, y, status, params = _run(layer, [_SOC_V], args)
        assert int(status) == 0
        _check_against_ref_recover(ref_layers["soc"], outs, x, y, False)
        grads = _port_grads(outs, w, params)
    for got, ref in zip(outs, want):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=_ATOL,
                                   rtol=0)
    for g, ref in zip(grads, want_g):
        np.testing.assert_allclose(g, ref, atol=_GRAD_ATOL, rtol=0)


def test_psd_dual_on_other_routes(psd_ref, ref_layers):
    """The PSD dual by the shared route, the IPM and the sparse route."""
    w, (want, want_g) = psd_ref
    layer = _psd_layer(ct, device="cpu")
    for args in ({}, {"solve_method": "ipm"}, {"assembly": "sparse"}):
        outs, x, y, status, params = _run(layer, [_PSD_C], args)
        assert (status == 0).all()
        _check_against_ref_recover(ref_layers["psd"], outs, x, y, True)
        for got, ref in zip(outs, want):
            np.testing.assert_allclose(got.detach().numpy(), ref,
                                       atol=_ATOL, rtol=0)
        for g, ref in zip(_port_grads(outs, w, params), want_g):
            np.testing.assert_allclose(g, ref, atol=_GRAD_ATOL, rtol=0)


def test_soc_batched_and_batch_one_shapes(ref_layers):
    """Batched SOC parts keep the batch axis: (5,) and (5, 3), and (1,)
    and (1, 3) for a batch of one (not squeezed)."""
    layer = _soc_batched_layer(ct, device="cpu")
    for v in (_SOC_V5, _SOC_V5[:1]):
        outs, x, y, status, _ = _run(layer, [v], grad=False)
        assert (status == 0).all()
        assert [tuple(o.shape) for o in outs] == [(len(v),), (len(v), 3)]
        _check_against_ref_recover(ref_layers["soc_batched"], outs, x, y,
                                   True)


def test_exp_parts_closed_form(ref_layers):
    """min z s.t. (a, 1, z) in Kexp: the three parts are scalars equal to
    (-e^a, (a - 1) e^a, 1), unbatched and by the IPM."""
    av = 0.3
    want = [np.exp(av), -np.exp(av), (av - 1) * np.exp(av), 1.0]
    layer = _exp_layer(ct, device="cpu")
    for args in ({}, {"solve_method": "ipm"}):
        outs, x, y, status, _ = _run(layer, [np.float64(av)], args,
                                     grad=False)
        assert int(status) == 0
        _check_against_ref_recover(ref_layers["exp"], outs, x, y, False)
        assert all(tuple(o.shape) == () for o in outs)
        np.testing.assert_allclose([float(o) for o in outs], want,
                                   atol=1e-6)


def test_exp_vector_parts_on_the_sparse_route(ref_layers):
    """Three exp triples: each part has the argument's shape (2, 3)
    batched, and the z-part is 1; by the sparse route."""
    av = _R.standard_normal((2, 3)) * 0.3
    layer = _exp_vector_layer(ct, device="cpu")
    outs, x, y, status, _ = _run(layer, [av], {"assembly": "sparse"},
                                 grad=False)
    assert (status == 0).all()
    _check_against_ref_recover(ref_layers["exp_vector"], outs, x, y, True)
    assert [tuple(o.shape) for o in outs] == [(2, 3)] * 3
    np.testing.assert_allclose(outs[2].numpy(), 1.0, atol=1e-6)


def test_pow_parts_membership_and_complementarity(ref_layers):
    """max z s.t. (a, 1.5, z) in Pow(0.4): scalar parts in the dual power
    cone with zero complementarity gap."""
    alpha, av = 0.4, 2.0
    layer = _pow_layer(ct, device="cpu")
    outs, x, y, status, _ = _run(layer, [np.float64(av)], grad=False)
    assert int(status) == 0
    _check_against_ref_recover(ref_layers["pow"], outs, x, y, False)
    zs, u, v, w = (float(o) for o in outs)
    zstar = av ** alpha * 1.5 ** (1 - alpha)
    np.testing.assert_allclose(zs, zstar, atol=1e-6)
    assert u >= -1e-8 and v >= -1e-8
    lhs = (max(u, 0) / alpha) ** alpha * (max(v, 0) / (1 - alpha)) ** (
        1 - alpha)
    assert lhs >= abs(w) - 1e-6
    np.testing.assert_allclose(av * u + 1.5 * v + zstar * w, 0.0, atol=1e-5)


@pytest.fixture(scope="module")
def every_runs():
    """The every-cone layer on each configuration: the first by the
    default (shared ADMM) route, the second by the IPM (its primal-dual
    form: exp and pow cones), with the parameter gradients of the optimal
    value sum((x - v)^2)."""
    layer = _every_layer(ct, device="cpu")
    runs = {}
    for case, args in (("soc_exp_psd_pow", {}),
                       ("eq_nonneg_exp", {"solve_method": "ipm"})):
        outs, x, y, status, params = _run(layer, _every_args(case), args)
        fstar = ((outs[0] - params[0]) ** 2).sum()
        grads = torch.autograd.grad(fstar, params[1:], retain_graph=True)
        runs[case] = (outs, x, y, status, params,
                      dict(zip(_EVERY_KEYS, (float(g) for g in grads))))
    return layer, runs


@pytest.mark.parametrize("case", list(_EVERY))
def test_every_cone_parts_and_envelope_identities(case, every_runs,
                                                  ref_layers):
    """Every part of every cone against the reference's _recover, and
    each offset's sensitivity of the optimal value (the port's adjoint)
    equal to minus its constraint's dual: any cross-cone ordering or
    slicing error breaks the match. Dual-cone membership per part."""
    _, runs = every_runs
    outs, x, y, status, _, fd = runs[case]
    assert int(status) == 0
    _check_against_ref_recover(ref_layers["every"], outs, x, y, False)
    (xs, lam_eq, lam_nn, du_t, du_x, de_x, de_y, de_z, Z,
     pw_x, pw_y, pw_z) = (o.detach().numpy() for o in outs)
    assert [o.shape for o in (du_t, du_x, de_x, Z, pw_x)] == [
        (), (3,), (), (2, 2), ()]
    tol = 1e-6
    np.testing.assert_allclose(fd["e"], -float(lam_eq), atol=tol)
    np.testing.assert_allclose(fd["m"], float(lam_nn.sum()), atol=tol)
    np.testing.assert_allclose(fd["r"], -float(du_t), atol=tol)
    np.testing.assert_allclose(fd["pz"], -float(de_z), atol=tol)
    np.testing.assert_allclose(fd["po"], -float(Z[0, 0]), atol=tol)
    np.testing.assert_allclose(fd["pw"], -float(pw_x), atol=tol)
    assert (lam_nn >= -1e-8).all()
    assert np.linalg.norm(du_x) <= float(du_t) + 1e-7
    assert float(np.linalg.eigvalsh(Z).min()) >= -1e-7
    if case == "soc_exp_psd_pow":
        assert float(du_t) > 0.1 and abs(float(de_z)) > 0.1
        assert float(Z[0, 0]) > 0.01 and float(pw_x) > 0.1
    else:
        assert abs(float(lam_eq)) > 1e-3 and float(lam_nn.sum()) > 0.1
        assert abs(float(de_z)) > 0.01


def test_every_cone_part_vjps_match_reference(every_runs, ref_layers):
    """The gradient through each part on its own: the port's autograd of
    _recover against jax.vjp of the reference's, at the every-cone
    layer's raw iterates, one seeded cotangent per part."""
    layer, runs = every_runs
    _, x, y, _, _, _ = runs["soc_exp_psd_pow"]
    rlayer = ref_layers["every"]
    want, vjp = jax.vjp(jax.vmap(rlayer._recover), jnp.asarray(x),
                        jnp.asarray(y))
    cots = _weights([np.asarray(o) for o in want], 3)
    for k in range(len(cots)):
        one = [c if i == k else np.zeros_like(c) for i, c in enumerate(cots)]
        rdx, rdy = vjp(tuple(jnp.asarray(c) for c in one))
        xt, yt = _tensors([x, y], grad=True)
        outs = layer._recover(xt, yt)
        loss = sum((torch.as_tensor(c) * o).sum() for c, o in zip(one, outs))
        dx, dy = torch.autograd.grad(loss, (xt, yt), allow_unused=True)
        dx = torch.zeros_like(xt) if dx is None else dx
        dy = torch.zeros_like(yt) if dy is None else dy
        np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), atol=1e-12)
        np.testing.assert_allclose(dy.numpy(), np.asarray(rdy), atol=1e-12)
        assert float(np.abs(np.asarray(rdy)).sum()) > 0 or k == 0
