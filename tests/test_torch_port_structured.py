"""The port's structured, approximation, support-function and partial-
optimization atoms against the reference.

expressions/atoms/structured.py, approx.py, suppfunc.py and
partial_optimize.py are copies of the reference's numpy modules; their
canonical programs are held equal to the reference's exactly (the
stuffed maps entry for entry, no solve), on the epigraph programs of
tests/test_atoms_structured.py and tests/test_atoms_scalar.py. The same
atoms' numeric values equal the reference's. On the port (f64, CPU) the
epigraph programs solve to the numpy and scipy oracles of those tests,
and one layer holding sum_largest, norm_nuc and lambda_sum_largest (the
layer chip_smoke.py runs on the card) matches the reference's outputs
within 1e-8 and gradients within 1e-6. The numeric values of suppfunc
and partial_optimize run an inner Problem.solve on the atom's `device`:
the card by default (so without one they raise), the CPU on request.
The export lists of both namespaces equal the reference's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln
from scipy.stats import norm as spnorm

import cvxpylayers_tpu as cj
import cvxpylayers_tpu.expressions as cj_expr
import cvxpylayers_tpu_torch as ct
import cvxpylayers_tpu_torch.expressions as ct_expr
from _port_programs import assert_same_program
from cvxpylayers_tpu.canon import stuffer as j_stuffer
from cvxpylayers_tpu_torch.canon import stuffer as t_stuffer

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_R = np.random.default_rng(7)
_V7 = _R.standard_normal(7)
_M34 = _R.standard_normal((3, 4))
_V43 = _R.standard_normal((4, 3))
_S44 = _R.standard_normal((4, 4))
_S44 = 0.5 * (_S44 + _S44.T)
_V45 = _R.standard_normal((4, 5))
_P5 = _R.uniform(0.5, 2.0, size=5)
_W3 = np.array([2.0, -1.0, 0.5])


def _epi(pk, fn, shape, maximize=False, **param_kw):
    """min t s.t. x == v, t >= f(x) (max t, t <= f(x) for a concave f):
    t* = f(v)."""
    v = pk.Parameter(shape, **param_kw)
    x = pk.Variable(shape)
    t = pk.Variable()
    if maximize:
        prob = pk.Problem(pk.Maximize(t), [x == v, t <= fn(pk, x)])
    else:
        prob = pk.Problem(pk.Minimize(t), [x == v, t >= fn(pk, x)])
    return prob, [v], t


def _suppfunc_epi(pk, set_fn, shape, set_kw=None):
    y = pk.Variable(shape, **(set_kw or {}))
    f = pk.suppfunc(y, set_fn(pk, y))
    return _epi(pk, lambda pk_, x: f(x), shape)


def _moreau(pk):
    x, z = pk.Variable(4), pk.Variable(4)
    a, p = pk.Parameter(4), pk.Parameter(4)
    t = pk.Variable()
    inner = pk.Problem(pk.Minimize(pk.sum_squares(z - x)
                                   + pk.sum_squares(z - a)))
    g = pk.partial_optimize(inner, opt_vars=[z])
    return pk.Problem(pk.Minimize(t), [x == p, g <= t]), [p, a], t


def _coupled(pk):
    x, z = pk.Variable(4), pk.Variable(4)
    p = pk.Parameter(4)
    t = pk.Variable()
    inner = pk.Problem(pk.Minimize(pk.Constant(np.arange(1.0, 5.0)) @ z),
                       [z >= x])
    g = pk.partial_optimize(inner, dont_opt_vars=[x])
    return pk.Problem(pk.Minimize(t), [x == p, g <= t]), [p], t


def _sup_concave(pk):
    x, z = pk.Variable(4), pk.Variable(4)
    p = pk.Parameter(4)
    t = pk.Variable()
    inner = pk.Problem(pk.Maximize(-pk.sum_squares(z)
                                   - pk.sum_squares(z - x)))
    h = pk.partial_optimize(inner, opt_vars=[z])
    return pk.Problem(pk.Maximize(t), [x == p, h >= t]), [p], t


# (name, program builder, value at the seeded point or None). Each
# builder takes the package and returns (problem, parameters, t)
_EPIGRAPHS = {
    "ordered": {
        "sum_largest": (lambda pk: _epi(
            pk, lambda m, x: m.sum_largest(x, 3), 7),
            _V7, np.sort(_V7)[-3:].sum()),
        "sum_smallest": (lambda pk: _epi(
            pk, lambda m, x: m.sum_smallest(x, 3), 7, maximize=True),
            _V7, np.sort(_V7)[:3].sum()),
        "ptp": (lambda pk: _epi(pk, lambda m, x: m.ptp(x), 7),
                _V7, _V7.max() - _V7.min()),
        "dotsort": (lambda pk: _epi(
            pk, lambda m, x: m.dotsort(x, _W3), 7),
            _V7, float(np.dot(np.sort(_V7), np.sort(
                np.concatenate([_W3, np.zeros(4)]))))),
        "cummax_axis1": (lambda pk: _epi(
            pk, lambda m, x: m.sum(m.cummax(x, axis=1)), (3, 4)),
            _M34, np.maximum.accumulate(_M34, axis=1).sum()),
    },
    "spectral": {
        "norm_nuc": (lambda pk: _epi(pk, lambda m, X: m.norm_nuc(X),
                                     (4, 3)),
                     _V43, np.linalg.svd(_V43, compute_uv=False).sum()),
        "norm_nuc_via_norm": (lambda pk: _epi(
            pk, lambda m, X: m.norm(X, "nuc"), (3, 4)),
            _M34, np.linalg.svd(_M34, compute_uv=False).sum()),
        "lambda_sum_largest": (lambda pk: _epi(
            pk, lambda m, X: m.lambda_sum_largest(X, 2), (4, 4)),
            _S44, np.sort(np.linalg.eigvalsh(_S44))[-2:].sum()),
        "lambda_sum_smallest": (lambda pk: _epi(
            pk, lambda m, X: m.lambda_sum_smallest(X, 2), (4, 4),
            maximize=True),
            _S44, np.sort(np.linalg.eigvalsh(_S44))[:2].sum()),
    },
    "means_and_norms": {
        "harmonic_mean": (lambda pk: _epi(
            pk, lambda m, x: m.harmonic_mean(x), 5, maximize=True),
            _P5, 5.0 / np.sum(1.0 / _P5)),
        "tv_1d": (lambda pk: _epi(pk, lambda m, x: m.tv(x), 7),
                  _V7, np.abs(np.diff(_V7)).sum()),
        "tv_2d": (lambda pk: _epi(pk, lambda m, X: m.tv(X), (4, 5)),
                  _V45, np.sqrt((_V45[1:, :-1] - _V45[:-1, :-1]) ** 2
                                + (_V45[:-1, 1:] - _V45[:-1, :-1]) ** 2
                                ).sum()),
        "mixed_norm_21": (lambda pk: _epi(
            pk, lambda m, X: m.mixed_norm(X, 2, 1), (3, 4)),
            _M34, np.linalg.norm(_M34, axis=1).sum()),
        "mixed_norm_11": (lambda pk: _epi(
            pk, lambda m, X: m.mixed_norm(X, 1, 1), (3, 4)),
            _M34, np.abs(_M34).sum()),
        "mixed_norm_inf2": (lambda pk: _epi(
            pk, lambda m, X: m.mixed_norm(X, np.inf, 2), (3, 4)),
            _M34, np.linalg.norm(np.abs(_M34).max(axis=1))),
    },
    "approx": {
        # the approximations' own contracts: 1e-3 of the true functions
        "log_normcdf": (lambda pk: _epi(
            pk, lambda m, x: m.sum(m.log_normcdf(x)), 3, maximize=True),
            np.array([-2.0, 0.0, 1.5]),
            np.sum(spnorm.logcdf([-2.0, 0.0, 1.5]))),
        "loggamma": (lambda pk: _epi(
            pk, lambda m, x: m.sum(m.loggamma(x)), 4),
            np.array([0.3, 1.0, 2.5, 7.0]),
            np.sum(gammaln([0.3, 1.0, 2.5, 7.0]))),
    },
    # suppfunc's sets and partial_optimize's projections
    "transforms": {
        "box": (lambda pk: _suppfunc_epi(
            pk, lambda m, y: [y <= 1, y >= -1], 4),
            _V7[:4], np.abs(_V7[:4]).sum()),
        "ball": (lambda pk: _suppfunc_epi(
            pk, lambda m, y: [m.norm(y, 2) <= 1], 4),
            _V7[:4], np.linalg.norm(_V7[:4])),
        "simplex": (lambda pk: _suppfunc_epi(
            pk, lambda m, y: [m.sum(y) == 1], 4, {"nonneg": True}),
            _V7[:4], _V7[:4].max()),
        "spectrahedron": (lambda pk: _suppfunc_epi(
            pk, lambda m, Y: [m.PSD(Y), m.trace(Y) <= 1], (4, 4)),
            _S44, max(np.linalg.eigvalsh(_S44).max(), 0.0)),
        "entropy_ball": (lambda pk: _suppfunc_epi(
            pk, lambda m, y: [m.sum(y) == 1, m.sum(m.entr(y)) >= 0.9], 4,
            {"nonneg": True}), _V7[:4], None),
        "pnorm_ball": (lambda pk: _suppfunc_epi(
            pk, lambda m, y: [m.pnorm(y, 3) <= 1], 5),
            _V7[:5], np.sum(np.abs(_V7[:5]) ** 1.5) ** (1 / 1.5)),
        "moreau_envelope": (_moreau, None, None),
        "coupled": (_coupled, _V7[:4], np.arange(1.0, 5.0) @ _V7[:4]),
        "sup_concave": (_sup_concave, _V7[:4],
                        -0.5 * np.sum(_V7[:4] ** 2)),
    },
}


@pytest.mark.parametrize("family", list(_EPIGRAPHS))
def test_canonical_programs_equal_reference(family):
    """Every atom's epigraph program, stuffed by each package: equal
    field for field."""
    for name, (build, _, _) in _EPIGRAPHS[family].items():
        tprob, tparams, _ = build(ct)
        jprob, jparams, _ = build(cj)
        try:
            assert_same_program(t_stuffer.stuff(tprob, tparams),
                                j_stuffer.stuff(jprob, jparams))
        except AssertionError as e:
            raise AssertionError(f"{family}/{name}: {e}") from e


def _port_epi_value(build, value):
    prob, params, t = build(ct)
    layer = ct.CvxpyLayer(prob, parameters=params, variables=[t],
                          device="cpu")
    (ts,), status, _ = layer.solve_with_info(torch.tensor(value))
    assert int(status) == 0
    return float(ts)


# the reference tests' tolerances; log_normcdf and loggamma are
# approximations held within 1e-3 of scipy's functions
# (tests/test_atoms_scalar.py). By ADMM, as those tests: on this loggamma
# program the primal-dual IPM of both packages stops at iteration 8 with
# a primal-infeasible verdict (ROADMAP, Queue 3)
@pytest.mark.parametrize("family,tol", [
    ("ordered", 1e-6), ("spectral", 1e-5), ("means_and_norms", 1e-6),
    ("approx", 1e-3), ("transforms", 1e-6)])
def test_epigraphs_solve_to_their_oracles(family, tol):
    """Each epigraph program on the port evaluates its atom at the pinned
    point: the numpy and scipy oracles of the reference's tests (the
    entropy ball's oracle is an SLSQP run there; its program is held
    above)."""
    for name, (build, value, want) in _EPIGRAPHS[family].items():
        if want is None:
            continue
        got = _port_epi_value(build, value)
        np.testing.assert_allclose(got, want, atol=tol, err_msg=name)


def test_atom_values_equal_reference():
    """The numeric .value of every structured and approximation atom at
    the same constants, in both packages."""
    def values(pk):
        v, M, S, P = (pk.Constant(a) for a in (_V7, _M34, _S44, _P5))
        return {
            "sum_largest": pk.sum_largest(v, 3),
            "sum_smallest": pk.sum_smallest(v, 2),
            "ptp": pk.ptp(v), "dotsort": pk.dotsort(v, _W3),
            "norm_nuc": pk.norm_nuc(M), "nuc": pk.norm(M, "nuc"),
            "lambda_sum_largest": pk.lambda_sum_largest(S, 2),
            "lambda_sum_smallest": pk.lambda_sum_smallest(S, 2),
            "harmonic_mean": pk.harmonic_mean(P), "tv": pk.tv(v),
            "tv_2d": pk.tv(M), "mixed_norm": pk.mixed_norm(M, 2, 1),
            "cummax": pk.cummax(M, axis=1),
            "log_normcdf": pk.log_normcdf(v), "loggamma": pk.loggamma(P),
        }

    got, want = values(ct), values(cj)
    for key, expr in want.items():
        assert got[key].shape == expr.shape, key
        assert got[key].curvature().name == expr.curvature().name, key
        w = expr.value
        g = got[key].value
        if w is None:
            assert g is None, key
            continue
        np.testing.assert_allclose(g, w, atol=1e-12, rtol=0, err_msg=key)


def _structured_layer(pk, **kw):
    """sum_largest (an LP epigraph), norm_nuc and lambda_sum_largest (PSD
    epigraphs) in one prox layer, the layer of chip_smoke.py."""
    v = pk.Parameter(8)
    M = pk.Parameter((4, 3))
    S = pk.Parameter((4, 4))
    x = pk.Variable(8)
    X = pk.Variable((4, 3))
    Y = pk.Variable((4, 4))
    prob = pk.Problem(pk.Minimize(
        pk.sum_squares(x - v) + pk.sum_squares(X - M)
        + pk.sum_squares(Y - S) + pk.sum_largest(x, 3)
        + pk.norm_nuc(X) + pk.lambda_sum_largest(Y, 2)))
    return pk.CvxpyLayer(prob, parameters=[v, M, S], variables=[x, X, Y],
                         **kw)


def test_structured_layer_matches_reference():
    """One jitted reference value-and-gradient of a seeded weighting of
    the three outputs, B=2, against the port."""
    r = np.random.default_rng(5)
    arrs = [r.standard_normal((2, 8)), r.standard_normal((2, 4, 3)),
            r.standard_normal((2, 4, 4))]
    arrs[2] = 0.5 * (arrs[2] + arrs[2].transpose(0, 2, 1))
    weights = [r.standard_normal(a.shape) for a in arrs]
    args = {"eps": 1e-9}
    rl = _structured_layer(cj)

    def loss(*params):
        outs = rl(*params, solver_args=args)
        return sum(jnp.sum(jnp.asarray(w) * o)
                   for w, o in zip(weights, outs)), outs

    want_g, want = jax.jit(jax.grad(loss, argnums=(0, 1, 2),
                                    has_aux=True))(
        *(jnp.asarray(a) for a in arrs))
    layer = _structured_layer(ct, device="cpu")
    params = [torch.tensor(a, requires_grad=True) for a in arrs]
    outs, status, _ = layer.solve_with_info(*params, solver_args=args)
    assert (status == 0).all()
    for got, ref in zip(outs, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=1e-8, rtol=0)
    sum((torch.as_tensor(w) * o).sum() for w, o in zip(weights, outs)
        ).backward()
    for p, ref in zip(params, want_g):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref),
                                   atol=1e-6, rtol=0)


def test_suppfunc_and_partial_optimize_gradients():
    """Closed-form gradients through the port's layers: d sigma/d b =
    pos(x) on the box [0, b] (test_param_box_gradient), and the Moreau
    envelope 0.5 ||x - a||^2 with d/da = a - x."""
    pv, bv = _V7[:4], np.abs(_V7[3:7]) + 0.5
    y, x, t = ct.Variable(4), ct.Variable(4), ct.Variable()
    b, p = ct.Parameter(4, pos=True), ct.Parameter(4)
    f = ct.suppfunc(y, [y >= 0, y <= b])
    layer = ct.CvxpyLayer(ct.Problem(ct.Minimize(t), [x == p, f(x) <= t]),
                          parameters=[p, b], variables=[t], device="cpu")
    bt = torch.tensor(bv, requires_grad=True)
    (ts,) = layer(torch.tensor(pv), bt)
    np.testing.assert_allclose(ts.item(), np.sum(bv * np.maximum(pv, 0)),
                               atol=1e-7)
    ts.backward()
    np.testing.assert_allclose(bt.grad.numpy(), np.maximum(pv, 0),
                               atol=1e-6)
    prob, params, t = _moreau(ct)
    layer = ct.CvxpyLayer(prob, parameters=params, variables=[t],
                          device="cpu")
    av = _V7[3:7]
    at = torch.tensor(av, requires_grad=True)
    (ts,) = layer(torch.tensor(pv), at)
    np.testing.assert_allclose(ts.item(), 0.5 * np.sum((pv - av) ** 2),
                               atol=1e-7)
    ts.backward()
    np.testing.assert_allclose(at.grad.numpy(), av - pv, atol=1e-6)


def test_inner_solves_run_on_the_named_device(monkeypatch):
    """suppfunc's and partial_optimize's .value run one inner
    Problem.solve on the device the atom names: with device="cpu" they
    equal the closed forms; without `device`
    the inner solve targets CUDA, so on a machine without it the value
    raises and never falls back to the CPU."""
    y = ct.Variable(3)
    sf = ct.suppfunc(y, [y >= -1, y <= 1], device="cpu")(
        ct.Constant(np.array([0.5, -2.0, 1.0])))
    np.testing.assert_allclose(float(sf.value), 3.5, atol=1e-6)
    x, z = ct.Variable(2), ct.Variable(2)
    inner = ct.Problem(ct.Minimize(ct.sum_squares(z - x)
                                   + ct.sum_squares(z)))
    g = ct.partial_optimize(inner, [z], device="cpu")
    x.value = np.array([1.0, -2.0])
    np.testing.assert_allclose(float(g.value), 2.5, atol=1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = ct.Variable(3)
    sf = ct.suppfunc(y, [y >= -1, y <= 1])(ct.Constant(np.ones(3)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sf.value  # noqa: B018
    x, z = ct.Variable(2), ct.Variable(2)
    g = ct.partial_optimize(ct.Problem(ct.Minimize(ct.sum_squares(z - x))),
                            [z])
    x.value = np.zeros(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g.value  # noqa: B018


def test_exports_and_refusals_equal_reference():
    """The port's namespaces export exactly the reference's names, and
    the same malformed calls raise in both packages."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    assert sorted(ct_expr.__all__) == sorted(cj_expr.__all__)
    assert public(ct_expr) == public(cj_expr)
    assert public(ct) == public(cj)
    # and the same malformed calls raise in both packages
    cases = (
        lambda pk: pk.sum_largest(pk.Variable(4), 5).shape,
        lambda pk: pk.dotsort(pk.Variable(3), np.ones(4)).shape,
        lambda pk: pk.tv(pk.Variable((1, 5))),
        lambda pk: pk.lambda_sum_largest(pk.Variable((3, 4)), 1),
        lambda pk: pk.norm_nuc(pk.Variable(3)),
        lambda pk: pk.suppfunc(pk.Variable(3), [pk.Variable(3) >= 0])(
            pk.Variable(3)),
        lambda pk: pk.suppfunc(pk.Variable(3), [])(pk.Variable(4)),
    )
    for case in cases:
        for pk in (ct, cj):
            with pytest.raises(Exception):
                case(pk)
    for pk in (ct, cj):
        z, x = pk.Variable(3), pk.Variable(3)
        with pytest.raises(ValueError):
            pk.partial_optimize(
                pk.Problem(pk.Maximize(-pk.sum_squares(z) + x @ z)),
                opt_vars=[z])
