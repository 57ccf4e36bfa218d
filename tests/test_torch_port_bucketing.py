"""The port's heterogeneous bucketing (dist/bucketing.py) against the
reference's (cvxpylayers_tpu/dist/bucketing.py).

The contracts of tests/test_dist.py on the port, on the CPU in f64:
bucketed round trips equal direct calls (atol 1e-9 where a layer's
direct call takes the same solver, as the reference's test asks; a
constant-P/A layer's direct call takes the shared route, which agrees
within the solver's tolerance) and keep each item's batchedness; the key
carries p_diag_only and p_zero, and, unlike the reference's, the layer's
device first; two layers of one structure share one cached solver;
padding changes no result; gradients flow through buckets; PDHG runs
through buckets; the warm-start state round-trips. Against the reference
on the same inputs: the outputs and gradients of one mixed bucketed call
within 1e-6 (_ATOL, as tests/test_torch_port_layer.py), and the bucket
plans. The reference's bucketed solve is compiled once, by the module
fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.dist import bucketing as jb
from cvxpylayers_tpu.layer.cvxpylayer import (
    _settings_from_args as j_settings,
)
from cvxpylayers_tpu_torch.dist.bucketing import (
    _EXEC_CACHE,
    _shared_core,
    bucket_plan,
    solve_bucketed,
    structure_key,
)
from cvxpylayers_tpu_torch.layer.cvxpylayer import _settings_from_args

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-6
rng = np.random.default_rng(11)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _proj_layer(mod, n, **kw):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [mod.sum(x) == 1, x >= 0])
    return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)


def _box_layer(mod, n, **kw):
    """For matching n a different cone pattern (no equality row): its
    own bucket."""
    x = mod.Variable(n)
    v = mod.Parameter(n)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)


def _key(layer, solver_args=None):
    return structure_key(layer, _settings_from_args(layer._base_settings,
                                                    solver_args))


_VA = np.random.default_rng(1).standard_normal((3, 5))
_VB = np.random.default_rng(2).standard_normal(5)


@pytest.fixture(scope="module")
def reference():
    """The reference's mixed bucketed call (a batched simplex item, an
    unbatched box item): outputs and gradients of sum(out^2)."""
    la, lb = _proj_layer(cj, 5), _box_layer(cj, 5)

    def loss(va, vb):
        res = jb.solve_bucketed([(la, (va,)), (lb, (vb,))])
        return (jnp.sum(res[0][0] ** 2) + jnp.sum(res[1][0] ** 2),
                (res[0][0], res[1][0]))

    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(_VA), jnp.asarray(_VB))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def test_round_trip_matches_direct_calls_and_reference(reference):
    la, lb = _proj_layer(ct, 5, device="cpu"), _box_layer(ct, 5, device="cpu")
    va, vb = _t(_VA), _t(_VB)
    res = solve_bucketed([(la, (va,)), (lb, (vb,))])
    (xa,) = la(va)
    (xb,) = lb(vb)
    np.testing.assert_allclose(res[0][0].numpy(), xa.numpy(), atol=1e-9)
    np.testing.assert_allclose(res[1][0].numpy(), xb.numpy(), atol=1e-9)
    assert res[0][0].shape == (3, 5) and res[1][0].shape == (5,)
    (ja, jb_), _ = reference
    np.testing.assert_allclose(res[0][0].numpy(), ja, atol=_ATOL)
    np.testing.assert_allclose(res[1][0].numpy(), jb_, atol=_ATOL)


def test_gradients_flow_through_buckets_as_in_reference(reference):
    la, lb = _proj_layer(ct, 5, device="cpu"), _box_layer(ct, 5, device="cpu")
    va, vb = _t(_VA).requires_grad_(), _t(_VB).requires_grad_()
    res = solve_bucketed([(la, (va,)), (lb, (vb,))])
    ((res[0][0] ** 2).sum() + (res[1][0] ** 2).sum()).backward()
    for layer, v, g, jg in zip((la, lb), (_VA, _VB), (va.grad, vb.grad),
                               reference[1]):
        vd = _t(v).requires_grad_()
        (layer(vd)[0] ** 2).sum().backward()
        np.testing.assert_allclose(g.numpy(), vd.grad.numpy(), atol=1e-8)
        np.testing.assert_allclose(g.numpy(), jg, atol=_ATOL)


def test_key_carries_device_and_p_diag_only():
    """The key is the reference's with the layer's device in front:
    key[-2] is p_diag_only, key[-1] p_zero, as there."""
    la = _proj_layer(ct, 5, device="cpu")
    key = _key(la)
    assert key[0] == torch.device("cpu")
    assert key[-2] is True and la._p_diag_only is True

    def quad(mod, **kw):
        x = mod.Variable(5)
        Ps = mod.Parameter((5, 5), PSD=True)
        v = mod.Parameter(5)
        return mod.CvxpyLayer(
            mod.Problem(mod.Minimize(mod.quad_form(x, Ps) - v @ x),
                        [mod.sum(x) == 1, x >= 0]),
            parameters=[Ps, v], variables=[x], **kw)

    lq, jq = quad(ct, device="cpu"), quad(cj)
    kq = _key(lq)
    assert kq[-2] is False and kq != key
    jkey = jb.structure_key(jq, j_settings(jq._base_settings, None))
    assert kq[2] == jkey[1] and kq[-3:] == tuple(jkey[-3:])


def test_p_zero_in_structure_key():
    def lp(mod, **kw):
        x = mod.Variable(2, nonneg=True)
        c = mod.Parameter(2)
        return mod.CvxpyLayer(mod.Problem(mod.Minimize(c @ x),
                                          [mod.sum(x) == 1]),
                              parameters=[c], variables=[x], **kw)

    def qp(mod, **kw):
        x = mod.Variable(2, nonneg=True)
        c = mod.Parameter(2)
        return mod.CvxpyLayer(
            mod.Problem(mod.Minimize(mod.sum_squares(x - c)),
                        [mod.sum(x) == 1]),
            parameters=[c], variables=[x], **kw)

    assert _key(lp(ct, device="cpu"))[-1] is True
    assert _key(qp(ct, device="cpu"))[-1] is False
    for build in (lp, qp):
        jl = build(cj)
        assert _key(build(ct, device="cpu"))[-1] is jb.structure_key(
            jl, j_settings(jl._base_settings, None))[-1]


def test_key_separates_devices():
    """Tensors on two devices cannot share a bucket: the same structure
    on two devices makes two buckets."""
    lc = _proj_layer(ct, 4, device="cpu")
    lm = _proj_layer(ct, 4, device="meta")
    plan = bucket_plan([(lc, (torch.zeros(2, 4, dtype=torch.float64),)),
                        (lm, (torch.zeros(3, 4, dtype=torch.float64,
                                          device="meta"),))])
    assert sorted(plan.values()) == [(2, 2), (3, 3)]
    assert _key(lc)[1:] == _key(lm)[1:]


def test_same_structure_layers_share_bucket_and_solver():
    n = 4
    l1 = _proj_layer(ct, n, device="cpu")
    x2 = ct.Variable(n)
    w = ct.Parameter(n)
    l2 = ct.CvxpyLayer(
        ct.Problem(ct.Minimize(ct.sum_squares(x2 - 2.0 * w)),
                   [ct.sum(x2) == 1, x2 >= 0]),
        parameters=[w], variables=[x2], device="cpu")
    assert _key(l1) == _key(l2)
    ones = torch.ones(n, dtype=torch.float64)
    assert len(bucket_plan([(l1, (ones,)), (l2, (ones,))])) == 1
    before = len(_EXEC_CACHE)
    vv = _t(rng.standard_normal(n))
    res = solve_bucketed([(l1, (vv,)), (l2, (vv,))])
    assert len(_EXEC_CACHE) <= before + 1
    np.testing.assert_allclose(res[0][0].numpy(), l1(vv)[0].numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(res[1][0].numpy(), l2(vv)[0].numpy(),
                               atol=1e-9)


def test_shared_core_is_cached_per_structure():
    la = _proj_layer(ct, 4, device="cpu")
    key = _key(la)
    assert _shared_core(*key[1:]) is _shared_core(*key[1:])
    other = _key(la, {"max_iters": 123})
    assert _shared_core(*other[1:]) is not _shared_core(*key[1:])


def test_padding_does_not_change_results_and_plan_matches_reference():
    la = _proj_layer(ct, 4, device="cpu")
    va = _t(rng.standard_normal((3, 4)))
    res_pad = solve_bucketed([(la, (va,))], pad_multiple=8)
    res_ref = solve_bucketed([(la, (va,))], pad_multiple=1)
    np.testing.assert_allclose(res_pad[0][0].numpy(), res_ref[0][0].numpy(),
                               atol=1e-12)
    assert res_pad[0][0].shape == (3, 4)
    # a mixed plan, padded to 4: the reference's counts and sizes
    lb, lc = _box_layer(ct, 4, device="cpu"), _proj_layer(ct, 4, device="cpu")
    items = [(la, (va,)), (lb, (_t(np.ones(4)),)), (lc, (_t(np.ones((6, 4))),))]
    jitems = [(_proj_layer(cj, 4), (jnp.asarray(va.numpy()),)),
              (_box_layer(cj, 4), (jnp.ones(4),)),
              (_proj_layer(cj, 4), (jnp.ones((6, 4)),))]
    assert list(bucket_plan(items, pad_multiple=4).values()) == list(
        jb.bucket_plan(jitems, pad_multiple=4).values()) == [(9, 12), (1, 4)]


def test_pdhg_through_buckets_matches_direct():
    """p_zero reaches the shared solver: PDHG runs on a bucketed LP."""
    n_, m_ = 3, 5
    x = ct.Variable(n_, nonneg=True)
    A = ct.Parameter((m_, n_))
    b = ct.Parameter(m_)
    layer = ct.CvxpyLayer(ct.Problem(ct.Minimize(ct.pnorm(A @ x - b, 1))),
                          parameters=[A, b], variables=[x], device="cpu")
    r = np.random.default_rng(23)
    Av, bv = _t(r.standard_normal((2, m_, n_))), _t(r.standard_normal((2, m_)))
    sa = {"solve_method": "pdhg", "max_iters": 4000}
    res = solve_bucketed([(layer, (Av, bv))], solver_args=sa)
    (ref,) = layer(Av, bv, solver_args=sa)
    np.testing.assert_allclose(res[0][0].numpy(), ref.numpy(), atol=1e-7)


def test_warm_state_round_trip():
    la = _proj_layer(ct, 6, device="cpu")
    va = _t(rng.standard_normal((3, 6)))
    res1, state = solve_bucketed([(la, (va,))], return_state=True,
                                 pad_multiple=4)
    (x, y, s), = state.values()
    assert x.shape == (4, 6) and y.shape == (4, 7) and not x.requires_grad
    res2, _ = solve_bucketed([(la, (va,))], warm_start=state,
                             return_state=True, pad_multiple=4)
    np.testing.assert_allclose(res1[0][0].numpy(), res2[0][0].numpy(),
                               atol=1e-9)
    # a state of another shape is ignored: a cold start
    res3 = solve_bucketed([(la, (va,))], warm_start=state, pad_multiple=1)
    np.testing.assert_array_equal(
        res3[0][0].numpy(), solve_bucketed([(la, (va,))])[0][0].numpy())
    # a mismatched structure falls back to a cold start cleanly
    lb = _box_layer(ct, 6, device="cpu")
    res4 = solve_bucketed([(lb, (_t(rng.standard_normal(6)),))],
                          warm_start=state)
    assert res4[0][0].shape == (6,)


def test_mixed_dtypes_promote_within_a_bucket():
    """torch.cat promotes as jnp.concatenate does: an f32 item and an f64
    item of one bucket both come back in f64, each equal to the direct
    f64 call on its (exactly upcast) parameters."""
    la = _proj_layer(ct, 4, device="cpu")
    v32 = torch.tensor(rng.standard_normal((2, 4)), dtype=torch.float32)
    v64 = _t(rng.standard_normal(4))
    res = solve_bucketed([(la, (v32,)), (la, (v64,))])
    assert res[0][0].dtype == res[1][0].dtype == torch.float64
    direct = solve_bucketed([(la, (torch.cat([v32.double(),
                                              v64[None]]),))])[0][0]
    np.testing.assert_allclose(res[0][0].numpy(), direct[:2].numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(res[1][0].numpy(), direct[2].numpy(),
                               atol=1e-12)


def test_batch_of_one_is_kept_and_gp_layer_buckets():
    """A batch of one keeps its axis; a gp=True layer's bucket logs the
    parameters and exps the variables through the layer's own assembly
    and recovery, equal to its direct call."""
    la = _proj_layer(ct, 4, device="cpu")
    res = solve_bucketed([(la, (_t(rng.standard_normal((1, 4))),))])
    assert res[0][0].shape == (1, 4)
    x = ct.Variable(pos=True)
    y = ct.Variable(pos=True)
    a = ct.Parameter(pos=True)
    gp = ct.CvxpyLayer(ct.Problem(ct.Minimize(x * y + x ** -1.0),
                                  [a * x <= y, y <= 4.0]),
                       parameters=[a], variables=[x, y], gp=True,
                       device="cpu")
    av = _t([0.5, 2.0])
    sa = {"solve_method": "ipm"}
    (xs, ys), = solve_bucketed([(gp, (av,))], solver_args=sa)
    xd, yd = gp(av, solver_args=sa)
    np.testing.assert_allclose(xs.numpy(), xd.numpy(), atol=1e-9)
    np.testing.assert_allclose(ys.numpy(), yd.numpy(), atol=1e-9)
    np.testing.assert_allclose(xs.numpy(), (2 * av.numpy()) ** (-1 / 3),
                               atol=1e-5)


def test_results_follow_input_order_across_buckets():
    """Items of two buckets interleaved, batched and not: each result is
    its own item's, in input order, equal to its direct call."""
    la, lb = _proj_layer(ct, 4, device="cpu"), _box_layer(ct, 4, device="cpu")
    items = [(la, (_t(rng.standard_normal((2, 4))),)),
             (lb, (_t(rng.standard_normal(4)),)),
             (la, (_t(rng.standard_normal(4)),)),
             (lb, (_t(rng.standard_normal((3, 4))),))]
    res = solve_bucketed(items)
    assert [tuple(r[0].shape) for r in res] == [(2, 4), (4,), (4,), (3, 4)]
    for (layer, params), (out,) in zip(items, res):
        np.testing.assert_allclose(out.numpy(), layer(*params)[0].numpy(),
                                   atol=1e-9)
