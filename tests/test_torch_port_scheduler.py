"""The port's persistent bucket scheduler (dist/scheduler.py) against
the reference's (cvxpylayers_tpu/dist/scheduler.py).

The contracts of tests/test_dist.py's TestBucketScheduler on the port,
on the CPU in f64: a step equals direct calls (1e-8, as there) and keeps
each item's batchedness; capacity classes hold at their high-water mark
and bound the capacity changes (`compiles`); the warm start carries
across steps with the same composition, cutting iterations, and is
dropped when the composition changes; gradients flow through a step.
Against the reference on the same inputs: one mixed step's outputs within
1e-6 (_ATOL, as tests/test_torch_port_layer.py), `_round_capacity`, and
the stats (capacity, compiles, flushes, occupancy) of one stream of
steps. The reference compiles one solver per capacity class.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.dist import BucketScheduler as JScheduler
from cvxpylayers_tpu.dist.scheduler import _round_capacity as j_round
from cvxpylayers_tpu_torch.dist import BucketScheduler, solve_bucketed
from cvxpylayers_tpu_torch.dist.scheduler import _round_capacity

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
    x = mod.Variable(n)
    v = mod.Parameter(n)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)


def test_step_matches_direct_calls_and_reference():
    la, lb = _proj_layer(ct, 5, device="cpu"), _box_layer(ct, 5, device="cpu")
    va = rng.standard_normal((3, 5))
    vb = rng.standard_normal(5)
    res = BucketScheduler().step([(la, (_t(va),)), (lb, (_t(vb),))])
    np.testing.assert_allclose(res[0][0].numpy(), la(_t(va))[0].numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(res[1][0].numpy(), lb(_t(vb))[0].numpy(),
                               atol=1e-8)
    assert res[0][0].shape == (3, 5) and res[1][0].shape == (5,)
    jres = JScheduler().step([(_proj_layer(cj, 5), (jnp.asarray(va),)),
                              (_box_layer(cj, 5), (jnp.asarray(vb),))])
    for (got,), (want,) in zip(res, jres):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=_ATOL)


@pytest.mark.parametrize("B,pad", [(1, 1), (3, 1), (5, 2), (9, 4)])
def test_round_capacity_matches_reference(B, pad):
    """pad_multiple * next_pow2(ceil(B / pad_multiple))."""
    assert _round_capacity(B, pad) == j_round(B, pad)
    assert _round_capacity(B, pad) >= B and _round_capacity(B, pad) % pad == 0


def test_capacity_classes_and_stats_match_reference():
    """Batches 3 -> cap 4; 4 fits; 2 keeps the high-water 4; 6 -> 8; 5
    fits: two capacity classes, five flushes, and the reference's
    occupancy, on the same stream."""
    sched = BucketScheduler(pad_multiple=2)
    jsched = JScheduler(pad_multiple=2)
    la, jla = _proj_layer(ct, 5, device="cpu"), _proj_layer(cj, 5)
    for B, want_cap in [(3, 4), (4, 4), (2, 4), (6, 8), (5, 8)]:
        v = rng.standard_normal((B, 5))
        (out,) = sched.step([(la, (_t(v),))])[0]
        jsched.step([(jla, (jnp.asarray(v),))])
        assert out.shape == (B, 5)
        (st,) = sched.stats().values()
        assert st["capacity"] == want_cap, (B, st)
    (st,) = sched.stats().values()
    (jst,) = jsched.stats().values()
    assert st == jst
    assert st["compiles"] == 2 and st["flushes"] == 5
    assert st["occupancy"] == pytest.approx(20 / 28)


def test_warm_start_carries_across_steps():
    la = _proj_layer(ct, 6, device="cpu")
    v = _t(rng.standard_normal((4, 6)))
    sched = BucketScheduler()
    r1 = sched.step([(la, (v,))])
    (st,) = sched._buckets.values()
    it1 = int(st.last_iters.max())
    # the same data again: the carried state cuts iterations
    r2 = sched.step([(la, (v,))])
    it2 = int(st.last_iters.max())
    assert it2 < it1, (it1, it2)
    np.testing.assert_allclose(r2[0][0].numpy(), r1[0][0].numpy(),
                               atol=1e-8)
    assert not st.warm[0].requires_grad


def test_warm_start_dropped_when_composition_changes():
    """(la) then (la, lb): lb shares the bucket, the composition changed,
    so the step starts cold — exactly a fresh scheduler's step."""
    la, lb = _proj_layer(ct, 6, device="cpu"), _proj_layer(ct, 6, device="cpu")
    v = _t(rng.standard_normal((4, 6)))
    w = _t(rng.standard_normal((4, 6)))
    sched = BucketScheduler()
    r1 = sched.step([(la, (v,))])
    r2 = sched.step([(la, (v,)), (lb, (w,))])
    cold = BucketScheduler().step([(la, (v,)), (lb, (w,))])
    for (got,), (want,) in zip(r2, cold):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_allclose(r2[0][0].numpy(), r1[0][0].numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(r2[1][0].numpy(), lb(w)[0].numpy(),
                               atol=1e-8)


def test_warm_start_off_never_carries():
    la = _proj_layer(ct, 6, device="cpu")
    v = _t(rng.standard_normal((4, 6)))
    sched = BucketScheduler(warm_start=False)
    r1 = sched.step([(la, (v,))])
    r2 = sched.step([(la, (v,))])
    np.testing.assert_array_equal(r1[0][0].numpy(), r2[0][0].numpy())
    (st,) = sched._buckets.values()
    assert st.warm is None


def test_grad_through_scheduler():
    la = _proj_layer(ct, 5, device="cpu")
    v = rng.standard_normal(5)
    sched = BucketScheduler(warm_start=False)

    def f(p):
        return (sched.step([(la, (p,))])[0][0] ** 2).sum()

    vt = _t(v).requires_grad_()
    f(vt).backward()
    eps = 1e-6
    for i in range(3):
        e = np.zeros(5)
        e[i] = eps
        fd = (float(f(_t(v + e))) - float(f(_t(v - e)))) / (2 * eps)
        assert abs(float(vt.grad[i]) - fd) < 1e-4
    vd = _t(v).requires_grad_()
    (la(vd)[0] ** 2).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), vd.grad.numpy(), atol=1e-8)


def test_submit_and_flush_fill_tickets_in_order():
    la, lb = _proj_layer(ct, 4, device="cpu"), _box_layer(ct, 4, device="cpu")
    sched = BucketScheduler()
    params = [_t(rng.standard_normal((2, 4))), _t(rng.standard_normal(4)),
              _t(rng.standard_normal((3, 4)))]
    tickets = [sched.submit(la, (params[0],)), sched.submit(lb, (params[1],)),
               sched.submit(la, (params[2],))]
    assert all(t.result is None for t in tickets)
    assert [t.batch for t in tickets] == [2, None, 3]
    sched.flush()
    assert sched._queue == []
    for t, p in zip(tickets, params):
        np.testing.assert_allclose(t.result[0].numpy(),
                                   t.layer(p)[0].numpy(), atol=1e-8)
    stats = sched.stats()
    assert sorted((s["capacity"], s["flushes"]) for s in stats.values()) == [
        (1, 1), (8, 1)]
    assert all(k[0] == torch.device("cpu") for k in stats)


def test_padded_capacity_matches_solve_bucketed():
    """The rows the capacity class pads with change no result: a step at
    capacity 8 equals solve_bucketed padded to 8."""
    la = _proj_layer(ct, 4, device="cpu")
    v = _t(rng.standard_normal((5, 4)))
    (out,) = BucketScheduler().step([(la, (v,))])[0]
    (ref,) = solve_bucketed([(la, (v,))], pad_multiple=8)[0]
    assert out.shape == (5, 4)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-12)


def test_unbatched_item_and_batch_of_one_keep_their_shapes():
    """Two items of one layer in one bucket: an unbatched instance comes
    back unbatched, a batch of one keeps its axis (the layer's own
    batching contract); stats count the rows of both."""
    la = _proj_layer(ct, 4, device="cpu")
    u = _t(rng.standard_normal(4))
    b1 = _t(rng.standard_normal((1, 4)))
    sched = BucketScheduler()
    (xu,), (xb,) = sched.step([(la, (u,)), (la, (b1,))])
    assert xu.shape == (4,) and xb.shape == (1, 4)
    np.testing.assert_allclose(xu.numpy(), la(u)[0].numpy(), atol=1e-8)
    np.testing.assert_allclose(xb.numpy(), la(b1)[0].numpy(), atol=1e-8)
    (st,) = sched.stats().values()
    assert (st["capacity"], st["occupancy"]) == (2, 1.0)
