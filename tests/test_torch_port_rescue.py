"""The port's solve_with_rescue against the reference's.

A fast route solves the batch, then each rescue stage re-solves up to
`capacity` failed lanes with accurate settings and writes them back. The
same numpy-seeded box-QP batches go through the reference's
`solve_with_rescue` and the port's on the CPU in f64: statuses and
iteration counts must be equal lane for lane, outputs agree to 1e-8 and
gradients to 1e-6. The contracts are those of tests/test_rescue.py: a
no-op on a solved batch, rescued lanes equal to the accurate route's
direct solve, the capacity bound, MAX_ITERS ranked above an infeasible
verdict, a two-stage ladder, warm rescue, the refusals, and gradients
split by route. The port adds the tie case (more MAX_ITERS lanes than
capacity, the reference's lanes are rescued) and a rescue whose fast
stage is the IPM and whose rescue stage is ADMM.

The reference runs once per module, in one configuration that touches
every contract it is held to: a warm two-stage ladder behind a fast ADMM
route, with gradients, vmapped over the three data sets. Contracts that
need another configuration (a rescue of every lane, an interior-point
fast stage, a cold rescue) are held against the port's own direct
solves. The last test holds the port's f32 gradient of the box-QP rescue
row's borderline lane to the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu_torch.solver import admm as admm_module
from cvxpylayers_tpu_torch.solver import cuda_admm, cuda_linalg
from cvxpylayers_tpu_torch.solver import ipm as ipm_module
from cvxpylayers_tpu_torch.solver.settings import (
    MAX_ITERS,
    PRIMAL_INFEASIBLE,
    SOLVED,
)

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-8
_GRAD_ATOL = 1e-6
_B = 6

GOOD = {"eps_abs": 1e-7, "eps_rel": 1e-7, "max_iters": 200, "epoch": 50,
        "refine_steps": 6}
# one ADMM iteration and no polish at a 1e-7 target: every lane fails
BAD = {"eps_abs": 1e-7, "eps_rel": 1e-7, "max_iters": 1, "epoch": 1,
       "refine_steps": 0}
# 60 ADMM iterations to 1e-8 and no polish: an easy batch is solved, the
# random batch has MAX_ITERS lanes a warm rescue can continue, and an
# infeasible lane gets its certificate
FAST = {"eps_abs": 1e-7, "eps_rel": 1e-7, "admm_eps_abs": 1e-8,
        "admm_eps_rel": 1e-8, "max_iters": 60, "epoch": 10,
        "refine_steps": 0}
# three interior-point iterations and no polish: every lane fails
IPM_FAST = {"solve_method": "ipm", "eps_abs": 1e-7, "eps_rel": 1e-7,
            "ipm_max_iters": 3, "refine_steps": 0}
# a two-stage ADMM ladder whose first stage is as crippled as BAD: it
# leaves its two lanes unsolved, so the second stage takes the same two
LADDER = [dict(BAD), GOOD]

# name -> (fast route, rescue stages, capacity, warm, with gradients)
CONFIGS = {
    # FAST leaves lanes 0, 2 and 4 of VALS at MAX_ITERS: three tied
    # lanes for a capacity of two; both stages start from the fast
    # route's iterates
    "ladder": (FAST, LADDER, 2, True, True),
    "cold": (FAST, LADDER, 2, False, False),
    "full": (BAD, GOOD, _B, False, False),
    "ipm_ladder": (IPM_FAST, LADDER, 2, False, False),
}


def box_qp(mod, n=4, m_ineq=3, **kw):
    x = mod.Variable(n)
    v = mod.Parameter(n)
    G = mod.Parameter((m_ineq, n))
    h = mod.Parameter(m_ineq)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [G @ x <= h, x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v, G, h], variables=[x], **kw)


def qp_values(seed=0, infeasible_lane=None, easy=False):
    r = np.random.default_rng(seed)
    v = r.standard_normal((_B, 4))
    G = r.standard_normal((_B, 3, 4)) * 0.3
    h = np.abs(r.standard_normal((_B, 3))) + 1.0
    if easy:
        # x = v inside the box, every constraint slack
        v = 0.2 + 0.6 * r.random((_B, 4))
        h += 2.0
    if infeasible_lane is not None:
        # sum(x) <= -1 with x >= 0: primal infeasible
        G[infeasible_lane] = 1.0
        h[infeasible_lane] = -1.0
    return [v, G, h]


DATA = {"vals": qp_values(0), "infeasible": qp_values(1, infeasible_lane=1),
        "easy": qp_values(2, easy=True)}
VALS = DATA["vals"]


# configuration -> the data sets the tests read the reference's on
REF_RUNS = {"ladder": ("vals", "infeasible", "easy")}


@functools.lru_cache(maxsize=None)
def _reference():
    """Every run of REF_RUNS from one jitted function, compiled once per
    module: each entry is (outs, status, iters), or (gradients of
    sum(x^2), (outs, status, iters)) where the configuration asks for
    gradients. A configuration read on several data sets runs once,
    vmapped over them."""
    lj = box_qp(cj)

    def run(config, *ps):
        fast, stages, cap, warm, grad = CONFIGS[config]

        def rescue(*ps):
            return cj.solve_with_rescue(lj, *ps, solver_args=fast,
                                        rescue_args=stages, capacity=cap,
                                        warm_start_rescue=warm)

        def loss(*ps):
            res = rescue(*ps)
            return jnp.sum(res[0][0] ** 2), res

        if grad:
            return jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(*ps)
        return rescue(*ps)

    def everything(data):
        out = {}
        for config, names in REF_RUNS.items():
            stacked = [jnp.stack(ps) for ps in zip(*(data[k] for k in names))]
            res = jax.vmap(functools.partial(run, config))(*stacked)
            for i, name in enumerate(names):
                out[config, name] = jax.tree_util.tree_map(
                    lambda a, i=i: a[i], res)
        return out

    out = jax.jit(everything)(
        {k: [jnp.asarray(a) for a in v] for k, v in DATA.items()})
    return jax.tree_util.tree_map(np.asarray, out)


def ref(config, data="vals"):
    return _reference()[config, data]


def port(config, data="vals", dtype=torch.float64):
    fast, stages, cap, warm, _ = CONFIGS[config]
    layer = box_qp(ct, device="cpu")
    return layer, ct.solve_with_rescue(
        layer, *_t(DATA[data], dtype=dtype), solver_args=fast,
        rescue_args=stages, capacity=cap, warm_start_rescue=warm)


def _t(vals, grad=False, dtype=torch.float64):
    return [torch.as_tensor(a, dtype=dtype).requires_grad_(grad)
            for a in vals]


def _assert_same(ref_res, got, atol=_ATOL):
    (oj, sj, ij), (ot, st, it) = ref_res, got
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(it.numpy(), ij)
    for a, b in zip(oj, ot):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(b.detach().numpy(), a, atol=atol, rtol=0)


def _grads(vals, fn):
    ps = _t(vals, grad=True)
    outs, st, it = fn(*ps)
    (outs[0] ** 2).sum().backward()
    return [p.grad.numpy() for p in ps], (outs, st, it)


def _rescued(got, data="vals"):
    """The lanes a rescue changed: their counts grew past the fast
    route's."""
    fast = CONFIGS["ladder"][0]
    _, _, it_fast = box_qp(ct, device="cpu").solve_with_info(
        *_t(DATA[data]), solver_args=fast)
    return np.flatnonzero((got[2] != it_fast).numpy())


def test_noop_when_every_lane_is_solved():
    lt, got = port("ladder", "easy")
    _assert_same(ref("ladder", "easy")[1], got)
    assert got[1].tolist() == [SOLVED] * _B
    # the skipped stages leave the fast route's results as they were
    (x,), st, it = lt.solve_with_info(*_t(DATA["easy"]), solver_args=FAST)
    assert torch.equal(got[0][0], x) and torch.equal(got[2], it)


def test_rescued_lanes_equal_the_accurate_route():
    lt, got = port("full")
    assert got[1].tolist() == [SOLVED] * _B
    (x,), _, it_good = lt.solve_with_info(*_t(VALS), solver_args=GOOD)
    np.testing.assert_allclose(got[0][0].numpy(), x.numpy(), atol=_ATOL,
                               rtol=0)
    # iterations add up: the fast route's plus the rescue's
    _, _, it_bad = lt.solve_with_info(*_t(VALS), solver_args=BAD)
    assert torch.equal(got[2], it_bad + it_good)
    # the reference's ladder rescues its lanes to the same solutions
    (xj,), _, _ = ref("ladder")[1]
    lanes = _rescued(port("ladder")[1])
    np.testing.assert_allclose(xj[lanes], x[lanes].numpy(), atol=_ATOL,
                               rtol=0)


def test_capacity_bounds_the_rescue():
    lt, got = port("ladder")
    _, st_fast, _ = lt.solve_with_info(*_t(VALS), solver_args=FAST)
    assert st_fast.tolist() == [MAX_ITERS, SOLVED] * 3
    _assert_same(ref("ladder")[1], got)
    st = got[1]
    assert int((st == SOLVED).sum()) == 3 + 2
    assert st.tolist()[4] == MAX_ITERS  # an honest failure beyond capacity


def test_ties_rescue_the_reference_lanes():
    # three MAX_ITERS lanes tie for a capacity of two: the reference's
    # top_k takes the lowest indices, and so must the port (torch.topk
    # promises no order among ties)
    _, got = port("ladder")
    rescued = _rescued(got)
    _, _, it_fast = box_qp(ct, device="cpu").solve_with_info(
        *_t(VALS), solver_args=FAST)
    np.testing.assert_array_equal(
        np.flatnonzero(ref("ladder")[1][2] != it_fast.numpy()), rescued)
    np.testing.assert_array_equal(rescued, [0, 2])
    # ties among MAX_ITERS lanes beside other verdicts: score 2 + 1 first,
    # in the order of the lanes, then the infeasible lane
    status = torch.tensor([SOLVED, MAX_ITERS, PRIMAL_INFEASIBLE, MAX_ITERS,
                           MAX_ITERS, SOLVED], dtype=torch.int32)
    score = (status == MAX_ITERS).int() * 2 + (status != SOLVED).int()
    order = torch.sort(score, descending=True, stable=True).indices
    top = jax.lax.top_k(jnp.asarray(score.numpy()), 4)[1]
    np.testing.assert_array_equal(order[:4].numpy(), np.asarray(top))


def test_max_iters_ranked_above_infeasible():
    lt, got = port("ladder", "infeasible")
    _, st_fast, _ = lt.solve_with_info(*_t(DATA["infeasible"]),
                                       solver_args=FAST)
    assert st_fast[1] == PRIMAL_INFEASIBLE
    assert int((st_fast == MAX_ITERS).sum()) > 2  # more than capacity
    _assert_same(ref("ladder", "infeasible")[1], got)
    st = got[1]
    assert st[1] == PRIMAL_INFEASIBLE  # kept its verdict
    assert int(((st_fast == MAX_ITERS) & (st == SOLVED)).sum()) == 2


def test_two_stage_ladder_after_an_interior_point_fast_stage():
    # every lane fails the IPM fast stage; ladder stage 1 (as crippled as
    # BAD) leaves its two lanes unsolved, so stage 2 takes the same two
    # lanes and solves them: their counts are 3 + 1 + the accurate route's
    lt, got = port("ipm_ladder")
    (x,), _, it_good = lt.solve_with_info(*_t(VALS), solver_args=GOOD)
    assert got[1].tolist() == [SOLVED] * 2 + [MAX_ITERS] * (_B - 2)
    assert got[2].tolist() == (3 + 1 + it_good[:2]).tolist() + [3] * (_B - 2)
    np.testing.assert_allclose(got[0][0][:2].numpy(), x[:2].numpy(),
                               atol=_ATOL, rtol=0)
    # the same ladder behind the fast ADMM route: cold, its counts add
    # up as above; warm, as the reference runs it, it ends where the
    # reference's does
    _, cold = port("cold")
    _, _, it_fast = lt.solve_with_info(*_t(VALS), solver_args=FAST)
    lanes = [0, 2]
    assert cold[1].tolist() == [SOLVED] * 4 + [MAX_ITERS, SOLVED]
    np.testing.assert_array_equal(
        cold[2].numpy()[lanes], (it_fast + 1 + it_good).numpy()[lanes])
    _, warm = port("ladder")
    assert torch.equal(warm[1], cold[1])
    np.testing.assert_array_equal(ref("ladder")[1][2], warm[2].numpy())


def test_warm_rescue_matches_reference():
    for data in DATA:
        _, got = port("ladder", data)
        _assert_same(ref("ladder", data)[1], got)
    assert int((got[1] == SOLVED).sum()) >= 4


def test_warm_rescue_takes_fewer_iterations_than_cold():
    # the warm rescue continues the fast route's ADMM from its last
    # iterates instead of starting over
    _, cold = port("cold")
    _, warm = port("ladder")
    assert torch.equal(cold[1], warm[1])
    warm_iters = int(ref("ladder")[1][2].sum())
    assert warm_iters == int(warm[2].sum()) < int(cold[2].sum())


def test_unbatched_call_and_empty_capacity_raise_the_reference_errors():
    lt, lj = box_qp(ct, device="cpu"), box_qp(cj)
    single = [a[0] for a in VALS]
    for mod, layer, ps in ((ct, lt, _t(single)),
                           (cj, lj, [jnp.asarray(a) for a in single])):
        with pytest.raises(ValueError, match="needs a batched call"):
            mod.solve_with_rescue(layer, *ps, solver_args=GOOD,
                                  rescue_args=GOOD)
    for cap in (0, -3):
        msgs = []
        for mod, layer, ps in ((ct, lt, _t(VALS)),
                               (cj, lj, [jnp.asarray(a) for a in VALS])):
            with pytest.raises(ValueError) as err:
                mod.solve_with_rescue(layer, *ps, solver_args=GOOD,
                                      rescue_args=GOOD, capacity=cap)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] == f"capacity must be positive, got {cap}"


def test_gradients_equal_the_single_route():
    lt = box_qp(ct, device="cpu")
    g_r, _ = _grads(VALS, lambda *ps: ct.solve_with_rescue(
        lt, *ps, solver_args=BAD, rescue_args=GOOD, capacity=_B))
    g_d, _ = _grads(VALS, lambda *ps: lt.solve_with_info(
        *ps, solver_args=GOOD))
    # the lanes the reference's ladder rescued carry the accurate route's
    # gradients there too
    lanes = _rescued(port("ladder")[1])
    for a, gj, gd in zip(g_r, ref("ladder")[0], g_d):
        np.testing.assert_allclose(a, gd, atol=_GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(gj[lanes], gd[lanes], atol=_GRAD_ATOL,
                                   rtol=0)


def test_partial_rescue_gradients_split_by_route():
    lt = box_qp(ct, device="cpu")
    g_r, got = _grads(VALS, lambda *ps: ct.solve_with_rescue(
        lt, *ps, solver_args=FAST, rescue_args=LADDER, capacity=2,
        warm_start_rescue=True))
    g_fast, _ = _grads(VALS, lambda *ps: lt.solve_with_info(
        *ps, solver_args=FAST))
    g_good, _ = _grads(VALS, lambda *ps: lt.solve_with_info(
        *ps, solver_args=GOOD))
    rescued = np.isin(np.arange(_B), _rescued(got))
    assert rescued.sum() == 2
    for a, gj, gf, gg in zip(g_r, ref("ladder")[0], g_fast, g_good):
        np.testing.assert_allclose(a, gj, atol=_GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(a[rescued], gg[rescued],
                                   atol=_GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(a[~rescued], gf[~rescued],
                                   atol=_GRAD_ATOL, rtol=0)


def test_f32_ipm_fast_stage_runs_k2_and_the_rescue_k1_plain_versions(
        monkeypatch):
    # in f32 the IPM fast stage factors through K2's plain version on the
    # whole batch, and the ADMM rescue stages step through K1's plain
    # version on the two-lane sub-batch; the f32 run keeps the f64 run's
    # verdicts and counts
    _, ((x64,), st64, it64) = port("ipm_ladder")
    qr_batches, epoch_batches = [], []
    monkeypatch.setattr(ipm_module, "qr_r", lambda M: (
        qr_batches.append(M.shape[0]), cuda_linalg.qr_r(M))[1])
    monkeypatch.setattr(admm_module, "polyhedral_inner_epoch",
                        lambda *a, **kw: (epoch_batches.append(a[0].shape[0]),
                                          cuda_admm.polyhedral_inner_epoch(
                                              *a, **kw))[1])
    launches = (cuda_admm.LAUNCHES, cuda_linalg.LAUNCHES)
    _, ((x32,), st32, it32) = port("ipm_ladder", dtype=torch.float32)
    assert (cuda_admm.LAUNCHES, cuda_linalg.LAUNCHES) == launches
    assert qr_batches and set(qr_batches) == {_B}
    assert epoch_batches and set(epoch_batches) == {2}
    assert x32.dtype == torch.float32
    assert torch.equal(st32, st64)
    assert torch.equal(it32[2:], it64[2:])
    solved = st64 == SOLVED
    np.testing.assert_allclose(x32[solved].numpy(), x64[solved].numpy(),
                               atol=1e-4, rtol=0)


def test_rescue_leaves_the_eager_warm_cache_alone():
    lt = box_qp(ct, device="cpu")
    lt(*_t(VALS), solver_args=GOOD, warm_start=True)
    cached = lt._warm
    for warm in (True, False):
        ct.solve_with_rescue(lt, *_t(VALS), solver_args=BAD,
                             rescue_args=GOOD, capacity=2,
                             warm_start_rescue=warm)
    assert lt._warm is cached


def test_unbatched_parameters_pass_through_to_the_sub_batch():
    # G and h unbatched broadcast over the batch; the rescue gathers only
    # the batched v, and gives what the fully batched call gives
    lt = box_qp(ct, device="cpu")
    v, G, h = _t(VALS)
    mixed = ct.solve_with_rescue(lt, v, G[0], h[0], solver_args=BAD,
                                 rescue_args=GOOD, capacity=3)
    full = ct.solve_with_rescue(lt, v, G[0].expand_as(G), h[0].expand_as(h),
                                solver_args=BAD, rescue_args=GOOD,
                                capacity=3)
    assert torch.equal(mixed[0][0], full[0][0])
    assert torch.equal(mixed[1], full[1]) and torch.equal(mixed[2], full[2])
    assert int((mixed[1] == SOLVED).sum()) == 3


def test_f32_gradient_of_the_box_qp_rescue_rows_borderline_lane():
    # bench.py's box_qp_ipm row rescues through ADMM with 5 Schur-CG steps
    # in the adjoint. On the lane of the chip-check box-QP batch (seed 11,
    # third call, lane 322) that the IPM leaves unsolved in f32, those 5
    # steps leave the f32 gradient 6-13 % off the f64 one in both
    # packages alike; the default count (20 at n = 50) reaches it
    r = np.random.default_rng(11)
    for _ in range(3):
        vals = [r.standard_normal((1024, 50)),
                r.standard_normal((1024, 20, 50)) * 0.3,
                np.abs(r.standard_normal((1024, 20))) + 1.0]
    vals = [a[322:323] for a in vals]
    row = {"eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-3,
           "admm_eps_rel": 1e-3, "max_iters": 50, "epoch": 50,
           "refine_steps": 5, "schur_iters": 5}
    default = {k: v for k, v in row.items() if k != "schur_iters"}
    lj, lt = box_qp(cj, n=50, m_ineq=20), box_qp(ct, n=50, m_ineq=20,
                                                   device="cpu")

    def loss(*ps):
        (x,), status, _ = lj.solve_with_info(*ps, solver_args=row)
        return jnp.sum(x), status

    g_ref, status = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a, jnp.float32) for a in vals))
    assert g_ref[0].dtype == jnp.float32 and status.tolist() == [SOLVED]

    def grads(args, dtype):
        ps = _t(vals, grad=True, dtype=dtype)
        (x,), status, _ = lt.solve_with_info(*ps, solver_args=args)
        assert status.tolist() == [SOLVED]
        x.sum().backward()
        return [p.grad.double().numpy() for p in ps]

    g64 = grads(row, torch.float64)
    g32, g32_default = grads(row, torch.float32), grads(default, torch.float32)
    for gj, a, b, c in zip(g_ref, g32, g32_default, g64):
        scale = np.abs(c).max()
        np.testing.assert_allclose(a, np.asarray(gj), atol=1e-4 * scale,
                                   rtol=0)
        assert np.abs(a - c).max() > 5e-2 * scale
        np.testing.assert_allclose(b, c, atol=1e-5 * scale, rtol=0)
