"""The port's stopping rule and frozen-lane loop (solver/stopping.py).

Every first-order solver and the polish decide a lane's status through
these functions, and every solver but the shared route iterates through
`run_lanes`; the solver tests hold the whole solves against the
reference. Here, on small tensors with no reference: the loop freezes a
stopped lane bit for bit and ends on the trip after the last lane
stops, the IPM counts one `ipm_trips` (and opens one `ipm.iteration`
span) per trip, and each verdict function gives the answer its
definition gives on hand-made inputs.
"""

import numpy as np
import pytest
import torch

from cvxpylayers_tpu_torch.cones.dims import ConeDims
from cvxpylayers_tpu_torch.cones.projections import make_cone_projector
from cvxpylayers_tpu_torch.solver import stopping
from cvxpylayers_tpu_torch.solver.ipm import make_ipm_solver
from cvxpylayers_tpu_torch.solver.settings import (
    DUAL_INFEASIBLE,
    MAX_ITERS,
    PRIMAL_INFEASIBLE,
    SOLVED,
    SolverSettings,
)
from cvxpylayers_tpu_torch.utils import profiling

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)


def _leaves(state):
    if isinstance(state, tuple):
        return [t for part in state for t in _leaves(part)]
    return [state]


def test_run_lanes_freezes_each_lane_and_ends_after_the_last():
    # lane k stops (SOLVED) on trip stop[k]; lane 3 runs into max_iters
    stop = torch.tensor([2, 5, 1, 99], dtype=torch.int32)
    max_iters = 7
    seen = []
    trips = []

    def body(v, best, it, status):
        trips.append(1)
        v = v * 1.5 + torch.arange(3.0) / 7
        it = it + 1
        status = torch.where(it >= stop, SOLVED, MAX_ITERS).to(torch.int32)
        return v, (v.sum(-1), v[:, :1] * 3), it, status

    def active_of(state):
        seen.append(state)
        return stopping.unfinished(max_iters)(state)

    state = (torch.ones(4, 3, dtype=torch.float64) / 3,
             (torch.zeros(4, dtype=torch.float64),
              torch.zeros(4, 1, dtype=torch.float64)),
             torch.zeros(4, dtype=torch.int32),
             torch.full((4,), MAX_ITERS, dtype=torch.int32))
    v, best, it, status = stopping.run_lanes(body, state, active_of)

    assert it.tolist() == [2, 5, 1, 7]
    assert status.tolist() == [SOLVED, SOLVED, SOLVED, MAX_ITERS]
    # one trip per iteration of the slowest lane, and one last look that
    # finds no lane active
    assert len(trips) == 7 and len(seen) == 8
    for k, last in enumerate(it.tolist()):
        for later in seen[last:]:
            for a, b in zip(_leaves(seen[last]), _leaves(later)):
                assert torch.equal(a[k], b[k])
        # and it moved on every trip before
        assert not torch.equal(seen[last - 1][0][k], seen[last][0][k])
    assert torch.equal(v, seen[-1][0])
    assert torch.equal(best[1], seen[-1][1][1])


def test_run_lanes_with_no_active_lane_runs_no_trip():
    state = (torch.zeros(3), torch.zeros(3, dtype=torch.int32),
             torch.full((3,), SOLVED, dtype=torch.int32))

    def body(*_):
        raise AssertionError("no trip expected")

    out = stopping.run_lanes(body, state, stopping.unfinished(10))
    assert all(a is b for a, b in zip(out, state))


def _box_qp(lp):
    r = np.random.default_rng(5)
    B, n = 4, 3
    P = np.zeros((B, n, n)) if lp else np.eye(n)[None].repeat(B, 0)
    A = np.concatenate([np.eye(n), -np.eye(n)])[None].repeat(B, 0)
    b = np.ones((B, 2 * n))
    q = r.standard_normal((B, n))
    zeros = (np.zeros((B, n)), np.zeros((B, 2 * n)), np.zeros((B, 2 * n)))
    return [torch.as_tensor(a) for a in (P, q, A, b) + zeros]


@pytest.mark.parametrize("hsde", [False, True], ids=["pd", "hsde"])
def test_ipm_counts_one_trip_and_one_span_per_trip(hsde):
    solve = make_ipm_solver(ConeDims(nonneg=6), 3, SolverSettings(),
                            hsde=hsde)
    with profiling.recording("cpu") as rec:
        res = solve(*_box_qp(lp=hsde))
    assert (res.status == SOLVED).all()
    trips = rec.counts["ipm_trips"]
    # the loop runs until its slowest lane stops
    assert trips == int(res.iters.max()) > 1
    assert sum(name == "ipm.iteration" for name, *_ in rec.marks) == trips


def _products(seed, B=3, n=4, m=5):
    r = np.random.default_rng(seed)
    return [torch.as_tensor(r.standard_normal(shape)) for shape in
            ((B, m), (B, m), (B, m), (B, n), (B, n), (B, n), (B, n),
             (B, m))]


def test_kkt_scales_without_p_equal_those_of_a_zero_p():
    Ax, s, b, _, Aty, q, x, y = _products(1)
    without = stopping.kkt_scales(Ax, s, b, None, Aty, q, x, y)
    with_zero = stopping.kkt_scales(Ax, s, b, torch.zeros_like(x), Aty, q,
                                    x, y)
    for a, z in zip(without, with_zero):
        assert torch.equal(a, z)


def test_kkt_scales_follow_their_definitions_and_read_f():
    Ax, s, b, Px, Aty, q, x, y = _products(2)
    sc = stopping.kkt_scales(Ax, s, b, Px, Aty, q, x, y)

    def amax(*vs):
        return torch.stack([v.abs().amax(-1) for v in vs]).amax(0)

    xPx = (x * Px).sum(-1)
    pobj = 0.5 * xPx + (q * x).sum(-1)
    dobj = -0.5 * xPx - (b * y).sum(-1)
    want = dict(r_p=amax(Ax + s - b), p_sc=amax(Ax, s, b),
                r_d=amax(Px + q + Aty), d_sc=amax(Px, Aty, q),
                gap=(pobj - dobj).abs(),
                g_sc=torch.maximum(pobj.abs(), dobj.abs()), pobj=pobj)
    for k, v in want.items():
        torch.testing.assert_close(getattr(sc, k), v, rtol=1e-15, atol=0)
    # given F = [dual; primal], its parts are the residuals
    F = torch.cat([torch.full_like(x, -2.0), torch.full_like(s, 3.0)], -1)
    sf = stopping.kkt_scales(Ax, s, b, Px, Aty, q, x, y, F=F)
    assert sf.r_d.tolist() == [2.0] * 3 and sf.r_p.tolist() == [3.0] * 3
    assert all(torch.equal(getattr(sf, k), getattr(sc, k))
               for k in ("p_sc", "d_sc", "gap", "g_sc", "pobj"))


def test_epoch_status_orders_solved_primal_dual_max_iters():
    flags = torch.tensor([[c, p, d] for c in (0, 1) for p in (0, 1)
                          for d in (0, 1)], dtype=torch.bool)
    status = stopping.epoch_status(flags[:, 0], flags[:, 1], flags[:, 2])
    want = [SOLVED if c else PRIMAL_INFEASIBLE if p else
            DUAL_INFEASIBLE if d else MAX_ITERS
            for c, p, d in flags.tolist()]
    assert status.dtype == torch.int32 and status.tolist() == want


def test_certified_keeps_infeasibility_verdicts():
    base = torch.tensor([SOLVED, MAX_ITERS, PRIMAL_INFEASIBLE,
                         DUAL_INFEASIBLE] * 2, dtype=torch.int32)
    zero, one = torch.zeros(8), torch.ones(8)
    # lanes 0-3 meet eps_abs = 1e-8 on every term, lanes 4-7 miss it on
    # the gap alone
    gap = torch.cat([torch.zeros(4), torch.full((4,), 1e-3)])
    sc = stopping.Scales(zero, one, zero, one, gap, one, zero)
    st = SolverSettings()
    status = stopping.certified(base, sc, st)
    assert status.tolist() == [SOLVED, SOLVED, PRIMAL_INFEASIBLE,
                               DUAL_INFEASIBLE, MAX_ITERS, MAX_ITERS,
                               PRIMAL_INFEASIBLE, DUAL_INFEASIBLE]
    # an infinite gap scale drops the gap term
    assert stopping.certified(base, sc, st.replace(
        eps_gap_scale=float("inf")))[4:6].tolist() == [SOLVED, SOLVED]


def test_banjac_certifies_rays_and_nothing_below_the_threshold():
    # K = R^2_+, A = I (2x2), P = diag(0, 1): dy = (1, 0) >= 0 with
    # b'dy < 0 is a primal ray up to A'dy; dx = (-1, 0) has A dx in -K,
    # P dx = 0 and q'dx < 0
    proj = make_cone_projector(ConeDims(nonneg=2))
    A = torch.eye(2, dtype=torch.float64)
    P = torch.diag(torch.tensor([0.0, 1.0], dtype=torch.float64))
    b = torch.tensor([[-1.0, 1.0]] * 3, dtype=torch.float64)
    q = torch.tensor([[1.0, 0.0]] * 3, dtype=torch.float64)
    eps = 1e-9
    # lane 0: both rays with A'dy ~ 0 (A'dy tiny against dy); lane 1:
    # differences below 10 eps; lane 2: dx along P's range
    dy = torch.tensor([[1.0, 0.0], [1e-9, 0.0], [1.0, 0.0]],
                      dtype=torch.float64)
    dx = torch.tensor([[-1.0, 0.0], [-1e-9, 0.0], [0.0, -1.0]],
                      dtype=torch.float64)
    Atdy = torch.zeros_like(dy)
    pinf, dinf = stopping.banjac(dx, dy, Atdy, dx @ A.T, dx @ P.T, b, q,
                                 proj, eps)
    assert pinf.tolist() == [True, False, True]
    assert dinf.tolist() == [True, False, False]
    # P = 0 (None): lane 2's direction still fails q'dx < 0
    _, dinf0 = stopping.banjac(dx, dy, Atdy, dx @ A.T, None, b, q, proj,
                               eps)
    assert dinf0.tolist() == [True, False, False]
    # A'dy away from 0 refuses the primal certificate
    pinf1, _ = stopping.banjac(dx, dy, dy, dx @ A.T, None, b, q, proj, eps)
    assert not pinf1.any()


def test_rho_steps_only_outside_the_band_and_stays_clamped():
    st = SolverSettings()
    one = torch.ones(4, dtype=torch.float64)
    # r_p / p_sc over r_d / d_sc: 1, 16, 1/1e4 (clamped to 1/10), 1e6
    sc = stopping.Scales(torch.tensor([1.0, 16.0, 1e-4, 1e6]), one,
                         one, one, one, one, one)
    ratio = stopping.rho_ratio(sc, st)
    torch.testing.assert_close(
        ratio, torch.tensor([1.0, 4.0, 0.1, 10.0], dtype=torch.float64))
    rho = torch.tensor([[0.1, 100.0]] * 4, dtype=torch.float64)
    rho = stopping.rho_step(rho, ratio[:, None], st)
    torch.testing.assert_close(rho, torch.tensor(
        [[0.1, 100.0], [0.1, 100.0], [0.01, 10.0], [1.0, 1000.0]],
        dtype=torch.float64))
    big = stopping.rho_step(torch.tensor([5e5]), torch.tensor(10.0), st)
    assert big.tolist() == [st.rho_max]
