"""Primal-dual hybrid gradient (PDHG / Chambolle-Pock) for conic LPs, batched.

Counterpart of cvxpylayers_tpu/solver/pdhg.py. First-order like ADMM but
with no linear solve at all: every iteration is two matvecs and one cone
projection.

    minimize    q'x
    subject to  A x + s = b,  s in K          (P must be structurally 0)

Chambolle-Pock on the saddle  min_x max_{y in K*}  q'x + y'(Ax - b):

    x+ = x - tau (q + A'y)
    y+ = Pi_{K*}( y + sigma (A (2x+ - x) - b) )

with tau = sigma = 0.9 / ||A||_2 (12 rounds of power iteration, times a
1.1 safety factor) and Halpern-style iterate averaging inside each epoch.
At every epoch boundary the lane keeps whichever of {last iterate,
average} has the smaller combined residual (the restart of raPDHG); the
residuals with the duality gap, the Banjac certificates and the statuses
follow solver/admm.py, and a finished lane is frozen. The semismooth-
Newton polish owns the final accuracy, as it does for ADMM.

`make_pdhg_core` holds the algorithm over two matvec callables, so the
dense solver here and the matrix-free one (solver/matfree.py) run the
same loop: the dense one through batched products, the matrix-free one
through static-pattern sparse matvecs.
"""

from __future__ import annotations

import torch

from ..cones.dims import ConeDims
from ..cones.projections import make_cone_projector, make_inner_projector
from ..utils.precision import full_f32
from .admm import (
    SolveResult,
    _cone_row_groups,
    _ruiz_equilibrate,
    amax_abs,
    bdot,
    bmv,
    bmv_t,
)
from .settings import (
    DUAL_INFEASIBLE,
    MAX_ITERS,
    PRIMAL_INFEASIBLE,
    SOLVED,
    SolverSettings,
)

# power-iteration rounds for the ||A||_2 estimate (fixed: no host read)
_POWER_ITERS = 12


def make_pdhg_core(dims: ConeDims, n: int, settings: SolverSettings,
                   A_mv, A_rmv, equilibrate):
    """solve(P, q, A, b, x0, y0, s0) -> SolveResult over batched data, for
    A_mv(A, x) = A x, A_rmv(A, y) = A'y and
    equilibrate(P, A, q, b) -> (P, A, q, b, D, E, c) (Ruiz) on whatever
    representation of A those three take."""
    m = dims.total
    proj_K = make_cone_projector(dims)
    proj_K_fast = make_inner_projector(dims, settings.psd_proj)
    st = settings

    def solve(P, q, A, b, x0, y0, s0):
        del s0  # PDHG tracks (x, y); s is recovered at the end
        dtype = q.dtype
        B = q.shape[0]
        # f64 keeps the exact projector in the inner loop (solver/admm.py)
        pk_fast = proj_K if dtype == torch.float64 else proj_K_fast
        A0, q0, b0 = A, q, b

        _, As, qs, bs, D, E, c = equilibrate(P, A, q, b)

        # ||A||_2 by power iteration. The estimate converges from below
        # and tau sigma ||A||^2 < 1 is the convergence condition, so 12
        # rounds and a 1.1 safety factor keep a margin even with a ~10 %
        # residual underestimate
        root_n = torch.sqrt(torch.tensor(float(n), dtype=dtype))
        v = q.new_ones(B, n) / root_n.to(q.device)
        for _ in range(_POWER_ITERS):
            w = A_rmv(As, A_mv(As, v))
            v = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1),
                                    1e-30)[:, None]
        a_norm = 1.1 * torch.clamp_min(
            torch.linalg.vector_norm(A_mv(As, v), dim=-1), 1e-12)
        step = (0.9 / a_norm)[:, None]

        x = x0 / D
        y = c[:, None] * y0 / E

        def unscaled(xb, yb):
            return D * xb, (E * yb) / c[:, None]

        def residuals(xb, yb):
            xu, yu = unscaled(xb, yb)
            Ax = A_mv(A0, xu)
            s_u = proj_K(b0 - Ax)
            r_p = amax_abs(Ax + s_u - b0)
            p_sc = torch.maximum(
                amax_abs(Ax), torch.maximum(amax_abs(s_u), amax_abs(b0)))
            Aty = A_rmv(A0, yu)
            r_d = amax_abs(q0 + Aty)
            d_sc = torch.maximum(amax_abs(Aty), amax_abs(q0))
            # duality gap (P = 0): large-LP iterates cannot pass on the
            # residuals alone while far from optimal
            pobj = bdot(q0, xu)
            dobj = -bdot(b0, yu)
            gap = torch.abs(pobj - dobj)
            g_sc = torch.maximum(torch.abs(pobj), torch.abs(dobj))
            return r_p, p_sc, r_d, d_sc, gap, g_sc

        def merit(r_p, p_sc, r_d, d_sc, gap, g_sc):
            # the gap's scale is floored by the residual scales: on a
            # ~zero-objective problem objective noise would otherwise
            # decide the restart
            g_f = torch.maximum(g_sc, torch.maximum(p_sc, d_sc))
            return (r_p / torch.clamp_min(p_sc, 1e-12)
                    + r_d / torch.clamp_min(d_sc, 1e-12)
                    + gap / torch.clamp_min(g_f, 1e-12))

        def epoch_body(x_, y_, it):
            x_prev, y_prev = x_, y_
            xa, ya = x_, y_
            for k in range(st.epoch):
                x_n = x_ - step * (qs + A_rmv(As, y_))
                xbar = 2.0 * x_n - x_
                y_n = y_ + step * (A_mv(As, xbar) - bs)
                y_n = y_n + pk_fast(-y_n)  # Pi_{K*} via Moreau
                # running (Halpern) average, restarted every epoch
                xa = (k * xa + x_n) / (k + 1.0)
                ya = (k * ya + y_n) / (k + 1.0)
                x_, y_ = x_n, y_n
            it = it + st.epoch
            last = residuals(x_, y_)
            avg = residuals(xa, ya)
            use_avg = merit(*avg) < merit(*last)
            x_ = torch.where(use_avg[:, None], xa, x_)
            y_ = torch.where(use_avg[:, None], ya, y_)
            r_p, p_sc, r_d, d_sc, gap, g_sc = (
                torch.where(use_avg, a, l_) for a, l_ in zip(avg, last))

            eps_p = st.admm_eps_abs + st.admm_eps_rel * p_sc
            eps_d = st.admm_eps_abs + st.admm_eps_rel * d_sc
            eps_g = st.eps_gap_scale * (
                st.admm_eps_abs + st.admm_eps_rel * g_sc)
            converged = (r_p <= eps_p) & (r_d <= eps_d) & (gap <= eps_g)

            # infeasibility certificates from the iterate differences
            dxu = D * (x_ - x_prev)
            dyu = (E * (y_ - y_prev)) / c[:, None]
            ny = amax_abs(dyu)
            nx = amax_abs(dxu)
            safe_ny = torch.where(ny > 0, ny, 1.0)
            safe_nx = torch.where(nx > 0, nx, 1.0)
            eps_inf = st.eps_infeas
            Atdy = A_rmv(A0, dyu)
            proj_dual_dy = dyu + proj_K(-dyu)  # Pi_{K*}(dy) via Moreau
            dual_dist = amax_abs(proj_dual_dy - dyu)
            pinf = (
                (ny > 10 * eps_inf)
                & (amax_abs(Atdy) <= eps_inf * safe_ny)
                & (dual_dist <= eps_inf * safe_ny)
                & (bdot(b0, dyu) < -eps_inf * safe_ny)
            )
            Adx = A_mv(A0, dxu)
            rec_dist = amax_abs(-proj_K(-Adx) - Adx)
            dinf = (
                (nx > 10 * eps_inf)
                & (rec_dist <= eps_inf * safe_nx)
                & (bdot(q0, dxu) < -eps_inf * safe_nx)
            )
            status = torch.full_like(it, MAX_ITERS)
            status = torch.where(dinf, DUAL_INFEASIBLE, status)
            status = torch.where(pinf, PRIMAL_INFEASIBLE, status)
            status = torch.where(converged, SOLVED, status).to(torch.int32)
            return x_, y_, it, status

        it = torch.zeros(B, dtype=torch.int32, device=q.device)
        status = torch.full((B,), MAX_ITERS, dtype=torch.int32,
                            device=q.device)
        # one host read per epoch: the gap-aware exit
        while True:
            active = (status == MAX_ITERS) & (it < st.max_iters)
            if not bool(active.any()):
                break
            x_n, y_n, it_n, status_n = epoch_body(x, y, it)
            a1 = active[:, None]
            x = torch.where(a1, x_n, x)
            y = torch.where(a1, y_n, y)
            it = torch.where(active, it_n, it)
            status = torch.where(active, status_n, status)

        xu, yu = unscaled(x, y)
        # s from the constraint, projected into K
        s_u = proj_K(b0 - A_mv(A0, xu)) if m else b0.new_zeros(B, 0)
        return SolveResult(x=xu, y=yu, s=s_u, status=status, iters=it,
                           pobj=bdot(q0, xu))

    return solve


def make_pdhg_solver(dims: ConeDims, n: int, settings: SolverSettings):
    """solve(P, q, A, b, x0, y0, s0) -> SolveResult on dense batched data.
    P is accepted for signature parity and must be structurally zero (the
    derivative wrapper refuses a quadratic objective)."""
    group_ids, n_groups = _cone_row_groups(dims)

    def equilibrate(P, A, q, b):
        return _ruiz_equilibrate(P, A, q, b, group_ids, n_groups,
                                 settings.scaling_iters)

    core = make_pdhg_core(dims, n, settings, bmv, bmv_t, equilibrate)

    def solve(P, q, A, b, x0, y0, s0):
        # every product at full f32: the residuals are cancellations
        with full_f32():
            return core(P, q, A, b, x0, y0, s0)

    return solve
