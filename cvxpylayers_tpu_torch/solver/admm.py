"""Batched conic-QP ADMM solver (dense), on batched torch tensors.

Counterpart of cvxpylayers_tpu/solver/admm.py. Solves

    minimize    (1/2) x'Px + q'x
    subject to  Ax + s = b,  s in K

by OSQP-style operator splitting generalized to cones: the constraint is
Ax in C with C = {v : b - v in K} and Pi_C(u) = b - Pi_K(b - u). Every
array carries the batch axis first (B instances of one structure):

  * Ruiz equilibration with per-cone-block pooling of the row scalings;
  * one factor M^{-1} = (P + sigma I + A' diag(rho) A)^{-1} per epoch
    (batched Cholesky, a library call as in the reference);
  * `epoch` inner steps per factor: for polyhedral cones, the fused
    kernel K1 (solver/cuda_admm.py) on a CUDA tensor, its plain version
    on a CPU tensor; for every other cone, the reference's plain scan in
    batched torch ops, whose f32 projection takes the Newton-Schulz PSD
    approximation (settings.psd_proj) and whose f64 one stays exact;
    with `accel_lookback > 0`, type-II Anderson acceleration of the step
    in batched torch ops instead (the reference's Pallas kernel, like K1,
    computes only the plain scan);
  * residuals with the duality gap, Banjac-style infeasibility
    certificates and adaptive rho at every epoch boundary.

Statuses are returned as codes, never raised. Lanes are frozen once they
finish: the epoch loop keeps an `active` mask, (status == MAX_ITERS) &
(it < max_iters), and updates only active lanes, as the reference's
vmapped while_loop does, so outputs and iteration counts match it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cones.dims import ConeDims
from ..cones.projections import make_cone_projector, make_inner_projector
from ..utils.precision import full_f32
from .batched_linalg import spd_inv_via_chol
from .cuda_admm import polyhedral_inner_epoch
from .settings import (
    DUAL_INFEASIBLE,
    MAX_ITERS,
    PRIMAL_INFEASIBLE,
    SOLVED,
    SolverSettings,
)


class SolveResult(NamedTuple):
    x: torch.Tensor        # primal (B, n)
    y: torch.Tensor        # dual, in K* (B, m)
    s: torch.Tensor        # slack, in K (B, m)
    status: torch.Tensor   # int32 status codes (B,)
    iters: torch.Tensor    # int32 iteration counts (B,)
    pobj: torch.Tensor     # primal objective (excluding constant offset)


def bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: (B, r, c) @ (B, c) -> (B, r)."""
    return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)


def bmv_t(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched transposed product: (B, r, c)' @ (B, r) -> (B, c)."""
    return torch.bmm(v.unsqueeze(1), M).squeeze(1)


def amax_abs(v: torch.Tensor) -> torch.Tensor:
    """max |v| over the last axis, 0 for an empty axis: (B, k) -> (B,)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().amax(dim=-1)


def bdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product over the last axis: (B, k) -> (B,)."""
    return (u * v).sum(dim=-1)


def _cone_row_groups(dims: ConeDims):
    """Row-index -> cone-block id, for pooled (per-block uniform) scaling."""
    gid = np.zeros(dims.total, dtype=np.int64)
    g = 0
    off = 0
    for _ in range(dims.zero):
        gid[off] = g
        off += 1
        g += 1
    for _ in range(dims.nonneg):
        gid[off] = g
        off += 1
        g += 1
    for d in dims.soc:
        gid[off:off + d] = g
        off += d
        g += 1
    for _ in range(dims.exp):
        gid[off:off + 3] = g
        off += 3
        g += 1
    for sdim in dims.psd:
        d = sdim * (sdim + 1) // 2
        gid[off:off + d] = g
        off += d
        g += 1
    for _ in dims.pow3:
        gid[off:off + 3] = g
        off += 3
        g += 1
    return gid, g


def _ruiz_equilibrate(P, A, q, b, group_ids, n_groups, iters: int):
    """Modified Ruiz equilibration of [[P, A'], [A, 0]] with per-cone-block
    pooling of the row scalings (so scaled slacks stay in K)."""
    B, n = q.shape
    m = b.shape[1]
    D = q.new_ones(B, n)
    E = q.new_ones(B, m)
    c = q.new_ones(B)
    gid = torch.as_tensor(group_ids, device=q.device)
    for _ in range(iters):
        # column norms over the stacked [P; A] (x-side)
        col = P.abs().amax(dim=1)
        if m:
            col = torch.maximum(col, A.abs().amax(dim=1))
        dx = 1.0 / torch.sqrt(torch.where(col > 1e-12, col, 1.0))
        # row norms of [A, 0] (y-side), pooled per cone block via max
        if m:
            row = A.abs().amax(dim=2)
            pooled = torch.full((B, n_groups), -torch.inf, dtype=q.dtype,
                                device=q.device)
            pooled = pooled.scatter_reduce(1, gid.expand(B, m), row, "amax")
            row = pooled[:, gid]
        else:
            row = q.new_zeros(B, 0)
        de = 1.0 / torch.sqrt(torch.where(row > 1e-12, row, 1.0))
        P = dx[:, :, None] * P * dx[:, None, :]
        A = de[:, :, None] * A * dx[:, None, :]
        q = dx * q
        b = de * b
        # cost scaling: normalize mean column norm of the scaled objective
        pcol = P.abs().amax(dim=1)
        gamma_den = torch.maximum(pcol.mean(dim=1), q.abs().amax(dim=1))
        gamma = 1.0 / torch.where(gamma_den > 1e-12, gamma_den, 1.0)
        P = P * gamma[:, None, None]
        q = q * gamma[:, None]
        D = D * dx
        E = E * de
        c = c * gamma
    return P, A, q, b, D, E, c


def relax(alpha: float, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """The over-relaxation alpha * new + (1 - alpha) * old, with the first
    product and the sum rounded once, as the reference's compiler fuses
    them into a multiply-add: an f32 relaxation forms them in f64 (the
    product of two f32 numbers is exact there). At a fixed point of the
    map (new == old) this returns x itself, where two roundings of
    1.6 x - 0.6 x miss it by an ulp about a third of the time: the
    Anderson history would then fill with ulp noise instead of zeros,
    and its Gram (~1e-13) has a regularized inverse that overflows in
    f32, which ends the lane non-finite."""
    if new.dtype != torch.float32:
        return alpha * new + (1 - alpha) * old
    a32 = float(np.float32(alpha))
    return (a32 * new.double() + ((1 - alpha) * old).double()).float()


def anderson_mix(S, Yb, v, vT, v_prev, g_prev, gn_prev, k: int):
    """One type-II Anderson step over a batch, the reference's `step`
    after the map T: v and vT = T(v) are (B, d), the history S and Yb
    (B, L, d) hold the last L differences of v and of g = vT - v, v_prev
    and g_prev are the previous step's v and g, gn_prev (B,) its |g|^2
    (inf after a restart) and k the step's index in the epoch. Returns
    (v_next, S, Yb, gn) for the next step.

    Per lane: a residual that grew restarts the history and takes the
    plain step; otherwise the last differences enter slot (k-1) mod L
    (shared by all lanes), the mixing weights gamma solve the Gram system
    regularized by 1e-8 trace/L + 1e-30 through the masked SPD inverse,
    and weights with |gamma|^2 > 100 (a near-singular history) fall back
    to the plain step too."""
    L = S.shape[1]
    g = vT - v
    gn = bdot(g, g)
    # history restart on residual growth (safeguard)
    grew = gn > gn_prev
    S = torch.where(grew[:, None, None], 0.0, S)
    Yb = torch.where(grew[:, None, None], 0.0, Yb)
    if k > 0:
        # record the (v, g) differences of the last step
        ptr = (k - 1) % L
        hist = ~grew[:, None]
        S[:, ptr] = torch.where(hist, v - v_prev, S[:, ptr])
        Yb[:, ptr] = torch.where(hist, g - g_prev, Yb[:, ptr])
    # zero history rows are inert: reg * gamma_i = 0
    Gram = torch.bmm(Yb, Yb.mT)
    trace = torch.diagonal(Gram, dim1=-2, dim2=-1).sum(-1)
    reg = 1e-8 * (trace / L) + 1e-30
    eye = torch.eye(L, dtype=Gram.dtype, device=Gram.device)
    Ginv = spd_inv_via_chol(Gram + reg[:, None, None] * eye)
    gamma = bmv(Ginv, bmv(Yb, g))
    # a huge mixing vector means a near-singular history: the
    # extrapolation is unreliable, take the plain step
    wild = bdot(gamma, gamma) > 100.0
    v_acc = vT - bmv_t(S + Yb, gamma)
    v_next = torch.where((grew | wild)[:, None], vT, v_acc)
    return v_next, S, Yb, torch.where(grew, torch.inf, gn)


def make_admm_solver(dims: ConeDims, n: int, settings: SolverSettings,
                     masked_factor: bool = False):
    """Build solve(P, q, A, b, x0, y0, s0) -> SolveResult for a fixed
    (dims, n) structure, over batched tensors.

    masked_factor is accepted for parity with the reference, where it
    picks a matmul-only inverse for the TPU; here both routes factor with
    the batched Cholesky."""
    del masked_factor
    st = settings
    m = dims.total
    proj_K = make_cone_projector(dims)
    proj_K_fast = make_inner_projector(dims, settings.psd_proj)
    polyhedral = dims.is_polyhedral()
    group_ids, n_groups = _cone_row_groups(dims)
    is_eq_row_np = np.arange(m) < dims.zero

    def factor(P, A, rho):
        """Explicit inverse of M = P + sigma I + A'RA via Cholesky, one
        per lane. A lane whose M is not numerically SPD gets NaN, as the
        reference's factor gives."""
        with full_f32():
            eye = torch.eye(n, dtype=P.dtype, device=P.device)
            M = P + st.sigma * eye + torch.bmm(A.mT * rho[:, None, :], A)
            L, info = torch.linalg.cholesky_ex(M)
            Minv = torch.cholesky_inverse(L)
        return torch.where((info == 0)[:, None, None], Minv,
                           torch.nan).contiguous()

    def solve(P, q, A, b, x0, y0, s0):
        # every product at full f32: the residuals r_p and r_d are
        # cancellations (the reference's per-lane matvecs reduce in full
        # f32), and a TF32 product would move the epoch a lane stops at
        with full_f32():
            return _solve(P, q, A, b, x0, y0, s0)

    def _solve(P, q, A, b, x0, y0, s0):
        dtype = q.dtype
        device = q.device
        B = q.shape[0]
        P0, A0, q0, b0 = P, A, q, b
        # f64 (the accuracy route) keeps the exact projector in the inner
        # loop too: the Newton-Schulz soft threshold (~1e-3 of ||M||)
        # would cap the active-face identification deep admm_eps targets
        # need
        pk_fast = proj_K if dtype == torch.float64 else proj_K_fast

        Ps, As, qs, bs, D, E, c = _ruiz_equilibrate(
            P, A, q, b, group_ids, n_groups, st.scaling_iters
        )
        if st.max_iters > 0:
            # K1 reads dense operands; with max_iters=0 (the shared
            # route's polish) no epoch runs, and P and A stay the
            # caller's batch-expanded constants instead of B copies
            Ps, As, qs, bs = (t.contiguous() for t in (Ps, As, qs, bs))

        # scaled warm start: x̄ = x/D, z̄ = E (b0 - s), ȳ = c y / E
        x = x0 / D
        z = E * (b0 - s0)
        y = c[:, None] * y0 / E

        is_eq_row = torch.as_tensor(is_eq_row_np, device=device)
        rho = torch.where(
            is_eq_row,
            torch.tensor(st.rho * st.rho_eq_scale, dtype=dtype,
                         device=device),
            torch.tensor(st.rho, dtype=dtype, device=device),
        ).expand(B, m).contiguous()

        def unscaled(xb, zb, yb):
            xu = D * xb
            s_u = (bs - zb) / E
            y_u = (E * yb) / c[:, None]
            return xu, s_u, y_u

        def residuals(xb, zb, yb):
            xu, s_u, y_u = unscaled(xb, zb, yb)
            Ax = bmv(A0, xu)
            r_p = amax_abs(Ax + s_u - b0)
            p_sc = torch.maximum(
                amax_abs(Ax), torch.maximum(amax_abs(s_u), amax_abs(b0))
            )
            Px = bmv(P0, xu)
            Aty = bmv_t(A0, y_u)
            r_d = amax_abs(Px + q0 + Aty)
            d_sc = torch.maximum(
                amax_abs(Px), torch.maximum(amax_abs(Aty), amax_abs(q0))
            )
            # duality gap: infinity-norm residuals alone pass far-from-
            # optimal points on large problems; the xPx cancellation is
            # pinned to full f32
            with full_f32():
                xPx = bdot(xu, bmv(P0, xu))
            pobj = 0.5 * xPx + bdot(q0, xu)
            dobj = -0.5 * xPx - bdot(b0, y_u)
            gap = torch.abs(pobj - dobj)
            g_sc = torch.maximum(torch.abs(pobj), torch.abs(dobj))
            return r_p, p_sc, r_d, d_sc, gap, g_sc

        def run_epoch(x_, z_, y_, minv, rho_):
            return polyhedral_inner_epoch(
                minv, As, qs, bs, rho_, x_.contiguous(), z_.contiguous(),
                y_.contiguous(), n_zero=dims.zero, iters=st.epoch,
                sigma=st.sigma, alpha=st.alpha,
            )

        def proj_C(u):
            return bs - pk_fast(bs - u)

        def run_epoch_plain(x_, z_, y_, minv, rho_):
            """The reference's inner scan in batched torch ops, for the
            cones K1 does not carry."""
            for _ in range(st.epoch):
                rhs = st.sigma * x_ - qs + bmv_t(As, rho_ * z_ - y_)
                x_t = bmv(minv, rhs)
                z_t = bmv(As, x_t)
                x_ = st.alpha * x_t + (1 - st.alpha) * x_
                w = st.alpha * z_t + (1 - st.alpha) * z_ + y_ / rho_
                z_ = proj_C(w)
                y_ = rho_ * (w - z_)
            return x_, z_, y_

        def run_epoch_aa(x_, z_, y_, minv, rho_):
            """Type-II Anderson acceleration on the pre-projection state
            v = [x; w] (w = z + y/rho): z and y are always re-derived from
            w by projection, so y stays in K*. The history S, Yb (B, L,
            n+m) is epoch-local (rho changes the map at epoch
            boundaries); its write slot (k-1) mod L is shared by all
            lanes, since k counts the steps of the epoch. The restart,
            the Gram solve and the fallback to the plain step are per
            lane, as in the reference's vmapped scan (anderson_mix)."""
            L = st.accel_lookback
            B = x_.shape[0]

            def T(xv, wv):
                zv = proj_C(wv)
                yv = rho_ * (wv - zv)
                rhs = st.sigma * xv - qs + bmv_t(As, rho_ * zv - yv)
                x_t = bmv(minv, rhs)
                z_t = bmv(As, x_t)
                return (relax(st.alpha, x_t, xv),
                        relax(st.alpha, z_t, zv) + yv / rho_)

            xv, wv = x_, z_ + y_ / rho_
            S = x_.new_zeros(B, L, n + m)
            Yb = x_.new_zeros(B, L, n + m)
            v_prev = x_.new_zeros(B, n + m)
            g_prev = x_.new_zeros(B, n + m)
            gn_prev = x_.new_full((B,), torch.inf)
            with full_f32():
                for k in range(st.epoch):
                    x_t, w_t = T(xv, wv)
                    v = torch.cat([xv, wv], dim=1)
                    vT = torch.cat([x_t, w_t], dim=1)
                    v_next, S, Yb, gn_prev = anderson_mix(
                        S, Yb, v, vT, v_prev, g_prev, gn_prev, k)
                    v_prev, g_prev = v, vT - v
                    xv, wv = v_next[:, :n], v_next[:, n:]
                ze = proj_C(wv)
                return xv, ze, rho_ * (wv - ze)

        if st.accel_lookback > 0:
            epoch_step = run_epoch_aa
        else:
            epoch_step = run_epoch if polyhedral else run_epoch_plain

        def epoch_body(x_, z_, y_, rho_, it):
            minv = factor(Ps, As, rho_)
            x_prev, y_prev = x_, y_
            x_, z_, y_ = epoch_step(x_, z_, y_, minv, rho_)
            it = it + st.epoch

            r_p, p_sc, r_d, d_sc, gap, g_sc = residuals(x_, z_, y_)
            eps_p = st.admm_eps_abs + st.admm_eps_rel * p_sc
            eps_d = st.admm_eps_abs + st.admm_eps_rel * d_sc
            eps_g = st.eps_gap_scale * (
                st.admm_eps_abs + st.admm_eps_rel * g_sc
            )
            converged = (r_p <= eps_p) & (r_d <= eps_d) & (gap <= eps_g)

            # ---- infeasibility certificates (unscaled deltas) ---------
            dxu = D * (x_ - x_prev)
            dyu = (E * (y_ - y_prev)) / c[:, None]
            ny = amax_abs(dyu)
            nx = amax_abs(dxu)
            safe_ny = torch.where(ny > 0, ny, 1.0)
            safe_nx = torch.where(nx > 0, nx, 1.0)
            eps_inf = st.eps_infeas
            # primal infeasible: A'dy ~ 0, dy in K*, b'dy < 0
            Atdy = bmv_t(A0, dyu)
            proj_dual_dy = dyu + proj_K(-dyu)  # Pi_{K*}(dy) via Moreau
            dual_dist = amax_abs(proj_dual_dy - dyu)
            pinf = (
                (ny > 10 * eps_inf)
                & (amax_abs(Atdy) <= eps_inf * safe_ny)
                & (dual_dist <= eps_inf * safe_ny)
                & (bdot(b0, dyu) < -eps_inf * safe_ny)
            )
            # dual infeasible: P dx ~ 0, q'dx < 0, A dx in rec(C) = -K
            Adx = bmv(A0, dxu)
            rec_dist = amax_abs(-proj_K(-Adx) - Adx)
            dinf = (
                (nx > 10 * eps_inf)
                & (amax_abs(bmv(P0, dxu)) <= eps_inf * safe_nx)
                & (rec_dist <= eps_inf * safe_nx)
                & (bdot(q0, dxu) < -eps_inf * safe_nx)
            )

            status = torch.full_like(it, MAX_ITERS)
            status = torch.where(dinf, DUAL_INFEASIBLE, status)
            status = torch.where(pinf, PRIMAL_INFEASIBLE, status)
            status = torch.where(converged, SOLVED, status).to(torch.int32)

            # ---- adaptive rho -----------------------------------------
            if st.adaptive_rho:
                ratio = torch.sqrt(
                    torch.clamp_min(
                        r_p / torch.where(p_sc > 1e-12, p_sc, 1.0), 1e-10
                    )
                    / torch.clamp_min(
                        r_d / torch.where(d_sc > 1e-12, d_sc, 1.0), 1e-10
                    )
                )
                ratio = torch.clamp(
                    ratio, 1.0 / st.adaptive_rho_clamp, st.adaptive_rho_clamp
                )
                update = (ratio > st.adaptive_rho_tol) | (
                    ratio < 1.0 / st.adaptive_rho_tol
                )
                rho_ = torch.where(
                    update[:, None],
                    torch.clamp(rho_ * ratio[:, None], st.rho_min,
                                st.rho_max),
                    rho_,
                )
            return x_, z_, y_, rho_, it, status

        it = torch.zeros(B, dtype=torch.int32, device=device)
        status = torch.full((B,), MAX_ITERS, dtype=torch.int32,
                            device=device)
        while True:
            active = (status == MAX_ITERS) & (it < st.max_iters)
            if not bool(active.any()):
                break
            x_n, z_n, y_n, rho_n, it_n, status_n = epoch_body(
                x, z, y, rho, it
            )
            a1 = active[:, None]
            x = torch.where(a1, x_n, x)
            z = torch.where(a1, z_n, z)
            y = torch.where(a1, y_n, y)
            rho = torch.where(a1, rho_n, rho)
            it = torch.where(active, it_n, it)
            status = torch.where(active, status_n, status)

        xu, s_u, y_u = unscaled(x, z, y)
        pobj = 0.5 * bdot(xu, bmv(P0, xu)) + bdot(q0, xu)
        return SolveResult(
            x=xu, y=y_u, s=s_u, status=status, iters=it, pobj=pobj
        )

    return solve
