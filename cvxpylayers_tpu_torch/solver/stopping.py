"""When a lane stops: the stopping rule of the first-order solvers, the
post-polish certificate, adaptive rho and the frozen-lane loop.

Every solver decides a lane's status here. The reference writes these
tests into each solver (cvxpylayers_tpu/solver/admm.py, matfree.py,
shared.py, pdhg.py, refine.py); the port keeps one copy of each, with
the reference's arithmetic in the reference's order. The functions take
tensors the caller has already formed (batch axis first), so they know
nothing of how a route forms its products: batched dense, sparse, or
against one shared operand.

  * `kkt_scales`: the unscaled primal and dual residuals, their scales,
    and the duality gap with its scale;
  * `within`: those against an absolute and a relative tolerance, the
    in-loop convergence test (admm_eps) and the post-polish one (eps);
  * `banjac`: the infeasibility certificates on the unscaled iterate
    differences of the last epoch (Banjac et al. 2019);
  * `epoch_status` orders an epoch's verdicts; `certified` is the final
    SOLVED test after the polish, which keeps infeasibility verdicts;
  * `rho_ratio` and `rho_step`: adaptive rho;
  * `run_lanes` and `freeze`: the reference's vmapped while_loop. A lane
    that stops keeps its values from then on, and the loop reads the
    host once a trip to know whether any lane is still active.

The interior-point method keeps its own convergence and certificate
tests (solver/ipm.py): they read normalised iterates against fixed
thresholds. It shares the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .settings import DUAL_INFEASIBLE, MAX_ITERS, PRIMAL_INFEASIBLE, SOLVED


def amax_abs(v: torch.Tensor) -> torch.Tensor:
    """max |v| over the last axis, 0 for an empty axis: (B, k) -> (B,)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().amax(dim=-1)


def bdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product over the last axis: (B, k) -> (B,)."""
    return (u * v).sum(dim=-1)


class Scales(NamedTuple):
    r_p: torch.Tensor   # max |Ax + s - b|
    p_sc: torch.Tensor  # max(|Ax|, |s|, |b|)
    r_d: torch.Tensor   # max |Px + q + A'y|
    d_sc: torch.Tensor  # max(|Px|, |A'y|, |q|)
    gap: torch.Tensor   # |pobj - dobj|
    g_sc: torch.Tensor  # max(|pobj|, |dobj|)
    pobj: torch.Tensor  # (1/2) x'Px + q'x


def kkt_scales(Ax, s, b, Px, Aty, q, x, y, F=None) -> Scales:
    """Residuals, scales and duality gap of the unscaled point (x, y, s)
    from its products Ax, Px and A'y, each (B, .).

    Px is None where P = 0 (PDHG): no term of it is formed. F, where
    given, is the KKT residual map's value [dual; primal] (B, n + m) at
    the point, and its parts are the residuals (the post-polish test)."""
    if F is None:
        r_p = amax_abs(Ax + s - b)
        r_d = amax_abs(q + Aty if Px is None else Px + q + Aty)
    else:
        n = x.shape[-1]
        r_p, r_d = amax_abs(F[:, n:]), amax_abs(F[:, :n])
    p_sc = torch.maximum(amax_abs(Ax),
                         torch.maximum(amax_abs(s), amax_abs(b)))
    d_sc = torch.maximum(amax_abs(Aty), amax_abs(q))
    # duality gap: small infinity-norm residuals do not bound
    # suboptimality where |x|_1 and |y|_1 are large
    qx, by = bdot(q, x), bdot(b, y)
    if Px is None:
        pobj, dobj = qx, -by
    else:
        d_sc = torch.maximum(amax_abs(Px), d_sc)
        xPx = bdot(x, Px)
        pobj, dobj = 0.5 * xPx + qx, -0.5 * xPx - by
    gap = torch.abs(pobj - dobj)
    g_sc = torch.maximum(torch.abs(pobj), torch.abs(dobj))
    return Scales(r_p, p_sc, r_d, d_sc, gap, g_sc, pobj)


def within(sc: Scales, eps_abs: float, eps_rel: float,
           gap_scale: float) -> torch.Tensor:
    """Whether each residual is at most eps_abs + eps_rel times its
    scale, and the gap at most gap_scale times that of its scale."""
    return ((sc.r_p <= eps_abs + eps_rel * sc.p_sc)
            & (sc.r_d <= eps_abs + eps_rel * sc.d_sc)
            & (sc.gap <= gap_scale * (eps_abs + eps_rel * sc.g_sc)))


def banjac(dxu, dyu, Atdy, Adx, Pdx, b, q, proj_K, eps: float):
    """(pinf, dinf): the infeasibility certificates on the unscaled
    iterate differences dxu, dyu and their products A'dy, A dx and P dx
    (None where P = 0). proj_K projects onto the cone K."""
    ny = amax_abs(dyu)
    nx = amax_abs(dxu)
    safe_ny = torch.where(ny > 0, ny, 1.0)
    safe_nx = torch.where(nx > 0, nx, 1.0)
    # primal infeasible: A'dy ~ 0, dy in K*, b'dy < 0 (Pi_{K*} by Moreau)
    dual_dist = amax_abs(dyu + proj_K(-dyu) - dyu)
    pinf = (
        (ny > 10 * eps)
        & (amax_abs(Atdy) <= eps * safe_ny)
        & (dual_dist <= eps * safe_ny)
        & (bdot(b, dyu) < -eps * safe_ny)
    )
    # dual infeasible: P dx ~ 0, q'dx < 0, A dx in rec(C) = -K
    rec_dist = amax_abs(-proj_K(-Adx) - Adx)
    dinf = (
        (nx > 10 * eps)
        & (rec_dist <= eps * safe_nx)
        & (bdot(q, dxu) < -eps * safe_nx)
    )
    if Pdx is not None:
        dinf = dinf & (amax_abs(Pdx) <= eps * safe_nx)
    return pinf, dinf


def epoch_status(converged, pinf, dinf) -> torch.Tensor:
    """int32 status codes: SOLVED over PRIMAL_INFEASIBLE over
    DUAL_INFEASIBLE over MAX_ITERS."""
    status = torch.full(converged.shape, MAX_ITERS, dtype=torch.int32,
                        device=converged.device)
    status = torch.where(dinf, DUAL_INFEASIBLE, status)
    status = torch.where(pinf, PRIMAL_INFEASIBLE, status)
    return torch.where(converged, SOLVED, status).to(torch.int32)


def certified(status, sc: Scales, settings) -> torch.Tensor:
    """The final status after the polish: SOLVED where the polished
    point meets settings.eps_abs / eps_rel (gap included), else
    MAX_ITERS; the base solver's infeasibility verdicts are kept."""
    ok = within(sc, settings.eps_abs, settings.eps_rel,
                settings.eps_gap_scale)
    return torch.where((status == SOLVED) | (status == MAX_ITERS),
                       torch.where(ok, SOLVED, MAX_ITERS),
                       status).to(torch.int32)


def rho_ratio(sc: Scales, settings) -> torch.Tensor:
    """Per lane, sqrt of the relative primal over the relative dual
    residual, clamped to [1/adaptive_rho_clamp, adaptive_rho_clamp]."""
    ratio = torch.sqrt(
        torch.clamp_min(
            sc.r_p / torch.where(sc.p_sc > 1e-12, sc.p_sc, 1.0), 1e-10)
        / torch.clamp_min(
            sc.r_d / torch.where(sc.d_sc > 1e-12, sc.d_sc, 1.0), 1e-10)
    )
    return torch.clamp(ratio, 1.0 / settings.adaptive_rho_clamp,
                       settings.adaptive_rho_clamp)


def rho_step(rho, ratio, settings) -> torch.Tensor:
    """rho times ratio (broadcast against it), clamped to [rho_min,
    rho_max], where the ratio leaves [1/adaptive_rho_tol,
    adaptive_rho_tol]; rho elsewhere."""
    update = (ratio > settings.adaptive_rho_tol) | (
        ratio < 1.0 / settings.adaptive_rho_tol)
    return torch.where(
        update, torch.clamp(rho * ratio, settings.rho_min, settings.rho_max),
        rho)


def freeze(active, new, old):
    """new on the active lanes, old on the others: for a tensor with the
    batch axis first, or a (nested) tuple of them."""
    if isinstance(new, tuple):
        return tuple(freeze(active, a, b) for a, b in zip(new, old))
    mask = active.view((-1,) + (1,) * (new.dim() - 1))
    return torch.where(mask, new, old)


def run_lanes(body, state, active_of):
    """Iterate state = body(*state) over the lanes active_of(state)
    marks, freezing the others, until none is active; one host read a
    trip. Returns the last state."""
    while True:
        active = active_of(state)
        if not bool(active.any()):
            return state
        state = freeze(active, body(*state), state)


def unfinished(max_iters: int):
    """active_of for a state that ends (..., it, status): the lanes still
    at MAX_ITERS with fewer than max_iters iterations."""
    def active_of(state):
        it, status = state[-2:]
        return (status == MAX_ITERS) & (it < max_iters)
    return active_of
