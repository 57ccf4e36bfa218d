"""Semismooth-Newton solution polish, batched.

Counterpart of cvxpylayers_tpu/solver/refine.py. ADMM reaches ~eps
accuracy linearly; a few damped Newton steps on the KKT residual map
(solver/kkt.py) then converge superlinearly. Every decision (the damping
ladder, the escape step, best-iterate tracking, the final status) is
taken per lane with `torch.where`.
"""

from __future__ import annotations

import torch

from ..cones.dims import ConeDims
from ..utils.precision import full_f32
from .admm import SolveResult, amax_abs, bdot, bmv, bmv_t, make_admm_solver
from .kkt import make_kkt, make_kkt_precond, make_kkt_solver
from .settings import MAX_ITERS, SOLVED

# Damping ladder for the Newton line search (each entry costs one cheap
# residual eval). Monotone acceptance alone can freeze at nonsmooth kinks
# of the semismooth residual, so the polish combines this ladder with a
# non-monotone escape step and best-iterate tracking.
_DAMPINGS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
# forced step size taken when no damping descends (a non-monotone move
# across the kink; the returned iterate is always the best seen). Exact
# directions (kkt_mode "spectral", and the PCG phase of "pcg") cross
# kinks with the FULL step and escalate on <10% progress instead.
_ESCAPE_STEP = 0.05


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _finite_rows(v: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(v).all(dim=-1)


def _newton_polish_loop(residual, kkt_solve, n: int, steps: int,
                        escape: float, stall_factor: float,
                        f64_extra_reg_dir: bool = True):
    """Generic damped-Newton polish on F(x, w, *data) = 0.

    residual(x, w, *data) -> (B, n+m); kkt_solve(x, w, *data, rhs,
    transpose=..., regularized=...) solves the generalized-Jacobian
    system. Returns refine_xw(x, w, *data) -> (x, w)."""

    def refine_xw(x, w, *data):
        f_init = _norm(residual(x, w, *data))
        f_init = torch.where(torch.isfinite(f_init), f_init, torch.inf)
        x_, w_, bx, bw, bf = x, w, x, w, f_init
        for _ in range(steps):
            F = residual(x_, w_, *data)
            delta = kkt_solve(x_, w_, *data, -F)
            delta = torch.where(_finite_rows(delta)[:, None], delta, 0.0)
            dirs = [delta]
            if F.dtype == torch.float64 and f64_extra_reg_dir:
                # regularized least-squares direction: survives the
                # singular-J case where the exact solve produces garbage
                delta_r = kkt_solve(x_, w_, *data, -F, regularized=True)
                dirs.append(
                    torch.where(_finite_rows(delta_r)[:, None], delta_r, 0.0)
                )
            f0 = _norm(F)

            # every damping of every direction in ONE residual call (the
            # candidates are independent). Walking them in the reference's
            # order and taking each that is strictly below the best so far
            # ends on the first candidate of least residual, if it beats
            # f0: torch.min returns the first index of its minimum
            cands = [(a, d) for d in dirs for a in _DAMPINGS]
            cx = torch.stack([x_ + a * d[:, :n] for a, d in cands], dim=1)
            cw = torch.stack([w_ + a * d[:, n:] for a, d in cands], dim=1)
            cfs = _norm(residual(cx, cw, *data))
            cfs = torch.where(torch.isfinite(cfs), cfs, torch.inf)
            cmin, kmin = cfs.min(dim=1)
            take = (cmin < f0)[:, None]
            pick = kmin[:, None, None]
            best_x = torch.where(
                take, cx.gather(1, pick.expand(-1, 1, n)).squeeze(1), x_)
            best_w = torch.where(
                take, cw.gather(1, pick.expand(-1, 1, cw.shape[2]))
                .squeeze(1), w_)
            best_f = torch.where(take[:, 0], cmin, f0)

            # global best-iterate tracking (what the polish returns)
            upd = best_f < bf
            bx = torch.where(upd[:, None], best_x, bx)
            bw = torch.where(upd[:, None], best_w, bw)
            bf = torch.where(upd, best_f, bf)

            # non-monotone escape: when no damping descends (a kink of
            # the piecewise-smooth residual), force a small step
            stalled = best_f >= stall_factor * f0
            ex = x_ + escape * delta[:, :n]
            ew = w_ + escape * delta[:, n:]
            ok = _finite_rows(ex) & _finite_rows(ew)
            go = (stalled & ok)[:, None]
            x_ = torch.where(go, ex, best_x)
            w_ = torch.where(go, ew, best_w)
        return bx, bw

    return refine_xw


def make_refiner(dims: ConeDims, n: int, steps: int,
                 schur_iters: int = 0, cg_iters: int = 40,
                 p_diag_full: bool = True, p_diag_only: bool = False,
                 kkt_mode: str = "auto"):
    m = dims.total
    residual, _, split = make_kkt(dims, n)
    kkt_solve = make_kkt_solver(dims, n, cg_iters=cg_iters,
                                schur_iters=schur_iters,
                                p_diag_full=p_diag_full,
                                p_diag_only=p_diag_only,
                                kkt_mode=kkt_mode)
    # exact spectral directions cross semismooth kinks with full steps;
    # the 0.05 escape tuned for least-squares CG directions never makes
    # it across, so the spectral mode escapes with the full Newton step
    # on <10% progress (best-iterate tracking bounds the risk)
    general = not (dims.is_polyhedral() and p_diag_full)
    exact_dirs = kkt_mode == "spectral" and general
    escape = 1.0 if exact_dirs else _ESCAPE_STEP
    stall_factor = 0.9 if exact_dirs else 1.0

    use_pcg = kkt_mode == "pcg" and general and m > 0
    build_precond = make_kkt_precond(dims, n) if use_pcg else None
    # two phases: the first steps cross semismooth kinks with cheap CG
    # directions (a factor built at step 0 is stale the moment the active
    # set jumps), then ONE factorization where steps are small, and
    # PCG's near-exact directions for the rest
    steps_pcg = min(6, max(1, steps // 3)) if use_pcg else 0
    steps_pre = steps - steps_pcg

    refine_xw_plain = _newton_polish_loop(
        residual, kkt_solve, n, steps, escape, stall_factor
    )
    refine_xw_pre = (_newton_polish_loop(residual, kkt_solve, n, steps_pre,
                                         _ESCAPE_STEP, 1.0)
                     if use_pcg else None)

    def refine(x, y, s, P, q, A, b):
        if steps <= 0:
            return x, y, s
        if m == 0:
            # unconstrained QP: one exact Newton step, P x = -q
            sol, _ = torch.linalg.solve_ex(P, -q)
            return torch.where(_finite_rows(sol)[:, None], sol, x), y, s
        w = s - y
        if use_pcg and x.dtype != torch.float64:
            if steps_pre > 0:
                x, w = refine_xw_pre(x, w, P, q, A, b)
            W = build_precond(x, w, P, q, A, b)

            def kkt_solve_pcg(*args_, **kw_):
                return kkt_solve(*args_, precond=W, **kw_)

            refine_xw = _newton_polish_loop(
                residual, kkt_solve_pcg, n, steps_pcg, 1.0, 0.9
            )
        else:
            refine_xw = refine_xw_plain
        x_, w_ = refine_xw(x, w, P, q, A, b)
        s_, y_ = split(w_)
        return x_, y_, s_

    return refine


def make_polished_solver(dims: ConeDims, n: int, settings, base=None,
                         refine_steps=None, p_diag_full: bool = True,
                         p_diag_only: bool = False,
                         masked_factor: bool = False):
    """base solver + Newton polish, returning a SolveResult (the standard
    forward entry point).

    The final status is decided by the post-polish unscaled KKT residual
    and duality gap against settings.eps_abs/eps_rel; infeasibility
    verdicts of the base solver are kept."""
    m = dims.total
    if base is None:
        base = make_admm_solver(dims, n, settings,
                                masked_factor=masked_factor)
    refine = make_refiner(
        dims, n,
        settings.refine_steps if refine_steps is None else refine_steps,
        schur_iters=settings.schur_iters,
        cg_iters=settings.cg_iters,
        p_diag_full=p_diag_full,
        p_diag_only=p_diag_only,
        kkt_mode=settings.kkt_mode,
    )
    residual, _, _ = make_kkt(dims, n)

    def solve(P, q, A, b, x0, y0, s0):
        # every product at full f32 (the status's residual scales too)
        with full_f32():
            return _solve(P, q, A, b, x0, y0, s0)

    def _solve(P, q, A, b, x0, y0, s0):
        res = base(P, q, A, b, x0, y0, s0)
        x, y, s = refine(res.x, res.y, res.s, P, q, A, b)
        # the gap below is a cancellation of O(1) terms down to eps
        # scale: xPx in full f32
        with full_f32():
            xPx = bdot(x, bmv(P, x))
        pobj = 0.5 * xPx + bdot(q, x)

        F = residual(x, s - y, P, q, A, b)
        F1 = F[:, :n]
        F2 = F[:, n:]
        d_sc = torch.maximum(
            amax_abs(bmv(P, x)),
            torch.maximum(amax_abs(bmv_t(A, y)), amax_abs(q)),
        )
        p_sc = torch.maximum(
            amax_abs(bmv(A, x)),
            torch.maximum(amax_abs(s), amax_abs(b)),
        )
        # duality-gap certificate: small infinity-norm residuals do not
        # bound suboptimality when |x|_1 / |y|_1 are large
        dobj = -0.5 * xPx - bdot(b, y)
        gap = torch.abs(pobj - dobj)
        g_sc = torch.maximum(torch.abs(pobj), torch.abs(dobj))
        ok = (
            (amax_abs(F1) <= settings.eps_abs + settings.eps_rel * d_sc)
            & (amax_abs(F2) <= settings.eps_abs + settings.eps_rel * p_sc)
            & (gap <= settings.eps_gap_scale
               * (settings.eps_abs + settings.eps_rel * g_sc))
        )
        # keep infeasibility verdicts; otherwise status is the KKT check
        kkt_status = torch.where(ok, SOLVED, MAX_ITERS)
        status = torch.where(
            (res.status == SOLVED) | (res.status == MAX_ITERS),
            kkt_status, res.status,
        ).to(torch.int32)
        return SolveResult(
            x=x, y=y, s=s, status=status, iters=res.iters, pobj=pobj
        )

    return solve
