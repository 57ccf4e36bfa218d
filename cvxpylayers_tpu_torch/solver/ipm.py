"""Interior-point solver for zero and nonneg cones, batched.

Counterpart of cvxpylayers_tpu/solver/ipm.py::make_ipm_solver, in its
primal-dual form and its homogeneous self-dual embedding (HSDE),
restricted to polyhedral cones. `solve_method="ipm"` in solver_args
selects it; `ipm_mode` picks the form (diff/derivative.py: "auto" takes
the embedding when P is structurally zero).

Problem form:  min (1/2)x'Px + q'x  s.t.  A x + s = b, s in K.

Algorithm (Mehrotra predictor-corrector): every Newton system uses the
Nesterov-Todd scaling T = diag(s/z) of the nonneg block and eliminates
ds, giving the quasidefinite KKT system
[[P, Aeq', Ain'], [Aeq, 0, 0], [Ain, 0, -T]]. T, its inverse and the
factor B with B'B = T^{-1} are diagonal here and kept as (B, mi) vectors.

  * f64: exact dense LU of the KKT matrix, factored once per iteration
    and solved for the predictor and the corrector;
  * f32: exact condensation. dz is eliminated through T^{-1}, and the
    n x n SPD S = P + sigma I + Ain' T^{-1} Ain is factored through the
    QR of the stacked M = [Lp'; B Ain] (S = M'M): the R factor comes from
    kernel K2 (solver/cuda_linalg.py::qr_r) on a CUDA tensor, whose
    error scales with eps sqrt(cond(S)) where a Cholesky of S would give
    eps cond(S). One refinement pass against the cached factors follows.
    Above batched_linalg.MASKED_MAX_DIM, ipm_kkt "auto"/"chol" takes the
    Jacobi-scaled Cholesky of M'M with a non-finite guard; "qr" keeps K2.
  * step lengths by the exact ratio test; a step is accepted at the
    largest of four candidates whose endpoint is finite and strictly
    interior; the lowest-merit iterate is returned;
  * infeasibility: almost-certificate checks on normalized iterates.

Every array carries the batch axis first. Lanes are frozen as the
reference's vmapped while_loop freezes them: a lane stops once its
status leaves MAX_ITERS, its count reaches ipm_max_iters or it stalls
three times in a row, and from then on its iterate, count, stall
counter and best iterate no longer change. The loop reads one `any()`
per iteration from the device to know when every lane has stopped.

The embedding (`hsde=True`, P = 0) adds the homogenizing pair (tau,
kappa), one (B,) vector each: infeasibility becomes an intrinsic verdict
(tau -> 0 with kappa > 0 and the certificate in the iterate), and each
iteration solves against its one factorization three times (the tau
column, the predictor and the corrector), so in f32 at n <= 160 it is a
second path through K2. It freezes lanes as the primal-dual form does.

The SOC, PSD, exponential and power blocks are not ported yet and raise.
"""

from __future__ import annotations

import torch

from ..cones.dims import ConeDims
from ..cones.projections import require_polyhedral
from ..utils.precision import full_f32
from .admm import SolveResult, amax_abs, bdot, bmv, bmv_t
from .batched_linalg import use_masked
from .cuda_linalg import qr_r
from .settings import (
    DUAL_INFEASIBLE,
    MAX_ITERS,
    PRIMAL_INFEASIBLE,
    SOLVED,
    SolverSettings,
)

_TINY = 1e-30


def _nan_unless(info: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """L where cholesky_ex reports success (info == 0), NaN elsewhere: a
    failed factor must flow on as NaN into the step-acceptance guards
    instead of raising."""
    return torch.where((info == 0)[:, None, None], L, torch.nan)


def _finite_rows(v: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(v).all(dim=-1)


def _nonneg_step_len(v, dv):
    """max alpha in [0, 1] with v + alpha dv >= 0, per lane."""
    neg = dv < 0
    cand = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(cand.amin(dim=-1), 0.0, 1.0)


def make_ipm_solver(dims: ConeDims, n: int, settings: SolverSettings,
                    hsde: bool = False):
    """Build solve(P, q, A, b, x0, y0, s0) -> SolveResult for a fixed
    (dims, n) structure, over batched tensors."""
    require_polyhedral(dims, "the interior-point solver")
    p_eq = dims.zero
    mi = dims.nonneg
    st = settings
    max_it = st.ipm_max_iters
    # internal convergence target; may be tighter than the final eps so
    # that the polish starts inside its basin
    ipm_eps = st.ipm_eps_abs if st.ipm_eps_abs > 0 else st.eps_abs
    # cone degree: 1 per nonneg row
    degree = max(mi, 1)
    dim = n + p_eq + mi

    def build_T(s, z):
        """Diagonal NT scaling T with T z = s, its inverse, and B with
        B'B = T^{-1}, as (B, mi) vectors."""
        ratio = s / torch.clamp_min(z, _TINY)
        inv = 1.0 / torch.clamp_min(ratio, _TINY)
        return ratio, inv, torch.sqrt(inv)

    def rc_combined(s, z, mu, sigma, ds_a, dz_a):
        """Combined-step RHS: centering + Mehrotra correction."""
        zs = torch.clamp_min(z, _TINY)
        return s - (sigma * mu)[:, None] / zs + ds_a * dz_a / zs

    def strict_interior(v):
        if not mi:
            return torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
        return v.amin(dim=-1) > 0

    def step_len(v, dv):
        one = v.new_ones(v.shape[0])
        if not mi:
            return one
        return torch.minimum(one, _nonneg_step_len(v, dv))

    def shift_into_cone(v):
        if not mi:
            return v
        a = (-v).amax(dim=-1, keepdim=True)
        return torch.where(a >= -1e-3, v + (1.0 + a), v)

    def make_kkt_factor(P, A_eq, A_in):
        """kkt_factor(T, Tinv, Bd) factors the scaled KKT matrix ONCE and
        returns solve(rx, ry, rz) for K d = [-rx, -ry, -rz]."""
        dtype = P.dtype
        device = P.device
        nb = P.shape[0]
        eye_n = torch.eye(n, dtype=dtype, device=device)
        eye_p = torch.eye(p_eq, dtype=dtype, device=device)
        P_sig = P + st.sigma * eye_n

        def factor_f64(T):
            K = P.new_zeros(nb, dim, dim)
            K[:, :n, :n] = P_sig
            if p_eq:
                K[:, n:n + p_eq, :n] = A_eq
                K[:, :n, n:n + p_eq] = A_eq.mT
                K[:, n:n + p_eq, n:n + p_eq] = -st.sigma * eye_p
            if mi:
                K[:, n + p_eq:, :n] = A_in
                K[:, :n, n + p_eq:] = A_in.mT
                K[:, n + p_eq:, n + p_eq:] = torch.diag_embed(-T)
            LU, piv, _ = torch.linalg.lu_factor_ex(K)

            def solve_f64(rx, ry, rz_mod):
                rhs = torch.cat([-rx, -ry, -rz_mod], dim=-1)
                sol = torch.linalg.lu_solve(LU, piv,
                                            rhs.unsqueeze(-1)).squeeze(-1)
                return sol[:, :n], sol[:, n:n + p_eq], sol[:, n + p_eq:]

            return solve_f64

        def factor_f32(T, Tinv, Bd):
            with full_f32():
                Lp, info = torch.linalg.cholesky_ex(P_sig)
                Lp = _nan_unless(info, Lp)
                if mi:
                    M = torch.cat([Lp.mT, Bd[:, :, None] * A_in], dim=1)
                    if use_masked(n) or st.ipm_kkt == "qr":
                        Rm = qr_r(M.contiguous())
                    else:
                        # R'R = M'M = S, so chol(M'M)' is the same factor
                        # for one matmul and an (n, n) Cholesky; Jacobi
                        # scaling removes the row/column scale that
                        # dominates cond(S) near convergence. A
                        # non-finite factor selects the identity: that
                        # iteration's direction degrades to a scaled
                        # residual step, which the step acceptance and
                        # the stall counter handle.
                        S_ = torch.bmm(M.mT, M)
                        dj = torch.rsqrt(torch.clamp_min(
                            torch.diagonal(S_, dim1=1, dim2=2), _TINY))
                        Ss = S_ * dj[:, :, None] * dj[:, None, :]
                        Lc, info = torch.linalg.cholesky_ex(Ss)
                        ok = (info == 0) & torch.isfinite(Lc).all(
                            dim=-1).all(dim=-1)
                        Lc = torch.where(ok[:, None, None], Lc, eye_n)
                        Rm = (Lc / dj[:, :, None]).mT
                else:
                    Rm = Lp.mT
                Rmi = torch.linalg.solve_triangular(
                    Rm, eye_n.expand(nb, n, n), upper=True
                )
                Sinv = torch.bmm(Rmi, Rmi.mT)
                if p_eq:
                    E = (torch.bmm(A_eq, torch.bmm(Sinv, A_eq.mT))
                         + st.sigma * eye_p)
                    Le, info = torch.linalg.cholesky_ex(E)
                    Le = _nan_unless(info, Le)

            def solve_cond(rx_, ry_, rz_):
                """One condensed solve of K d = [-rx_, -ry_, -rz_]."""
                g = -rx_
                if mi:
                    g = g - bmv_t(A_in, Tinv * rz_)
                if p_eq:
                    rhs_y = bmv(A_eq, bmv(Sinv, g)) + ry_
                    z1 = torch.linalg.solve_triangular(
                        Le, rhs_y.unsqueeze(-1), upper=False
                    )
                    dy_ = torch.linalg.solve_triangular(
                        Le.mT, z1, upper=True
                    ).squeeze(-1)
                    dx_ = bmv(Sinv, g - bmv_t(A_eq, dy_))
                else:
                    dy_ = ry_
                    dx_ = bmv(Sinv, g)
                dz_ = Tinv * (bmv(A_in, dx_) + rz_) if mi else rz_
                return dx_, dy_, dz_

            def solve_f32(rx, ry, rz_mod):
                with full_f32():
                    dx, dy, dz = solve_cond(rx, ry, rz_mod)
                    # one refinement pass with the cached factors: the
                    # correction squares the effective precision
                    res_x = rx + bmv(P_sig, dx)
                    res_y = ry
                    res_z = rz_mod
                    if p_eq:
                        res_x = res_x + bmv_t(A_eq, dy)
                        res_y = ry + bmv(A_eq, dx) - st.sigma * dy
                    if mi:
                        res_x = res_x + bmv_t(A_in, dz)
                        res_z = rz_mod + bmv(A_in, dx) - T * dz
                    cx, cy, cz = solve_cond(res_x, res_y, res_z)
                    return dx + cx, dy + cy, dz + cz

            return solve_f32

        def kkt_factor(T, Tinv, Bd):
            if dtype == torch.float64:
                return factor_f64(T)
            return factor_f32(T, Tinv, Bd)

        return kkt_factor

    def solve(P, q, A, b, x0, y0, s0):
        dtype = q.dtype
        device = q.device
        nb = q.shape[0]
        A_eq = A[:, :p_eq]
        b_eq = b[:, :p_eq]
        A_in = A[:, p_eq:]
        b_in = b[:, p_eq:]
        kkt_factor = make_kkt_factor(P, A_eq, A_in)

        def residuals(x, y, z, s):
            rx = bmv(P, x) + q
            if p_eq:
                rx = rx + bmv_t(A_eq, y)
            if mi:
                rx = rx + bmv_t(A_in, z)
            ry = bmv(A_eq, x) - b_eq
            rz = bmv(A_in, x) + s - b_in
            return rx, ry, rz

        # ---- initial point: least-squares KKT solve with identity
        # scaling, then a shift into the cone interior
        ones_mi = q.new_ones(nb, mi)
        x, y, z_hat = kkt_factor(ones_mi, ones_mi, ones_mi)(q, -b_eq, -b_in)
        s = shift_into_cone(-z_hat)
        z = shift_into_cone(z_hat)
        # warm start (per-lane select): a nonzero (x0, y0, s0) replaces
        # the least-squares point, pushed back into the strict interior
        # and mixed toward the canonical interior point, because an IPM
        # warm-starts poorly from ON the boundary
        ws_norm = amax_abs(x0) + amax_abs(s0) + amax_abs(y0)
        have_ws = (ws_norm > 0)[:, None]
        mix = 0.1
        s_ws = shift_into_cone((1 - mix) * s0[:, p_eq:] + mix)
        z_ws = shift_into_cone((1 - mix) * y0[:, p_eq:] + mix)
        x = torch.where(have_ws, x0, x)
        y = torch.where(have_ws, y0[:, :p_eq], y)
        s = torch.where(have_ws, s_ws, s)
        z = torch.where(have_ws, z_ws, z)

        b_norm = amax_abs(b)
        q_norm = amax_abs(q)

        def certificates(x, y, z):
            """Almost-certificate detection on normalized iterates."""
            u = torch.cat([y, z], dim=-1)
            nu_ = amax_abs(u)
            uh = u / torch.clamp_min(nu_, _TINY)[:, None]
            pinf = (
                (nu_ > 1e3)
                & (amax_abs(bmv_t(A, uh)) <= 1e-7 * (1.0 + q_norm))
                & (bdot(b, uh) < -1e-5)
            )
            nx = amax_abs(x)
            xh = x / torch.clamp_min(nx, _TINY)[:, None]
            Axh = bmv(A_in, xh)
            # distance of A_in xh from the recession cone -K
            rec_dist = amax_abs(-torch.clamp_min(-Axh, 0.0) - Axh)
            eq_dist = amax_abs(bmv(A_eq, xh))
            dinf = (
                (nx > 1e3)
                & (amax_abs(bmv(P, xh)) <= 1e-7)
                & (eq_dist <= 1e-7 * (1.0 + b_norm))
                & (rec_dist <= 1e-7 * (1.0 + b_norm))
                & (bdot(q, xh) < -1e-5)
            )
            return pinf, dinf

        def body(x, y, z, s, it, status, stall, best):
            mu = torch.clamp_min(bdot(s, z) / degree, _TINY)
            T, Tinv, Bd = build_T(s, z)
            # ONE factorization per iteration, shared by predictor and
            # corrector
            ksolve = kkt_factor(T, Tinv, Bd)
            rx, ry, rz = residuals(x, y, z, s)

            # ---- affine (predictor) step; rc = s for symmetric cones
            dx_a, dy_a, dz_a = ksolve(rx, ry, rz - s)
            # ds from the third-row residual identity, not -(rc + T dz):
            # keeps A dx + ds = -rz exact to well-scaled rounding
            ds_a = -(rz + bmv(A_in, dx_a))
            alpha_aff = torch.minimum(step_len(s, ds_a), step_len(z, dz_a))
            a1 = alpha_aff[:, None]
            mu_aff = bdot(s + a1 * ds_a, z + a1 * dz_a) / degree
            sigma_c = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)

            # ---- corrector (centering + Mehrotra second order)
            rc_c = rc_combined(s, z, mu, sigma_c, ds_a, dz_a)
            dx, dy, dz = ksolve(rx, ry, rz - rc_c)
            ds = -(rz + bmv(A_in, dx))
            alpha = 0.99 * torch.minimum(step_len(s, ds), step_len(z, dz))

            # step acceptance with backtracking: the largest alpha in
            # {alpha, alpha/2, alpha/4, alpha/8, 0} whose endpoint is
            # finite and strictly interior on both sides with s'z > 0
            def ok_at(a):
                a = a[:, None]
                s_c = s + a * ds
                z_c = z + a * dz
                ok = (
                    _finite_rows(x + a * dx) & _finite_rows(y + a * dy)
                    & _finite_rows(s_c) & _finite_rows(z_c)
                    & strict_interior(s_c) & strict_interior(z_c)
                )
                if mi:
                    ok = ok & (bdot(s_c, z_c) > 0)
                return ok

            alpha_eff = torch.zeros_like(alpha)
            for k in (0.125, 0.25, 0.5, 1.0):
                cand = alpha * k
                alpha_eff = torch.where(ok_at(cand), cand, alpha_eff)

            # a zero step means every candidate was rejected, typically a
            # NaN/Inf direction: select, because 0 * NaN would still
            # poison the iterate
            take = (alpha_eff > 0)[:, None]
            ae = alpha_eff[:, None]
            x = torch.where(take, x + ae * dx, x)
            y = torch.where(take, y + ae * dy, y)
            z = torch.where(take, z + ae * dz, z)
            s = torch.where(take, s + ae * ds, s)
            it = it + 1
            # consecutive rejected or zero steps mean the dtype's
            # KKT-direction precision floor is reached
            stall = torch.where(alpha_eff > 1e-6, 0, stall + 1)

            rx2, ry2, rz2 = residuals(x, y, z, s)
            mu2 = bdot(s, z) / degree
            p_res = torch.maximum(amax_abs(ry2), amax_abs(rz2))
            d_res = amax_abs(rx2)
            scale = 1.0 + torch.maximum(q_norm, b_norm)
            done = (
                (p_res <= ipm_eps * scale)
                & (d_res <= ipm_eps * scale)
                & (mu2 <= ipm_eps * scale)
            )
            # best-iterate tracking: return the lowest-merit iterate
            bx, by, bz, bs, bm = best
            merit = torch.maximum(torch.maximum(p_res, d_res), mu2.abs())
            better = merit < bm
            b1 = better[:, None]
            best = (
                torch.where(b1, x, bx), torch.where(b1, y, by),
                torch.where(b1, z, bz), torch.where(b1, s, bs),
                torch.where(better, merit, bm),
            )
            pinf, dinf = certificates(x, y, z)
            status = torch.where(dinf, DUAL_INFEASIBLE, status)
            status = torch.where(pinf, PRIMAL_INFEASIBLE, status)
            status = torch.where(done, SOLVED, status).to(torch.int32)
            return x, y, z, s, it, status, stall, best

        it = torch.zeros(nb, dtype=torch.int32, device=device)
        status = torch.full((nb,), MAX_ITERS, dtype=torch.int32,
                            device=device)
        stall = torch.zeros(nb, dtype=torch.int32, device=device)
        best = (x, y, z, s, q.new_full((nb,), torch.inf))
        while True:
            active = (status == MAX_ITERS) & (it < max_it) & (stall < 3)
            if not bool(active.any()):
                break
            x_n, y_n, z_n, s_n, it_n, status_n, stall_n, best_n = body(
                x, y, z, s, it, status, stall, best
            )
            a1 = active[:, None]
            x = torch.where(a1, x_n, x)
            y = torch.where(a1, y_n, y)
            z = torch.where(a1, z_n, z)
            s = torch.where(a1, s_n, s)
            it = torch.where(active, it_n, it)
            status = torch.where(active, status_n, status)
            stall = torch.where(active, stall_n, stall)
            best = tuple(
                torch.where(a1 if new.dim() == 2 else active, new, old)
                for new, old in zip(best_n, best)
            )
        x, y, z, s, _ = best

        y_full = torch.cat([y, z], dim=-1)
        s_full = torch.cat([q.new_zeros(nb, p_eq), s], dim=-1)
        pobj = 0.5 * bdot(x, bmv(P, x)) + bdot(q, x)
        return SolveResult(
            x=x, y=y_full, s=s_full, status=status, iters=it, pobj=pobj
        )

    # ------------------------------------------------------------- HSDE
    def solve_hsde(P, q, A, b, x0, y0, s0):
        """Mehrotra IPM on the homogeneous self-dual embedding (P = 0):

            rx = Aeq'y + Ain'z + q*tau        -> 0
            ry = Aeq x - beq*tau              -> 0
            rz = Ain x + s - bin*tau          -> 0
            rt = kappa + q'x + beq'y + bin'z  -> 0
            s in K, z in K*, tau, kappa >= 0; s'z = 0, tau*kappa = 0.

        tau and kappa are (B,) vectors. Each iteration factors the scaled
        KKT matrix once and solves against it three times: the tau
        column d2, then the predictor and the corrector, with dtau
        recovered from the gap row after eliminating dkappa."""
        dtype = q.dtype
        device = q.device
        nb = q.shape[0]
        A_eq = A[:, :p_eq]
        b_eq = b[:, :p_eq]
        A_in = A[:, p_eq:]
        b_in = b[:, p_eq:]
        kkt_factor = make_kkt_factor(P, A_eq, A_in)
        deg1 = degree + 1

        def g_of(dx, dy, dz):
            return bdot(q, dx) + bdot(b_eq, dy) + bdot(b_in, dz)

        def embed_residuals(x, y, z, s, tau):
            rx = q * tau + bmv_t(A_eq, y) + bmv_t(A_in, z)
            ry = bmv(A_eq, x) - b_eq * tau
            rz = bmv(A_in, x) + s - b_in * tau
            return rx, ry, rz

        def ratio(v, dv):
            """max step in [0, 1] keeping v + a dv >= 0, per lane."""
            return torch.where(dv < 0, torch.clamp_max(-v / dv, 1.0), 1.0)

        # initial embedding point: canonical interior, tau = kappa = 1;
        # a nonzero warm start (per-lane select) replaces x, y, s, z
        x = q.new_zeros(nb, n)
        y = q.new_zeros(nb, p_eq)
        s = q.new_ones(nb, mi)
        z = q.new_ones(nb, mi)
        tau = q.new_ones(nb)
        kap = q.new_ones(nb)
        ws_norm = amax_abs(x0) + amax_abs(s0) + amax_abs(y0)
        have_ws = (ws_norm > 0)[:, None]
        mix = 0.1
        x = torch.where(have_ws, x0, x)
        y = torch.where(have_ws, y0[:, :p_eq], y)
        s = torch.where(have_ws, shift_hsde(s0[:, p_eq:], mix), s)
        z = torch.where(have_ws, shift_hsde(y0[:, p_eq:], mix), z)

        b_norm = amax_abs(b)
        q_norm = amax_abs(q)
        scale = 1.0 + torch.maximum(q_norm, b_norm)

        def body(x, y, z, s, tau, kap, it, status, stall, best):
            mu = torch.clamp_min((bdot(s, z) + tau * kap) / deg1, _TINY)
            T, Tinv, Bd = build_T(s, z)
            # ONE factorization per iteration, shared by the tau-column,
            # predictor and corrector solves
            ksolve = kkt_factor(T, Tinv, Bd)
            rx, ry, rz = embed_residuals(x, y, z, s, tau[:, None])
            rt = kap + g_of(x, y, z)
            safe_tau = torch.clamp_min(tau, _TINY)

            # shared tau-column solve: K d2 = [-q; beq; bin]
            dx2, dy2, dz2 = ksolve(q, -b_eq, -b_in)
            denom = g_of(dx2, dy2, dz2) - kap / safe_tau
            denom = torch.where(denom.abs() > _TINY, denom, -_TINY)

            def directions(rc, rct):
                dx1, dy1, dz1 = ksolve(rx, ry, rz - rc)
                dtau = (-rt - g_of(dx1, dy1, dz1) + rct / safe_tau) / denom
                t1 = dtau[:, None]
                dx = dx1 + t1 * dx2
                dy = dy1 + t1 * dy2
                dz = dz1 + t1 * dz2
                ds = -(rz + bmv(A_in, dx) - b_in * t1)
                dkap = -(rct + kap * dtau) / safe_tau
                return dx, dy, dz, ds, dtau, dkap

            # ---- predictor; rc = s for symmetric cones
            dxa, dya, dza, dsa, dta, dka = directions(s, tau * kap)
            alpha_aff = torch.minimum(
                torch.minimum(step_len(s, dsa), step_len(z, dza)),
                torch.minimum(ratio(tau, dta), ratio(kap, dka)),
            )
            a1 = alpha_aff[:, None]
            mu_aff = (
                bdot(s + a1 * dsa, z + a1 * dza)
                + (tau + alpha_aff * dta) * (kap + alpha_aff * dka)
            ) / deg1
            sigma_c = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)

            # ---- corrector
            rc_c = rc_combined(s, z, mu, sigma_c, dsa, dza)
            rct_c = tau * kap - sigma_c * mu + dta * dka
            dx, dy, dz, ds, dtau, dkap = directions(rc_c, rct_c)

            alpha = 0.99 * torch.minimum(
                torch.minimum(step_len(s, ds), step_len(z, dz)),
                torch.minimum(ratio(tau, dtau), ratio(kap, dkap)),
            )

            def ok_at(a):
                a1 = a[:, None]
                s_c = s + a1 * ds
                z_c = z + a1 * dz
                t_c = tau + a * dtau
                k_c = kap + a * dkap
                fin = (
                    _finite_rows(x + a1 * dx) & _finite_rows(y + a1 * dy)
                    & _finite_rows(s_c) & _finite_rows(z_c)
                    & torch.isfinite(t_c) & torch.isfinite(k_c)
                )
                gap_ok = (bdot(s_c, z_c) + t_c * k_c) > 0
                return (fin & strict_interior(s_c) & strict_interior(z_c)
                        & (t_c > 0) & (k_c > 0) & gap_ok)

            alpha_eff = torch.zeros_like(alpha)
            for k in (0.125, 0.25, 0.5, 1.0):
                cand = alpha * k
                alpha_eff = torch.where(ok_at(cand), cand, alpha_eff)

            take = alpha_eff > 0
            t1 = take[:, None]
            ae = alpha_eff[:, None]
            x = torch.where(t1, x + ae * dx, x)
            y = torch.where(t1, y + ae * dy, y)
            z = torch.where(t1, z + ae * dz, z)
            s = torch.where(t1, s + ae * ds, s)
            tau = torch.where(take, tau + alpha_eff * dtau, tau)
            kap = torch.where(take, kap + alpha_eff * dkap, kap)
            it = it + 1
            stall = torch.where(alpha_eff > 1e-6, 0, stall + 1)

            # ---- normalized convergence / intrinsic certificates
            st_ = torch.clamp_min(tau, _TINY)[:, None]
            xh, yh, zh, sh = x / st_, y / st_, z / st_, s / st_
            rxh, ryh, rzh = embed_residuals(xh, yh, zh, sh, 1.0)
            p_res = torch.maximum(amax_abs(ryh), amax_abs(rzh))
            d_res = amax_abs(rxh)
            gap = bdot(sh, zh) / degree
            done = (
                (p_res <= ipm_eps * scale)
                & (d_res <= ipm_eps * scale)
                & (gap <= ipm_eps * scale)
            )
            # tau -> 0: the iterate IS the certificate (exact, not an
            # almost-certificate heuristic)
            bty = bdot(b_eq, y) + bdot(b_in, z)
            qtx = bdot(q, x)
            Atu = bmv_t(A, torch.cat([y, z], dim=-1))
            inf_regime = kap > 1e3 * tau
            pinf = (
                inf_regime & (bty < -_TINY)
                & (amax_abs(Atu) <= 1e-6 * scale * (-bty))
            )
            dinf = (
                inf_regime & (qtx < -_TINY)
                & (amax_abs(bmv(A_eq, x)) <= 1e-6 * scale * (-qtx))
                & (amax_abs(bmv(A_in, x) + s) <= 1e-6 * scale * (-qtx))
            )
            status = torch.where(dinf, DUAL_INFEASIBLE, status)
            status = torch.where(pinf, PRIMAL_INFEASIBLE, status)
            status = torch.where(done, SOLVED, status).to(torch.int32)

            bx, by, bz, bs, btau, bm = best
            merit = torch.maximum(torch.maximum(p_res, d_res), gap.abs())
            better = merit < bm
            b1 = better[:, None]
            best = (
                torch.where(b1, x, bx), torch.where(b1, y, by),
                torch.where(b1, z, bz), torch.where(b1, s, bs),
                torch.where(better, tau, btau),
                torch.where(better, merit, bm),
            )
            return x, y, z, s, tau, kap, it, status, stall, best

        it = torch.zeros(nb, dtype=torch.int32, device=device)
        status = torch.full((nb,), MAX_ITERS, dtype=torch.int32,
                            device=device)
        stall = torch.zeros(nb, dtype=torch.int32, device=device)
        best = (x, y, z, s, tau, q.new_full((nb,), torch.inf))
        while True:
            active = (status == MAX_ITERS) & (it < max_it) & (stall < 3)
            if not bool(active.any()):
                break
            new = body(x, y, z, s, tau, kap, it, status, stall, best)
            a1 = active[:, None]
            x, y, z, s, tau, kap, it, status, stall = (
                torch.where(a1 if v.dim() == 2 else active, v, old)
                for v, old in zip(new[:9],
                                  (x, y, z, s, tau, kap, it, status, stall))
            )
            best = tuple(
                torch.where(a1 if v.dim() == 2 else active, v, old)
                for v, old in zip(new[9], best)
            )
        bx, by, bz, bs, btau, _ = best
        # solved path: the tau-normalized best iterate; on an
        # infeasibility verdict the LAST iterate unscaled, which is the
        # certificate itself
        infeasible = ((status == PRIMAL_INFEASIBLE)
                      | (status == DUAL_INFEASIBLE))[:, None]
        st_ = torch.clamp_min(btau, _TINY)[:, None]
        xr = torch.where(infeasible, x, bx / st_)
        yr = torch.where(infeasible, y, by / st_)
        zr = torch.where(infeasible, z, bz / st_)
        sr = torch.where(infeasible, s, bs / st_)
        y_full = torch.cat([yr, zr], dim=-1)
        s_full = torch.cat([q.new_zeros(nb, p_eq), sr], dim=-1)
        return SolveResult(x=xr, y=y_full, s=s_full, status=status,
                           iters=it, pobj=bdot(q, xr))

    def shift_hsde(v, mix):
        """The HSDE warm start's interior shift: a convex mix toward the
        canonical interior point (all ones), then at least 1e-3."""
        return torch.clamp_min((1 - mix) * v + mix * 1.0, 1e-3)

    return solve_hsde if hsde else solve
