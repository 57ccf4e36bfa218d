"""KKT residual map and its generalized Jacobian, batched.

Counterpart of cvxpylayers_tpu/solver/kkt.py. The solution of
min (1/2)x'Px + q'x  s.t. Ax + s = b, s in K  is characterized (via the
Moreau decomposition w = s - y, s = Pi_K(w), y = Pi_K(w) - w in K*) by
F(x, w) = 0 with

    F1 = P x + q + A' y(w)
    F2 = A x + Pi_K(w) - b

This one residual map powers the semismooth-Newton polish
(solver/refine.py) and the implicit-function adjoint
(diff/derivative.py). Every array carries the batch axis first.
"""

from __future__ import annotations

import torch

from ..cones.dims import ConeDims
from ..cones.jacobians import (
    make_cone_dproj_dense,
    make_cone_dproj_factored,
    make_cone_dproj_spectral,
)
from ..cones.projections import make_cone_projector
from ..utils.precision import full_f32
from .admm import bmv, bmv_t
from .batched_linalg import spd_inv_via_chol, use_masked

# f32 general-cone dense-normal CG window on the KKT dimension n + m:
# inside it the (n+m)^2 Jacobian is materialized once per Newton solve and
# the normal matrix H = J'J formed explicitly, so every CG iteration is
# one batched matvec instead of the operator chain. The reference measured
# both alternatives worse outside the window (below: the operator chain
# is already as small; above: H's reads and its eps*kappa^2 rounding).
# solver_args={"kkt_mode": "operator"} never takes it.
DENSE_NORMAL_MIN = 48
DENSE_NORMAL_MAX = 144


def make_kkt(dims: ConeDims, n: int):
    m = dims.total
    proj = make_cone_projector(dims)
    dproj = make_cone_dproj_dense(dims)

    def residual(x, w, P, q, A, b):
        """F(x, w), (B, n+m); x (B, k, n) and w (B, k, m) evaluate k
        candidate points per lane at once (the polish's damping ladder),
        (B, k, n+m)."""
        # F is a catastrophic cancellation (O(1) operands, near-zero
        # result): full f32, never TF32
        with full_f32():
            if x.ndim == 3:
                B, k = x.shape[:2]
                Pi = proj(w.reshape(B * k, m)).reshape(B, k, m)
                y = Pi - w
                F1 = torch.bmm(x, P.mT) + q[:, None] + torch.bmm(y, A)
                F2 = torch.bmm(x, A.mT) + Pi - b[:, None]
                return torch.cat([F1, F2], dim=-1)
            Pi = proj(w)
            y = Pi - w
            F1 = bmv(P, x) + q + bmv_t(A, y)
            F2 = bmv(A, x) + Pi - b
            return torch.cat([F1, F2], dim=-1)

    def jacobian(x, w, P, q, A, b):
        """Generalized Jacobian of F wrt (x, w): (B, n+m, n+m) dense."""
        D = dproj(w)  # (B, m, m)
        I_m = torch.eye(m, dtype=x.dtype, device=x.device)
        J = x.new_zeros(x.shape[0], n + m, n + m)
        J[:, :n, :n] = P
        J[:, :n, n:] = torch.bmm(A.mT, D - I_m)
        J[:, n:, :n] = A
        J[:, n:, n:] = D
        return J

    def split(w):
        Pi = proj(w)
        return Pi, Pi - w  # (s, y)

    return residual, jacobian, split


def _trace(M: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def _chol_inv(M: torch.Tensor) -> torch.Tensor:
    """L^{-1} for the lower Cholesky factors L of a batch of SPD matrices,
    NaN on a lane whose factor fails (the reference's factor gives NaN
    there)."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info == 0)[:, None, None], L, torch.nan)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _spd_inv(M: torch.Tensor) -> torch.Tensor:
    """Explicit inverses of a batch of SPD matrices: the masked Cholesky
    loop of the reference at its f32 sizes (a clamped pivot, never NaN),
    else L^{-T} L^{-1} from the library Cholesky."""
    if use_masked(M.shape[-1]) and M.dtype != torch.float64:
        return spd_inv_via_chol(M)
    Li = _chol_inv(M)
    return torch.bmm(Li.mT, Li)


def _spd_solver(S: torch.Tensor):
    """S_solve(r) -> S^{-1} r for a batch of SPD matrices. At the
    reference's f32 sizes its masked explicit inverse. In f64 and above
    MASKED_MAX_DIM the reference applies its Cholesky factor by two
    triangular solves, because an explicit f32 S^{-1} carries a backward
    error about cond(S) times larger; here the two triangular factors of
    S^{-1} = L^{-T} L^{-1} are applied in turn, as matvecs, which keeps
    the triangular solves' accuracy (tests/test_torch_port_forward.py)
    without their cost on the card: with two batched triangular solves an
    apply, bench.py's n=500 Markowitz row issued 65.8k device kernels a
    call instead of 30.0k and took 846 ms instead of 527 (H100)."""
    if use_masked(S.shape[-1]) and S.dtype != torch.float64:
        Sinv = spd_inv_via_chol(S)
        return lambda r: bmv(Sinv, r)
    Li = _chol_inv(S)
    return lambda r: bmv_t(Li, bmv(Li, r))


def make_kkt_precond(dims: ConeDims, n: int):
    """build(x, w, P, q, A, b) -> W, an explicit approximate inverse of
    the KKT Jacobian for the stale-factor PCG polish (kkt_mode='pcg').

    One batched f32 LU solve per polish, then one Newton-Schulz
    refinement W <- W(2I - J W), which squares the factorization residual
    eps*kappa(J). A fixed probe vector keeps whichever of {W, refined W}
    has the smaller true residual ||(I - J W) v||, so a diverging
    refinement (kappa >~ 1e7) never makes the preconditioner worse."""
    _, jacobian, _ = make_kkt(dims, n)
    dim = n + dims.total

    def build(x, w, P, q, A, b):
        with full_f32():
            J = jacobian(x, w, P, q, A, b)
            scale = torch.diagonal(J, dim1=1, dim2=2).abs().mean(-1) + 1.0
            eye = torch.eye(dim, dtype=J.dtype, device=J.device)
            Jr = J + (1e-6 * scale)[:, None, None] * eye
            W, _ = torch.linalg.solve_ex(Jr, eye.expand_as(Jr))
            W = torch.where(torch.isfinite(W), W, 0.0)
            W2 = torch.bmm(W, 2.0 * eye - torch.bmm(J, W))
            v = torch.sin(torch.arange(dim, dtype=J.dtype, device=J.device))
            v = v.expand(J.shape[0], dim)
            r1 = torch.linalg.vector_norm(v - bmv(J, bmv(W, v)), dim=-1)
            r2 = torch.linalg.vector_norm(v - bmv(J, bmv(W2, v)), dim=-1)
            r2 = torch.where(torch.isfinite(r2), r2, torch.inf)
            return torch.where((r2 < r1)[:, None, None], W2, W)

    return build


def make_kkt_solver(dims: ConeDims, n: int, cg_iters: int = 40,
                    schur_iters=None, p_diag_full: bool = True,
                    p_diag_only: bool = False, kkt_mode: str = "auto"):
    """Solve J(x,w) delta = rhs (or J' delta = rhs), per lane.

    f64: dense J + exact LU, with a true-residual check; a lane whose LU
    is not finite or misses the residual bound takes the Tikhonov-
    regularized least-squares direction instead.

    f32, polyhedral cones with a structurally complete P diagonal: the
    generalized Jacobian's D block is a 0/1 diagonal (zero rows: 0;
    nonneg rows: 1[w>0]), so the system reduces EXACTLY to a saddle
    problem on the inactive rows, solved by a range-space Schur split: an
    explicit (P + sigma I)^{-1} (elementwise when P is structurally
    diagonal, else by Cholesky) plus CG on S = A_0 Pinv A_0'.

    f32, every other program (general cones, and polyhedral ones whose P
    diagonal is incomplete, such as LPs), by kkt_mode:
      * "auto": CG on the normal equations at full f32; inside the
        [DENSE_NORMAL_MIN, DENSE_NORMAL_MAX] window of n + m on a
        general-cone program, with J materialized from the factored cone
        Jacobian and H = J'J formed once per solve;
      * "operator": the same CG, never materializing J;
      * "spectral": the exact spectral-Schur solve (solve_spectral)
        through D = Q diag(lam) Q', plus one refinement pass against the
        true Jacobian;
      * a preconditioner W given (the polish's "pcg" mode): left-
        preconditioned CGNR, six iterations on (W J) d = W r."""
    from .linsolve import _cg_normal, _cg_spd

    m = dims.total
    _, jacobian, _ = make_kkt(dims, n)
    dfactor, dapply_f = make_cone_dproj_factored(dims)
    spectral = make_cone_dproj_spectral(dims) if m else None
    polyhedral = dims.is_polyhedral() and p_diag_full
    n_zero = dims.zero
    if not schur_iters:
        # auto: CG on the unsquared Schur system converges in about the
        # active-set size worth of iterations
        schur_iters = max(10, min(25, n // 4 + 8))

    def solve_polyhedral(x, w, P, q, A, b, rhs, transpose):
        dtype = rhs.dtype
        r1 = rhs[:, :n]
        r2 = rhs[:, n:]
        # active mask d (rows where the projection derivative is 1)
        row = torch.arange(m, device=rhs.device)
        d = torch.where(row < n_zero, 0.0, (w > 0).to(dtype))
        inact = 1.0 - d  # rows entering the saddle system
        sig = 1e-6 * (_trace(P) / n + 1.0)
        if p_diag_only:
            # P is structurally diagonal: (P + sig I)^{-1} is elementwise
            pd = 1.0 / (torch.diagonal(P, dim1=1, dim2=2) + sig[:, None])

            def pinv_mv(v):
                return pd * v
        else:
            # Pinv via Cholesky explicit inverse (n x n)
            eye = torch.eye(n, dtype=dtype, device=rhs.device)
            L, _ = torch.linalg.cholesky_ex(P + sig[:, None, None] * eye)
            Li = torch.linalg.solve_triangular(
                L, eye.expand_as(L), upper=False
            )
            Pinv = torch.bmm(Li.mT, Li)

            def pinv_mv(v):
                return bmv(Pinv, v)

        def S_mv(v):
            # masked Schur matvec, identity on active rows
            av = bmv_t(A, inact * v)
            return inact * bmv(A, pinv_mv(av)) + d * v

        if not transpose:
            # [[P, -A_0'], [A_0, 0]] [v1; u] = [r1; r2_0]
            # -> S u = r2_0 - A_0 Pinv r1,  v1 = Pinv (r1 + A_0' u)
            rhs_u = inact * r2 - inact * bmv(A, pinv_mv(r1))
            u = _cg_spd(S_mv, rhs_u, schur_iters)
            v1 = pinv_mv(r1 + bmv_t(A, inact * u))
            # active rows: v2 = r2 - A v1; inactive rows: v2 = u
            v2 = d * (r2 - bmv(A, v1)) + inact * u
            return torch.cat([v1, v2], dim=-1)

        # J' [v1; v2] = r: active rows give v2 = r2 directly; the
        # saddle is [[P, A_0'], [A_0, 0]] [v1; u] = [r1 - A_1' r2_1;
        # -r2_0]  ->  S u = A_0 Pinv rhs1 + r2_0, v1 = Pinv(rhs1-A_0'u)
        rhs1 = r1 - bmv_t(A, d * r2)
        rhs_u = inact * bmv(A, pinv_mv(rhs1)) + inact * r2
        u = _cg_spd(S_mv, rhs_u, schur_iters)
        v1 = pinv_mv(rhs1 - bmv_t(A, inact * u))
        v2 = d * r2 + inact * u
        return torch.cat([v1, v2], dim=-1)

    def factor_spectral(w, P, A):
        """The w-dependent part of the exact spectral-Schur solve, once
        per solve (the reference's compiler shares it between the solve
        and its refinement pass).

        Rotated system (v2 = Q z, G = Q'A, s2 = Q'r2, D = Q diag(lam) Q'):
          row1:  P v1 + G'(lam - 1) z = r1        (J)
                 P v1 + G' z        = r1          (J')
          row2:  G v1 + lam z = s2                (J)
                 (lam - 1) G v1 + lam z = s2      (J')
        Split at lam = 1/2. Rows with lam >= 1/2 eliminate z exactly via
        C = (1-lam)/lam <= 1 into M = P + sigma I + (sqrt(C)G)'(sqrt(C)G)
        (one n x n inverse). Rows with lam < 1/2 keep their exact lam
        through the saddle: J and J' reduce to the same SPD system
        H + diag(lam/(1-lam)) with H = G_N Minv G_N' (one m x m inverse).
        Every derived diagonal is bounded by ~1, so no conditioning is
        created beyond the problem's own; the decomposition is exact."""
        dtype = w.dtype
        # Q's construction and every product below at full f32: TF32
        # degrades Q's orthogonality, which wrecks the directions
        with full_f32():
            Q, lam = spectral(w)
            G = torch.bmm(Q.mT, A)
            el = lam >= 0.5
            msk_el = el.to(dtype)
            msk_n = 1.0 - msk_el
            lam_e = torch.where(el, lam, 1.0)        # for E-row divisions
            one_m = torch.where(el, 1.0, 1.0 - lam)  # (1-lam) on N rows
            C = msk_el * (1.0 - lam) / lam_e         # in [0, 1]
            Dp = msk_n * lam / one_m                 # lam/(1-lam) in [0, 1)
            sig = 1e-3 * (_trace(P) / n + 1.0)
            Gc = torch.sqrt(C)[:, :, None] * G
            eye_n = torch.eye(n, dtype=dtype, device=w.device)
            M = P + sig[:, None, None] * eye_n + torch.bmm(Gc.mT, Gc)
            Minv = _spd_inv(M)
            GM = torch.bmm(G, Minv)  # (B, m, n)
            H = msk_n[:, :, None] * torch.bmm(GM, G.mT) * msk_n[:, None, :]
            # saddle diagonal floor scaled to H: the Gram product's f32
            # rounding is ~eps*||H||
            s_floor = 1e-6 * (_trace(H) / m) + 1e-7
            S = H + torch.diag_embed(Dp + msk_el + s_floor[:, None] * msk_n)
            S_solve = _spd_solver(S)
        return Q, G, GM, Minv, S_solve, msk_el, msk_n, lam_e, one_m, C

    def solve_spectral(fac, rhs, transpose):
        """Exact spectral-Schur solve of J d = rhs (or J' d = rhs) from
        factor_spectral's state."""
        Q, G, GM, Minv, S_solve, msk_el, msk_n, lam_e, one_m, C = fac
        r1 = rhs[:, :n]
        with full_f32():
            s2 = bmv_t(Q, rhs[:, n:])
            if not transpose:
                # M v1 - G_N' z'_N = rhat,  (H + Dp) z' = s2_N - G_N Minv
                # rhat with z'_N = (1-lam) z_N
                rhat = r1 + bmv_t(G, C * s2)
                zp = S_solve(msk_n * (s2 - bmv(GM, rhat)))
                v1 = bmv(Minv, rhat + bmv_t(G, msk_n * zp))
                z = (msk_el * (s2 - bmv(G, v1)) / lam_e
                     + msk_n * zp / one_m)
            else:
                # M v1 + G_N' z_N = rhat,
                # (H + Dp) z_N = (1-lam)^{-1} s2_N + G_N Minv rhat
                rhat = r1 - bmv_t(G, msk_el * s2 / lam_e)
                zn = S_solve(msk_n * (s2 / one_m + bmv(GM, rhat)))
                v1 = bmv(Minv, rhat - bmv_t(G, msk_n * zn))
                z = (msk_el * (s2 / lam_e + C * bmv(G, v1))
                     + msk_n * zn)
            return torch.cat([v1, bmv(Q, z)], dim=-1)

    last_jac = [None, None]  # ((x, w, P, A), J) of the last f64 solve

    def solve(x, w, P, q, A, b, rhs, transpose=False,
              regularized=False, iter_refine=False, precond=None):
        """precond: an optional (B, n+m, n+m) approximate inverse of J
        (make_kkt_precond): the f32 branch then runs left-preconditioned
        CGNR on (W J) d = W r instead of CG on J'J, whose squared
        conditioning is the accuracy floor on curvature-deficient
        polishes."""
        if rhs.dtype == torch.float64:
            # the polish asks for the exact and the regularized direction
            # at the same point: the Jacobian is built once for both
            key = (x, w, P, A)
            if not (last_jac[0] and all(
                    a is b_ for a, b_ in zip(last_jac[0], key))):
                last_jac[:] = [key, jacobian(x, w, P, q, A, b)]
            J = last_jac[1]
            M = J.mT if transpose else J

            def _reg_lstsq():
                # Tikhonov-regularized least squares: robust when strict
                # complementarity fails and J is numerically singular
                MtM = torch.bmm(M.mT, M)
                dim = MtM.shape[-1]
                eps_r = 1e-12 * (_trace(MtM) / dim + 1.0)
                eye = torch.eye(dim, dtype=rhs.dtype, device=rhs.device)
                L, _ = torch.linalg.cholesky_ex(MtM + eps_r[:, None, None]
                                                * eye)
                rhs2 = bmv_t(M, rhs)
                return torch.cholesky_solve(rhs2.unsqueeze(-1),
                                            L).squeeze(-1)

            if regularized:
                return _reg_lstsq()
            sol, _ = torch.linalg.solve_ex(M, rhs)
            # singular J -> LU yields NaN/garbage; detect via finiteness +
            # true residual and fall back to the damped least squares
            sol_ok = torch.where(torch.isfinite(sol), sol, 0.0)
            resid = torch.linalg.vector_norm(bmv(M, sol_ok) - rhs, dim=-1)
            good = torch.isfinite(sol).all(dim=-1) & (
                resid <= 1e-6 * (torch.linalg.vector_norm(rhs, dim=-1)
                                 + 1.0)
            )
            if bool(good.all()):
                return sol_ok
            return torch.where(good[:, None], sol_ok, _reg_lstsq())

        # factor the projection Jacobian ONCE per solve: w is fixed for
        # every matvec, and the exp/pow root finds and PSD eigh inside it
        # would dominate if recomputed per matvec
        dstate = dfactor(w)

        def mv(v):
            v1, v2 = v[:, :n], v[:, n:]
            Dv2 = dapply_f(dstate, v2)
            return torch.cat(
                [bmv(P, v1) + bmv_t(A, Dv2 - v2), bmv(A, v1) + Dv2], dim=-1
            )

        def mvT(u):
            u1, u2 = u[:, :n], u[:, n:]
            Au1 = bmv(A, u1)
            return torch.cat(
                [bmv(P, u1) + bmv_t(A, u2), dapply_f(dstate, Au1 + u2) - Au1],
                dim=-1,
            )

        a_op, aT_op = (mvT, mv) if transpose else (mv, mvT)
        use_spectral = kkt_mode == "spectral" and not polyhedral
        dense_normal = (
            precond is None
            and not use_spectral
            and not dims.is_polyhedral()
            and kkt_mode != "operator"
            and 0 < m and DENSE_NORMAL_MIN <= (n + m) <= DENSE_NORMAL_MAX
        )
        if dense_normal:
            # materialize J from the factored cone-Jacobian state (the
            # root finds and eigh of dfactor are not recomputed: the
            # apply is masks and small products over the identity)
            with full_f32():
                eye_m = torch.eye(m, dtype=rhs.dtype, device=rhs.device)
                D = dapply_f(dstate, eye_m.expand(rhs.shape[0], m, m)).mT
                Jd = torch.cat([
                    torch.cat([P, torch.bmm(A.mT, D - eye_m)], dim=2),
                    torch.cat([A, D], dim=2),
                ], dim=1)
                Md = Jd.mT if transpose else Jd
                Hd = torch.bmm(Md.mT, Md)
        fac = factor_spectral(w, P, A) if use_spectral else None

        def solve_once(r):
            if polyhedral:
                return solve_polyhedral(x, w, P, q, A, b, r, transpose)
            if use_spectral:
                return solve_spectral(fac, r, transpose)
            with full_f32():
                if precond is not None:
                    # left-preconditioned CGNR: with W ~ J0^{-1} (stale by
                    # a few Newton steps), W J = I + O(step), so ~6
                    # iterations reach the f32 floor whatever kappa(J)
                    W = precond
                    if transpose:
                        # J' d = r  ->  (W'J') d = W'r
                        return _cg_normal(lambda v_: bmv_t(W, mvT(v_)),
                                          lambda u_: mv(bmv(W, u_)),
                                          bmv_t(W, r), 6)
                    # J d = r  ->  (W J) d = W r
                    return _cg_normal(lambda v_: bmv(W, mv(v_)),
                                      lambda u_: mvT(bmv_t(W, u_)),
                                      bmv(W, r), 6)
                # CG on the normal equations at full f32
                if dense_normal:
                    return _cg_spd(lambda v: bmv(Hd, v), bmv_t(Md, r),
                                   cg_iters)
                return _cg_normal(a_op, aT_op, r, cg_iters)

        sol = solve_once(rhs)
        if use_spectral:
            # one refinement pass against the TRUE Jacobian absorbs the
            # spectral solve's regularization bias
            with full_f32():
                resid0 = rhs - a_op(sol)
            sol = sol + solve_once(resid0)
        if iter_refine:
            # one step of iterative refinement with the true-precision
            # residual (used by the adjoint, where the solve accuracy is
            # the gradient accuracy)
            with full_f32():
                resid = rhs - a_op(sol)
            sol = sol + solve_once(resid)
        return sol

    return solve
