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
from ..cones.jacobians import make_cone_dproj_dense, make_cone_dproj_factored
from ..cones.projections import make_cone_projector
from ..utils.precision import full_f32
from .admm import bmv, bmv_t


def make_kkt(dims: ConeDims, n: int):
    m = dims.total
    proj = make_cone_projector(dims)
    dproj = make_cone_dproj_dense(dims)

    def residual(x, w, P, q, A, b):
        # F is a catastrophic cancellation (O(1) operands, near-zero
        # result): full f32, never TF32
        with full_f32():
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

    f32, polyhedral cones with an incomplete P diagonal (LPs such as
    LAD): matvec-only CG on the normal equations.

    kkt_mode 'spectral' and the dense-normal window serve general cones
    and arrive with the general-cone later port slice."""
    from .linsolve import _cg_normal, _cg_spd

    m = dims.total
    _, jacobian, _ = make_kkt(dims, n)
    dfactor, dapply_f = make_cone_dproj_factored(dims)
    polyhedral = dims.is_polyhedral() and p_diag_full
    if kkt_mode == "spectral" and not polyhedral:
        raise NotImplementedError(
            "kkt_mode='spectral' arrives with the general-cone later port "
            "slice"
        )
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
        sig = 1e-6 * (torch.diagonal(P, dim1=1, dim2=2).sum(-1) / n + 1.0)
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

    def solve(x, w, P, q, A, b, rhs, transpose=False,
              regularized=False, iter_refine=False, precond=None):
        if precond is not None:
            raise NotImplementedError(
                "the stale-factor PCG route (kkt_mode='pcg') arrives with "
                "the general-cone later port slice"
            )
        if rhs.dtype == torch.float64:
            J = jacobian(x, w, P, q, A, b)
            M = J.mT if transpose else J

            def _reg_lstsq():
                # Tikhonov-regularized least squares: robust when strict
                # complementarity fails and J is numerically singular
                MtM = torch.bmm(M.mT, M)
                dim = MtM.shape[-1]
                tr = torch.diagonal(MtM, dim1=1, dim2=2).sum(-1)
                eps_r = 1e-12 * (tr / dim + 1.0)
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

        def solve_once(r):
            if polyhedral:
                return solve_polyhedral(x, w, P, q, A, b, r, transpose)
            # CG on the normal equations at full f32
            with full_f32():
                a, aT = (mvT, mv) if transpose else (mv, mvT)
                return _cg_normal(a, aT, r, cg_iters)

        sol = solve_once(rhs)
        if iter_refine:
            # one step of iterative refinement with the true-precision
            # residual (used by the adjoint, where the solve accuracy is
            # the gradient accuracy)
            with full_f32():
                resid = rhs - (mvT(sol) if transpose else mv(sol))
            sol = sol + solve_once(resid)
        return sol

    return solve
