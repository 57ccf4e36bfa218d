"""Implicit differentiation of the cone program solution map.

Counterpart of cvxpylayers_tpu/diff/derivative.py::make_diff_solver. A
`torch.autograd.Function` around the (base solver + Newton-polish)
solve: the backward pass applies the implicit function theorem to the
KKT residual map F(x, w) = 0 (solver/kkt.py), solving one transposed
linear system per cotangent and assembling gradients with respect to the
dense problem data (P, q, A, b):

    [u; v] = -J^{-T} [g_x ; (D-I)' g_y + D' g_s]
    dq = u,  db = -v,  dP = u x',  dA = y u' + v x'

Everything around the dense (P, q, A, b) (the scatter from the
parameter-affine value vectors, batching, variable recovery) is plain
differentiable torch, so this is the only custom rule in the package.
The base solver is ADMM (`solve_method="admm"`) or the primal-dual
interior-point method (`"ipm"`); PDHG and the forward-mode rule
(`derivative="forward"`) are not ported yet and raise.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..cones.dims import ConeDims
from ..cones.jacobians import make_cone_dproj_apply
from ..solver.kkt import make_kkt_solver
from ..solver.refine import make_polished_solver
from ..solver.settings import SolverSettings


class _ImplicitSolve(torch.autograd.Function):
    """solve(P, q, A, b, x0, y0, s0) -> (x, y, s, status, iters) with the
    implicit-function adjoint. `rule` carries the closures the two passes
    share: (base, kkt_solve, dapply, n)."""

    @staticmethod
    def forward(ctx, rule, P, q, A, b, x0, y0, s0):
        base = rule[0]
        res = base(P, q, A, b, x0, y0, s0)
        ctx.rule = rule
        ctx.save_for_backward(res.x, res.y, res.s, P, q, A, b)
        ctx.mark_non_differentiable(res.status, res.iters)
        return res.x, res.y, res.s, res.status, res.iters

    @staticmethod
    @once_differentiable
    def backward(ctx, dx, dy, ds, _dstatus, _diters):
        _, kkt_solve, dapply, n = ctx.rule
        x, y, s, P, q, A, b = ctx.saved_tensors
        w = s - y
        # (D - I)' dy + D' ds with D symmetric block-diagonal
        g_w = dapply(w, dy + ds) - dy
        rhs = torch.cat([dx, g_w], dim=-1)
        # the solve accuracy IS the gradient accuracy: one refinement
        # step lifts f32 directions to ~1e-6 relative
        uv = -kkt_solve(x, w, P, q, A, b, rhs, transpose=True,
                        iter_refine=rhs.dtype != torch.float64)
        # a lane whose solution or adjoint solve is not finite gets a zero
        # gradient (x and y are zeroed too: 0 * NaN in the outer products
        # below would bring the NaN back); the other lanes keep theirs
        finite = (torch.isfinite(uv).all(dim=-1, keepdim=True)
                  & torch.isfinite(x).all(dim=-1, keepdim=True)
                  & torch.isfinite(y).all(dim=-1, keepdim=True))
        uv = torch.where(finite, uv, 0.0)
        x = torch.where(finite, x, 0.0)
        y = torch.where(finite, y, 0.0)
        u = uv[:, :n]
        v = uv[:, n:]
        need_P, need_q, need_A, need_b = ctx.needs_input_grad[1:5]
        # dP is the VJP of the literal residual map F1 = P x + ... (no
        # symmetrization: a symmetric parametrization chains through the
        # caller's own construction of P)
        dP = u[:, :, None] * x[:, None, :] if need_P else None
        dq = u if need_q else None
        dA = (y[:, :, None] * u[:, None, :]
              + v[:, :, None] * x[:, None, :]) if need_A else None
        db = -v if need_b else None
        return None, dP, dq, dA, db, None, None, None


def make_diff_solver(dims: ConeDims, n: int, settings: SolverSettings,
                     p_diag_full: bool = True, p_diag_only: bool = False,
                     p_zero: bool = False):
    """Returns solve(P, q, A, b, x0, y0, s0) -> (x, y, s, status, iters)
    over batched tensors, with implicit-diff gradients with respect to
    (P, q, A, b).

    p_diag_full: static flag, True iff P's diagonal is structurally
    complete; routes the f32 KKT solves between the exact Schur split and
    CG-normal (kkt.py). p_zero: static flag, True iff P is structurally
    zero; the reference's IPM then takes the homogeneous self-dual
    embedding under ipm_mode="auto", which is not ported yet."""
    if settings.derivative == "forward":
        raise NotImplementedError(
            "derivative='forward' (the JVP rule) is not ported yet; pass "
            "derivative='adjoint' (the default)"
        )
    if settings.solve_method == "ipm":
        from ..solver.ipm import make_ipm_solver

        if settings.ipm_mode == "hsde" and not p_zero:
            raise ValueError(
                "ipm_mode='hsde' requires a problem with no quadratic "
                "objective (the homogeneous self-dual embedding is a "
                "conic-LP formulation); drop ipm_mode or the quadratic."
            )
        # auto: the reference embeds only symmetric-cone problems with a
        # structurally zero P
        symmetric = dims.exp == 0 and not dims.pow3
        hsde = p_zero and (
            settings.ipm_mode == "hsde"
            or (settings.ipm_mode == "auto" and symmetric)
        )
        base = make_polished_solver(
            dims, n, settings,
            base=make_ipm_solver(dims, n, settings, hsde=hsde),
            p_diag_full=p_diag_full, p_diag_only=p_diag_only,
        )
    elif settings.solve_method == "pdhg":
        raise NotImplementedError(
            "solve_method='pdhg' is not ported yet; pass 'admm' (the "
            "default) or 'ipm'"
        )
    else:
        base = make_polished_solver(dims, n, settings,
                                    p_diag_full=p_diag_full,
                                    p_diag_only=p_diag_only,
                                    masked_factor=p_diag_full)
    kkt_solve = make_kkt_solver(dims, n, cg_iters=settings.cg_iters,
                                schur_iters=settings.schur_iters,
                                p_diag_full=p_diag_full,
                                p_diag_only=p_diag_only,
                                kkt_mode=settings.kkt_mode)
    rule = (base, kkt_solve, make_cone_dproj_apply(dims), n)

    def solve(P, q, A, b, x0, y0, s0):
        return _ImplicitSolve.apply(rule, P, q, A, b, x0, y0, s0)

    return solve
