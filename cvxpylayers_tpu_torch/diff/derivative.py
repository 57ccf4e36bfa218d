"""Implicit differentiation of the cone program solution map.

Counterpart of cvxpylayers_tpu/diff/derivative.py::make_diff_solver (and
of the derivative half of cvxpylayers_tpu/solver/matfree.py). A
`torch.autograd.Function` around the (base solver + Newton-polish)
solve, with two rules on the KKT residual map F(x, w) = 0
(solver/kkt.py), each one linear solve with its generalized Jacobian J:

  * the adjoint (backward, `derivative="adjoint"`, the default):
        [u; v] = -J^{-T} [g_x ; (D-I)' g_y + D' g_s]
        dq = u,  db = -v,  dP = u x',  dA = y u' + v x'
  * the forward-mode rule (jvp, `derivative="forward"`), for data
    tangents (dP, dq, dA, db):
        J [dx; dw] = -[dP x + dq + dA' y ; dA x - db]
        ds = D dw,  dy = D dw - dw

Each setting has exactly one rule, as in the reference, whose adjoint is
a custom_vjp and whose forward rule a custom_jvp that JAX cannot
transpose: a forward-mode pass through an adjoint solve raises, and so
does a backward pass through a forward-mode solve. Warm-start tangents
are ignored (the solution map does not depend on the initialization);
statuses and iteration counts carry no derivative.

Everything around the solve (the scatter from the parameter-affine value
vectors, batching, variable recovery) is plain differentiable torch, so
this is the only custom rule in the package. The base solver is ADMM
(`solve_method="admm"`), the interior-point method (`"ipm"`) or PDHG
(`"pdhg"`, problems without a quadratic objective). On the sparse route
the data are (B, nnz) value tensors of a static pattern
(solver/matfree.py), and both rules work at the nnz positions only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from ..cones.dims import ConeDims
from ..cones.jacobians import make_cone_dproj_apply
from ..solver.admm import bmv, bmv_t
from ..solver.kkt import make_kkt_solver
from ..solver.matfree import (
    make_matfree_kkt_solver,
    make_matfree_pdhg_solver,
    make_matfree_polished_solver,
)
from ..solver.refine import make_polished_solver
from ..solver.settings import SolverSettings
from ..utils.profiling import spanned


class _Rule(NamedTuple):
    """What the two passes of _ImplicitSolve share: the forward solve, the
    KKT solver, the cone Jacobian apply, n, the setting's derivative rule
    ("adjoint" or "forward") and, on the sparse route, the SparseOps of
    the data pattern (None on the dense route)."""

    base: object
    kkt_solve: object
    dapply: object
    n: int
    derivative: str
    ops: Optional[object] = None


def _finite_lanes(*vs: torch.Tensor) -> torch.Tensor:
    """(B, 1) mask of the lanes on which every vector is finite."""
    ok = torch.isfinite(vs[0]).all(dim=-1, keepdim=True)
    for v in vs[1:]:
        ok = ok & torch.isfinite(v).all(dim=-1, keepdim=True)
    return ok


class _ImplicitSolve(torch.autograd.Function):
    """solve(P, q, A, b, x0, y0, s0) -> (x, y, s, status, iters) with the
    implicit-function adjoint (backward) or forward-mode rule (jvp), as
    the rule's setting says."""

    @staticmethod
    def forward(rule, P, q, A, b, x0, y0, s0):
        res = rule.base(P, q, A, b, x0, y0, s0)
        return res.x, res.y, res.s, res.status, res.iters

    @staticmethod
    def setup_context(ctx, inputs, output):
        rule, P, q, A, b = inputs[:5]
        x, y, s, status, iters = output
        ctx.rule = rule
        if rule.derivative == "forward":
            ctx.save_for_forward(x, y, s, P, q, A, b)
        else:
            ctx.save_for_backward(x, y, s, P, q, A, b)
        ctx.mark_non_differentiable(status, iters)

    @staticmethod
    def jvp(ctx, _rule, dP, dq, dA, db, _dx0, _dy0, _ds0):
        rule = ctx.rule
        if rule.derivative != "forward":
            raise RuntimeError(
                "forward-mode differentiation needs derivative='forward' "
                "in solver_args; the default rule is the adjoint "
                "(backward only)")
        n, ops = rule.n, rule.ops
        x, y, s, P, q, A, b = ctx.saved_tensors
        dP, dq, dA, db = (torch.zeros_like(t) if d is None else d
                          for d, t in zip((dP, dq, dA, db), (P, q, A, b)))
        w = s - y
        if ops is None:
            dF1 = bmv(dP, x) + dq + bmv_t(dA, y)
            dF2 = bmv(dA, x) - db
        else:
            dF1 = ops.P_mv(dP, x) + dq + ops.A_rmv(dA, y)
            dF2 = ops.A_mv(dA, x) - db
        rhs = torch.cat([dF1, dF2], dim=-1)
        duv = -rule.kkt_solve(x, w, P, q, A, b, rhs, transpose=False,
                              iter_refine=rhs.dtype != torch.float64)
        # a lane whose tangent is not finite gets zero; the others keep
        # theirs
        duv = torch.where(_finite_lanes(duv), duv, 0.0)
        dx = duv[:, :n]
        dw = duv[:, n:]
        Ddw = rule.dapply(w, dw)
        return dx, Ddw - dw, Ddw, None, None

    @staticmethod
    @once_differentiable
    @spanned("adjoint")
    def backward(ctx, dx, dy, ds, _dstatus, _diters):
        rule = ctx.rule
        if rule.derivative != "adjoint":
            raise RuntimeError(
                "derivative='forward' has a forward-mode rule only (as in "
                "the reference, whose custom_jvp cannot be transposed); "
                "pass derivative='adjoint' (the default) to backpropagate")
        n, ops = rule.n, rule.ops
        x, y, s, P, q, A, b = ctx.saved_tensors
        w = s - y
        # (D - I)' dy + D' ds with D symmetric block-diagonal
        g_w = rule.dapply(w, dy + ds) - dy
        rhs = torch.cat([dx, g_w], dim=-1)
        # the solve accuracy IS the gradient accuracy: one refinement
        # step lifts f32 directions to ~1e-6 relative
        uv = -rule.kkt_solve(x, w, P, q, A, b, rhs, transpose=True,
                             iter_refine=rhs.dtype != torch.float64)
        # a lane whose solution or adjoint solve is not finite gets a
        # zero gradient (x and y are zeroed too: 0 * NaN in the outer
        # products below would bring the NaN back); the other lanes keep
        # theirs
        finite = _finite_lanes(uv, x, y)
        uv = torch.where(finite, uv, 0.0)
        x = torch.where(finite, x, 0.0)
        y = torch.where(finite, y, 0.0)
        u = uv[:, :n]
        v = uv[:, n:]
        need_P, need_q, need_A, need_b = ctx.needs_input_grad[1:5]
        if ops is None:
            # dP is the VJP of the literal residual map F1 = P x + ... (no
            # symmetrization: a symmetric parametrization chains through
            # the caller's own construction of P)
            dP = u[:, :, None] * x[:, None, :] if need_P else None
            dA = (y[:, :, None] * u[:, None, :]
                  + v[:, :, None] * x[:, None, :]) if need_A else None
        else:
            # at the pattern's nnz positions only
            dP = ops.P_data_grad(u, x) if need_P else None
            dA = ops.A_data_grad(y, u, v, x) if need_A else None
        dq = u if need_q else None
        db = -v if need_b else None
        return None, dP, dq, dA, db, None, None, None


def _solve_with(rule: _Rule):
    def solve(P, q, A, b, x0, y0, s0):
        return _ImplicitSolve.apply(rule, P, q, A, b, x0, y0, s0)

    return solve


def make_diff_solver(dims: ConeDims, n: int, settings: SolverSettings,
                     p_diag_full: bool = True, p_diag_only: bool = False,
                     p_zero: bool = False):
    """Returns solve(P, q, A, b, x0, y0, s0) -> (x, y, s, status, iters)
    over batched tensors, with implicit-diff derivatives with respect to
    (P, q, A, b): the adjoint, or under derivative="forward" the
    forward-mode rule.

    p_diag_full: static flag, True iff P's diagonal is structurally
    complete; routes the f32 KKT solves between the exact Schur split and
    CG-normal (kkt.py). p_zero: static flag, True iff P is structurally
    zero; the IPM then takes the homogeneous self-dual embedding under
    ipm_mode="auto" (and "hsde" requires it), and PDHG requires it."""
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
        from ..solver.pdhg import make_pdhg_solver

        if not p_zero:
            raise ValueError(
                "solve_method='pdhg' requires a problem with no "
                "quadratic objective (PDHG's x-update is a gradient "
                "step); use 'admm' (default) or 'ipm'."
            )
        base = make_polished_solver(
            dims, n, settings, base=make_pdhg_solver(dims, n, settings),
            p_diag_full=p_diag_full, p_diag_only=p_diag_only,
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
    return _solve_with(_Rule(base, kkt_solve, make_cone_dproj_apply(dims), n,
                             settings.derivative))


def make_matfree_diff_solver(ops, dims: ConeDims, n: int,
                             settings: SolverSettings,
                             p_diag_only: bool = False):
    """solve(P_data, q, A_data, b, x0, y0, s0) -> (x, y, s, status, iters)
    on the sparse route, with the same two rules with respect to the data
    VECTORS (P_data, q, A_data, b) of `ops`' pattern: the backward cost is
    O(nnz), never O(mn). Takes 'admm' and 'pdhg'; the IPM needs the dense
    assembly."""
    if settings.solve_method == "ipm":
        raise ValueError(
            "solve_method='ipm' requires the dense assembly route; the "
            "sparse large-instance path supports 'admm' and 'pdhg' "
            "(pass solver_args={'assembly': 'dense'} to force dense, "
            "or drop solve_method)."
        )
    first_order = None
    if settings.solve_method == "pdhg":
        if ops.nnz_P:
            raise ValueError(
                "solve_method='pdhg' requires a problem with no "
                "quadratic objective (PDHG's x-update is a gradient "
                "step); use 'admm' (default)."
            )
        first_order = make_matfree_pdhg_solver(ops, dims, n, settings)
    base = make_matfree_polished_solver(ops, dims, n, settings,
                                        p_diag_only=p_diag_only,
                                        base=first_order)
    kkt_solve = make_matfree_kkt_solver(
        ops, dims, n, cg_iters=settings.cg_iters,
        schur_iters=settings.schur_iters, p_diag_only=p_diag_only,
    )
    return _solve_with(_Rule(base, kkt_solve, make_cone_dproj_apply(dims), n,
                             settings.derivative, ops))
