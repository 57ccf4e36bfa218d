"""The forward solve behind the layer.

Counterpart of cvxpylayers_tpu/diff/derivative.py::make_diff_solver,
forward only: the ADMM base solve plus the Newton polish. The implicit-
function adjoint (the reference's custom_vjp) is the first item of the
next port slice; until then the layer refuses inputs that require
gradients.
"""

from __future__ import annotations

from ..cones.dims import ConeDims
from ..solver.refine import make_polished_solver
from ..solver.settings import SolverSettings


def make_diff_solver(dims: ConeDims, n: int, settings: SolverSettings,
                     p_diag_full: bool = True, p_diag_only: bool = False,
                     p_zero: bool = False):
    """Returns solve(P, q, A, b, x0, y0, s0) -> (x, y, s, status, iters)
    over batched tensors.

    p_diag_full: static flag, True iff P's diagonal is structurally
    complete; routes the f32 KKT solves between the exact Schur split and
    CG-normal (kkt.py). p_zero is accepted for parity with the reference,
    where it selects the IPM's embedding."""
    del p_zero
    if settings.solve_method != "admm":
        raise NotImplementedError(
            f"solve_method={settings.solve_method!r} arrives with a later "
            "port slice; this slice runs 'admm'"
        )
    if settings.derivative == "forward":
        raise NotImplementedError(
            "derivative='forward' arrives with a later port slice"
        )
    base = make_polished_solver(dims, n, settings,
                                p_diag_full=p_diag_full,
                                p_diag_only=p_diag_only,
                                masked_factor=p_diag_full)

    def solve(P, q, A, b, x0, y0, s0):
        res = base(P, q, A, b, x0, y0, s0)
        return res.x, res.y, res.s, res.status, res.iters

    return solve
