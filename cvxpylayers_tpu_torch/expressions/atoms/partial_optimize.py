"""partial_optimize: inf/sup-projection of a problem onto a variable
subset (cvxpy.partial_optimize parity).

g(x) = inf_z { f(x, z) : constraints(x, z) }  for a Minimize problem
(sup_z for Maximize). Infimal projections of jointly convex functions
are convex, so g composes under DCP with the curvature of the inner
objective.

Conic construction: nothing beyond the standard graph-implementation
trick is needed — the optimized variables z are canonicalized as fresh
columns and the inner constraints are added as real cone blocks; in a
minimization context the solver's inf over ALL columns performs the
projection exactly. (This is the same existential-variable mechanism
every epigraph atom uses; cvxpy routes it through a specialized
PartialProblem atom instead.)
"""

from __future__ import annotations

from ..expression import Curvature, Sign
from .base import Atom


class PartialOptimize(Atom):
    raw_canon = True

    def __init__(self, prob, opt_vars, device=None):
        from ..problem import Maximize, Minimize, Problem

        if not isinstance(prob, Problem):
            raise ValueError("partial_optimize needs a Problem")
        self._prob = prob
        # where the numeric value's inner solve runs (Problem.solve's
        # device: the card by default)
        self.device = device
        self._minimize = isinstance(prob.objective, Minimize)
        if not self._minimize and not isinstance(prob.objective, Maximize):
            raise ValueError("unknown objective sense")
        if not prob.is_dcp():
            raise ValueError("partial_optimize inner problem is not DCP")
        self._opt_vars = list(opt_vars)
        opt_ids = {id(v) for v in self._opt_vars}
        self._outer_vars = [
            v for v in prob.variables() if id(v) not in opt_ids
        ]
        super().__init__()

    def shape_from_args(self):
        return ()

    def is_atom_convex(self):
        return self._minimize

    def is_atom_concave(self):
        return not self._minimize

    def curvature(self):
        return Curvature.CONVEX if self._minimize else Curvature.CONCAVE

    def sign(self):
        return Sign.UNKNOWN

    def variables(self):
        return list(self._outer_vars)

    def parameters(self):
        return self._prob.parameters()

    def _dpp_ok(self):
        return self._prob.is_dpp()

    def canon(self, ctx, _):
        for z in self._opt_vars:
            if id(z) in ctx.var_offsets:
                raise ValueError(
                    "partial_optimize optimized variable may not be used "
                    "outside the inner problem"
                )
        for c in self._prob.constraints:
            ctx.canon_constraint(c)
        rep = ctx.rep_of(self._prob.objective.expr)
        return rep


def partial_optimize(prob, opt_vars=None, dont_opt_vars=None, device=None):
    """Expression-valued inf (Minimize) / sup (Maximize) of `prob` over
    `opt_vars`, as a function of the remaining variables (cvxpy parity:
    cvxpy/transforms/partial_optimize.py). Exactly one of opt_vars /
    dont_opt_vars may be given; the other is inferred. `device` is where
    the expression's .value runs its inner Problem.solve: the card by
    default, "cpu" on request."""
    all_vars = prob.variables()
    if opt_vars is None and dont_opt_vars is None:
        raise ValueError("specify opt_vars or dont_opt_vars")
    if opt_vars is None:
        keep = {id(v) for v in dont_opt_vars}
        opt_vars = [v for v in all_vars if id(v) not in keep]
    elif dont_opt_vars is not None:
        declared = {id(v) for v in opt_vars} | {id(v) for v in dont_opt_vars}
        missing = [v for v in all_vars if id(v) not in declared]
        if missing:
            raise ValueError(
                "every inner-problem variable must be in opt_vars or "
                f"dont_opt_vars; missing {missing}"
            )
    return PartialOptimize(prob, opt_vars, device=device)
