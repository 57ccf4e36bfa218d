"""Minimize/Maximize objectives and Problem container with DCP/DPP checks.

Mirrors the construction-time validation the reference performs in
parse_args._validate_problem (cvxpylayers utils/parse_args.py:265-328).
"""

from __future__ import annotations

from .expression import as_expression


class Objective:
    def __init__(self, expr):
        self.expr = as_expression(expr)
        if not self.expr.is_scalar():
            raise ValueError("objective must be scalar")


class Minimize(Objective):
    def is_dcp(self) -> bool:
        return self.expr.is_convex()


class Maximize(Objective):
    def is_dcp(self) -> bool:
        return self.expr.is_concave()


class Problem:
    def __init__(self, objective: Objective, constraints=None):
        if not isinstance(objective, Objective):
            raise ValueError("objective must be Minimize(...) or Maximize(...)")
        self.objective = objective
        self.constraints = list(constraints or [])
        #: populated by solve() (cvxpy API)
        self.value = None
        self.status = None

    def solve(self, solver_args=None, gp: bool = False,
              device=None) -> float:
        """cvxpy-style plain solve: uses current `Parameter.value`s,
        populates `Variable.value`, `constraint.dual_value`,
        `self.status` and `self.value`, and returns the optimal value.
        The canonicalized program and the layer are cached on the
        problem (one per gp flag and device), so changing parameter
        values and re-solving is cheap.

        `device` is the layer's: the card by default ("cuda", which
        raises where CUDA is absent); pass device="cpu" to solve on the
        CPU. Statuses use cvxpy's strings ("optimal",
        "optimal_inaccurate", "infeasible", "unbounded").
        """
        from ..layer.cvxpylayer import solve_problem

        return solve_problem(self, solver_args=solver_args, gp=gp,
                             device=device)

    def variables(self):
        seen = {}
        for v in self.objective.expr.variables():
            seen[id(v)] = v
        for c in self.constraints:
            for v in c.variables():
                seen[id(v)] = v
        return list(seen.values())

    def parameters(self):
        seen = {}
        for p in self.objective.expr.parameters():
            seen[id(p)] = p
        for c in self.constraints:
            for p in c.parameters():
                seen[id(p)] = p
        return list(seen.values())

    def is_dcp(self) -> bool:
        return self.objective.is_dcp() and all(c.is_dcp() for c in self.constraints)

    def is_dgp(self) -> bool:
        """Log-log (geometric-program) discipline check (cvxpy API)."""
        from ..canon.dgp import is_dgp

        return is_dgp(self)

    def is_dpp(self) -> bool:
        if not self.is_dcp():
            return False
        obj_ok = self.objective.expr._dpp_ok()
        return obj_ok and all(c._dpp_ok() for c in self.constraints)
