from .cvxpylayer import CvxpyLayer, SolverError, WarmStart
from .rescue import solve_with_rescue

__all__ = ["CvxpyLayer", "SolverError", "WarmStart", "solve_with_rescue"]
