from .cvxpylayer import CvxpyLayer, SolverError, WarmStart

__all__ = ["CvxpyLayer", "SolverError", "WarmStart"]
