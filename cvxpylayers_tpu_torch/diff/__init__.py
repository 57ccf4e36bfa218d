from .derivative import make_diff_solver

__all__ = ["make_diff_solver"]
