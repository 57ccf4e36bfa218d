from .admm import SolveResult, make_admm_solver
from .kkt import make_kkt, make_kkt_solver
from .refine import make_polished_solver, make_refiner
from .settings import (
    DUAL_INFEASIBLE,
    MAX_ITERS,
    PRIMAL_INFEASIBLE,
    SOLVED,
    SolverSettings,
)

__all__ = [
    "DUAL_INFEASIBLE",
    "MAX_ITERS",
    "PRIMAL_INFEASIBLE",
    "SOLVED",
    "SolveResult",
    "SolverSettings",
    "make_admm_solver",
    "make_kkt",
    "make_kkt_solver",
    "make_polished_solver",
    "make_refiner",
]
