from .stuffer import ConeProgram, DualInfo, VarInfo, eval_data, stuff
from .tensor_rep import CONST, TensorRep

__all__ = [
    "CONST",
    "ConeProgram",
    "DualInfo",
    "TensorRep",
    "VarInfo",
    "eval_data",
    "stuff",
]
