from .precision import full_f32
from .profiling import PhaseTimer, problem_summary, trace_annotation

__all__ = ["PhaseTimer", "full_f32", "problem_summary", "trace_annotation"]
