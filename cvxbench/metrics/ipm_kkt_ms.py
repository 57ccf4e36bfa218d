"""ipm_kkt_ms: milliseconds per profiled step inside the program's
`ipm.kkt_factor` and `ipm.kkt_solve` spans (the IPM's KKT factor, once
an iteration, and its predictor, corrector and refinement solves).
Timed by CUDA events on the program's stream, under the profiler, by
the recording that ipm_trips' reader opens (its own here); a program
without those spans reads nothing."""

from cvxbench.spec import metric_module


def recording(record: list):
    return metric_module("ipm_trips").recording(record)


def read(run):
    recs = run.launches.get("ipm_kkt_ms")
    p = run.profile
    if not recs or not p or not p.steps:
        return None
    ms = sum(r.span_ms().get(name, 0.0) for r in recs
             for name in ("ipm.kkt_factor", "ipm.kkt_solve"))
    return ms / p.steps if ms else None
