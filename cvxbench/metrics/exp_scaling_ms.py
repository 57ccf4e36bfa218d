"""exp_scaling_ms: milliseconds per profiled step inside the program's
`ipm.scaling` span (the IPM's block scaling `build_T`: in the LML cell
the barrier Hessians of 200 exponential cones and their eigh, every
iteration). Timed by CUDA events on the program's stream, under the
profiler, by the recording that ipm_trips' reader opens (its own
here); a program without those spans reads nothing."""

from cvxbench.spec import metric_module


def recording(record: list):
    return metric_module("ipm_trips").recording(record)


def read(run):
    recs = run.launches.get("exp_scaling_ms")
    p = run.profile
    if not recs or not p or not p.steps:
        return None
    ms = sum(r.span_ms().get("ipm.scaling", 0.0) for r in recs)
    return ms / p.steps if ms else None
