"""bwd_ms: the mean of the benchmark's synchronised span around
`backward()` of the step's loss (the implicit adjoint), over the traced
run's unprofiled steps."""

import statistics


def read(run):
    xs = run.spans.get("bwd")
    return statistics.fmean(xs) * 1e3 if xs else None
