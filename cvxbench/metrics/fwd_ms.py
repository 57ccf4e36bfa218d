"""fwd_ms: the mean of the benchmark's synchronised span around the
layer's forward call (solve_with_info or solve_with_rescue), over the
traced run's unprofiled steps."""

import statistics


def read(run):
    xs = run.spans.get("fwd")
    return statistics.fmean(xs) * 1e3 if xs else None
