"""rescue_lanes_per_step: lanes handed to the rescue stage per step (the
fast stage's failures, at most the capacity), from the StageLog that
wraps the layer instance's solve_and_state, over the traced run's
unprofiled steps."""

import statistics


def read(run):
    lanes = run.counters.get("rescue_lanes")
    return statistics.fmean(lanes) if lanes else None
