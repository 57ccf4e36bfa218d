"""device_idle_pct: 100 (1 - b / w), b the device's busy time per step
in the profiled steps (the union of its operations' intervals) and w the
wall time per step of the traced run's unprofiled steps. The profiler
slows the host several times over, so its own window says nothing of the
idle share; device times repeat within about 1 % from step to step."""

import statistics


def read(run):
    p = run.profile
    if not p or not p.steps or not run.step_seconds or p.busy_s <= 0:
        return None
    busy = p.busy_s / p.steps
    wall = statistics.fmean(run.step_seconds)
    return 100.0 * (1.0 - busy / wall)
