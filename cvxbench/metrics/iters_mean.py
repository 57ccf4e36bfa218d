"""iters_mean: the mean over lanes and steps of the `iters` that the
forward entry returns (after a rescue, a rescued lane's counts summed),
over the traced run's unprofiled steps."""


def read(run):
    iters = run.counters.get("iters")
    if not iters:
        return None
    total = sum(int(t.sum()) for t in iters)
    lanes = sum(int(t.numel()) for t in iters)
    return total / lanes if lanes else None
