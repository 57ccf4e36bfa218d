"""ipm_trips: trips of the program's IPM loop per profiled step. The loop
runs until its slowest lane stops, so this is that lane's iterations,
which `iters_mean` (a mean over lanes) cannot show. Read from the
program's own counter (`cvxpylayers_tpu_torch.utils.profiling`,
`ipm_trips`) through a recording opened around the profiled steps; a
program without that registry records nothing and the metric reads
nothing."""

import contextlib


@contextlib.contextmanager
def recording(record: list):
    """Within the block the program's counters and spans record into one
    Recording, appended to `record` at the end; nothing where the
    program has no such registry. The span metrics open theirs here."""
    import torch

    from cvxpylayers_tpu_torch.utils import profiling

    opener = getattr(profiling, "recording", None)
    if opener is None:
        yield
        return
    with opener("cuda" if torch.cuda.is_available() else None) as rec:
        yield
    record.append(rec)


def read(run):
    recs = run.launches.get("ipm_trips")
    p = run.profile
    if not recs or not p or not p.steps:
        return None
    trips = sum(r.counts.get("ipm_trips", 0) for r in recs)
    return trips / p.steps if trips else None
