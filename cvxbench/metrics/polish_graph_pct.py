"""polish_graph_pct: the share of the program's Newton polish calls that
replayed a captured CUDA graph in the profiled steps, 100 x replays /
calls. Read from the program's counters `polish_calls` and
`polish_graph_replays` (`cvxpylayers_tpu_torch.solver.refine`,
`GraphedPolish`) through the recording that ipm_trips' reader opens (its
own here); a program without those counters reads nothing."""

from cvxbench.spec import metric_module


def recording(record: list):
    return metric_module("ipm_trips").recording(record)


def read(run):
    recs = run.launches.get("polish_graph_pct")
    if not recs:
        return None
    calls = sum(r.counts.get("polish_calls", 0) for r in recs)
    if not calls:
        return None
    replays = sum(r.counts.get("polish_graph_replays", 0) for r in recs)
    return 100.0 * replays / calls
