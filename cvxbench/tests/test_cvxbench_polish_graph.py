"""polish_graph_pct's reader: 100 x the program's `polish_graph_replays`
over its `polish_calls` in the recordings of the profiled steps, and
nothing where the program counted no polish call."""

from types import SimpleNamespace

import pytest

from cvxbench.spec import metric_module


def _run(counts, steps=4):
    """A run whose profiled steps recorded `counts` (one recording per
    entry; None: the hook recorded nothing)."""
    recs = (None if counts is None
            else [SimpleNamespace(counts=c) for c in counts])
    launches = {} if recs is None else {"polish_graph_pct": recs}
    return SimpleNamespace(launches=launches,
                           profile=SimpleNamespace(steps=steps))


@pytest.mark.parametrize("counts", [None, [], [{}], [{"ipm_trips": 15}]])
def test_reads_nothing_without_polish_calls(counts):
    assert metric_module("polish_graph_pct").read(_run(counts)) is None


def test_reads_zero_when_no_call_replayed():
    run = _run([{"polish_calls": 8}])
    assert metric_module("polish_graph_pct").read(run) == 0.0


def test_reads_a_hundred_when_every_call_replayed():
    run = _run([{"polish_calls": 8, "polish_graph_replays": 8}])
    assert metric_module("polish_graph_pct").read(run) == 100.0


def test_reads_the_share_over_its_recordings():
    run = _run([{"polish_calls": 3, "polish_graph_replays": 1},
                {"polish_calls": 1, "polish_graph_replays": 1}])
    assert metric_module("polish_graph_pct").read(run) == 50.0


def test_counts_what_the_program_counts_inside_its_recording():
    """The hook opens the program's recording: a polish call of the
    program on the CPU (no graph there) counts one call and no replay."""
    import torch

    from cvxpylayers_tpu_torch.cones.dims import ConeDims
    from cvxpylayers_tpu_torch.solver.refine import make_refiner

    B, n, m = 2, 3, 3
    polish = make_refiner(ConeDims(nonneg=m), n, 2)
    record = []
    with metric_module("polish_graph_pct").recording(record):
        polish(torch.zeros(B, n), torch.zeros(B, m), torch.ones(B, m),
               torch.eye(n).expand(B, n, n), torch.ones(B, n),
               -torch.eye(m, n).expand(B, m, n), torch.zeros(B, m))
    run = SimpleNamespace(launches={"polish_graph_pct": record},
                          profile=SimpleNamespace(steps=1))
    assert record[0].counts == {"polish_calls": 1}
    assert metric_module("polish_graph_pct").read(run) == 0.0
