"""The traced part of a `--trace 1` run: a few steps under
`torch.profiler`, read from the profiler's raw events.

Device events (kernels, copies and sets, without annotation ranges)
give each operation's time, the device's busy time (the union of their
intervals) and the idle gaps between them. A gap is put down to what the
host was doing when it ended: the benchmark's own span then open
(`cvxbench.<name>`, recorded with `record_function`) and the host
operator that launched the next device operation, found through the
launch's correlation id. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

SPAN_PREFIX = "cvxbench."


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span named `cvxbench.<name>` in the profiler's trace."""
    if not on:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Profile:
    steps: int
    wall_s: float                       # host clock over the traced steps
    busy_s: float                       # union of device intervals
    device_events: int
    by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    gaps: Dict[str, float] = field(default_factory=dict)

    def kernel_stats(self, symbols) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        any of `symbols`."""
        secs, count = 0.0, 0
        for name, (s, n) in self.by_name.items():
            if any(sym in name for sym in symbols):
                secs += s
                count += n
        return secs, count

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name[:120], s] for name, (s, _) in ops],
                "idle_gaps": [[name[:120], s] for name, s in gaps]}


def _innermost(ops, starts, t_ns):
    """The innermost host operator open at t_ns (ops sorted by start)."""
    i = bisect.bisect_right(starts, t_ns) - 1
    for j in range(i, max(-1, i - 200), -1):
        start, end, name = ops[j]
        if end >= t_ns:
            return name
    return None


def profile(step: Callable[[int], None], first: int, steps: int,
            sync: Callable[[], None]) -> Profile:
    """Run `step(first)`, ..., `step(first + steps - 1)` under the
    profiler (host and device activity) and read the result; `sync`
    waits for the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + steps):
            step(i)
        sync()
        wall = time.perf_counter() - t0

    dev: List[Tuple[int, int, str, int]] = []
    launches: Dict[int, int] = {}
    host_ops: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((start, start + dur, e.name(), e.correlation_id()))
            continue
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            spans.append((start, start + dur, name[len(SPAN_PREFIX):]))
        elif name.startswith("cuda") and e.correlation_id():
            launches[e.correlation_id()] = start
        elif not e.is_user_annotation():
            host_ops.append((start, start + dur, name))

    dev.sort()
    host_ops.sort()
    spans.sort()
    op_starts = [o[0] for o in host_ops]
    span_starts = [s[0] for s in spans]
    by_name: Dict[str, Tuple[float, int]] = {}
    gaps: Dict[str, float] = {}
    busy = 0
    cur_start, cur_end = None, None
    for start, end, name, corr in dev:
        s, n = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (end - start) * 1e-9, n + 1)
        if cur_end is None:
            cur_start, cur_end = start, end
            continue
        if start > cur_end:
            busy += cur_end - cur_start
            t_launch = launches.get(corr, start)
            op = _innermost(host_ops, op_starts, t_launch) or "?"
            where = _innermost(spans, span_starts, t_launch) or "outside"
            key = f"{where}/{op}"
            gaps[key] = gaps.get(key, 0.0) + (start - cur_end) * 1e-9
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return Profile(steps=steps, wall_s=wall, busy_s=busy * 1e-9,
                   device_events=len(dev), by_name=by_name, gaps=gaps)
