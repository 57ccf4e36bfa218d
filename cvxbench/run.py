"""Run one cell of the benchmark once.

    python3 -m cvxbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's pieces are found by the names in
BENCHMARK.json (see cvxbench/spec.py). The run sets up (imports, the
program's CUDA kernels loaded or built, the layer canonicalised, warm
steps of the cell's own shapes on instances drawn on the card from the
seed), then runs steps for `--seconds` seconds, each ending in
`torch.cuda.synchronize()`. With `--trace 1` the window's steps also
time the forward and the backward apart, and a few more steps run under
the profiler. After the window the kept steps are judged against the
plain reference (cvxbench/check.py).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each compared number with its limit;
the same numbers are the last lines of standard error. Without as many
CUDA devices as the cell asks for, the run prints no result and exits 2;
if JAX or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cvxpylayers_tpu")


def process_age() -> float:
    """Seconds since this process started, from /proc (0 where that is
    not readable)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class SetupClock:
    """Set-up time from the process's start, split into named phases."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.phases = {"process_start": process_age()}

    def mark(self, name: str):
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + now - self.last
        self.last = now

    def total(self) -> float:
        return self.phases["process_start"] + time.perf_counter() - self.t0


class Reservoir:
    """Which steps to keep for the judge: `k` of them, uniformly over
    however many the window runs, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed ^ 0x5EED), 0

    def slot(self) -> Optional[int]:
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            return i
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def run(cell, seed: int, seconds: float, trace: bool, device, clock,
        patch: Optional[Callable] = None):
    """One run of `cell` on `device`: (result fields, checks, judge).
    `patch(workload)`, when given, replaces or wraps the timed path after
    set-up (the control, and the tests' faults)."""
    import contextlib

    import torch

    from cvxbench import trace as tracing
    from cvxbench.check import Judge
    from cvxbench.spec import metric_module
    from cvxbench.traffic.train import sync

    device = torch.device(device)
    clock.mark("import")
    if device.type == "cuda":
        from cvxpylayers_tpu_torch import cuda_build

        for name in cuda_build.KERNEL_SOURCES:
            cuda_build.load(name)
    clock.mark("kernels")
    wl = cell.kind_module().Workload(cell, seed, device, clock)
    if patch is not None:
        patch(wl)
    wl.warm(cell.mix["warm_steps"])
    sync(device)
    clock.mark("warm")
    if getattr(wl, "stage_log", None) is not None:
        wl.stage_log.fast = []
    setup_s = clock.total()

    wl.timing = trace
    keep = Reservoir(cell.mix["kept_steps"], seed)
    kept = [None] * keep.k
    statuses, step_seconds = [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        rec = wl.step(i)
        statuses.append(rec["status"])
        step_seconds.append(rec["seconds"])
        s = keep.slot()
        if s is not None:
            kept[s] = wl.snapshot(rec)
        del rec
        i += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t_start
    wl.timing = False
    counters = wl.counters()

    profile, launches = None, {}
    if trace:
        wl.tracing = True
        with contextlib.ExitStack() as hooks:
            # each per-layer metric that records launches (launches.py)
            for m in cell.per_layer:
                hook = getattr(metric_module(m["name"]), "recording", None)
                if hook is not None:
                    hooks.enter_context(hook(launches.setdefault(m["name"],
                                                                 [])))
            profile = tracing.profile(wl.step, i, cell.mix["profile_steps"],
                                      lambda: sync(device))
        wl.tracing = False
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    lanes = sum(int(s.numel()) for s in statuses)
    solved = sum(int((s == 0).sum()) for s in statuses)

    # the program's state goes before the reference runs
    spans = getattr(wl, "spans", {})
    wl.close()
    del statuses
    if device.type == "cuda":
        torch.cuda.empty_cache()
    judge = Judge(cell)
    for snap in kept:
        if snap is not None:
            wl.judge(judge, snap)
    correct, checks = judge.verdict(cell.limits["limits"])
    sync(device)

    facts = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, step_seconds=step_seconds,
        solved=solved, lanes_timed=lanes, spans=spans, counters=counters,
        profile=profile, launches=launches)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_module(m["name"]).read(facts)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    fields = {"correct": bool(correct), "attempted": lanes,
              "failed": lanes - solved, "metrics": metrics, "device": dev}
    if profile is not None:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.wall_s
        fields["breakdown"] = profile.breakdown()
    fields["steps"] = len(step_seconds)
    if len(step_seconds) >= 2:
        q = statistics.quantiles(step_seconds, n=4, method="inclusive")
        fields["step_ms"] = {"q1": q[0] * 1e3, "median": q[1] * 1e3,
                             "q3": q[2] * 1e3, "max": max(step_seconds) * 1e3}
    fields["setup_phases"] = dict(clock.phases)
    fields["numbers"] = judge.numbers()
    return fields, checks, judge


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m cvxbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(fields: dict, checks: dict):
    """The checks as the last lines of standard error, then the result
    as the last line of standard output, `checks` its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(dict(fields, checks=checks)), flush=True)


def main(argv=None) -> int:
    clock = SetupClock()
    args = parse(argv)
    cache = ROOT / ".cvxbench_cache"
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch

    from cvxbench.spec import load_cell

    cell = load_cell(args.workload)
    import cvxpylayers_tpu_torch

    where = Path(cvxpylayers_tpu_torch.__file__).resolve()
    if not where.is_relative_to(ROOT):
        print(f"cvxbench: the program under test must be this checkout's "
              f"cvxpylayers_tpu_torch, found {where}", file=sys.stderr)
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"cvxbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {have}; it does not run on the CPU",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    fields, checks, _ = run(cell, args.seed, args.seconds,
                            bool(args.trace), "cuda", clock)
    bad = forbidden_modules()
    if bad:
        print(f"cvxbench: modules loaded that the run must not load: {bad}",
              file=sys.stderr)
        return 3
    report(fields, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
