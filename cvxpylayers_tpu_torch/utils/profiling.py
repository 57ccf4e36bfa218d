"""Observability: phase timers, problem summaries, profiler annotations,
and the solver's spans and counters.

Counterpart of cvxpylayers_tpu/utils/profiling.py, on torch: a phase
waits for the card's work on the tensors it is given before its clock
stops, and an annotation is a `torch.profiler.record_function` range
(plus an NVTX range where CUDA is present), so it shows by name in a
`torch.profiler` trace.

The solver marks its parts with `span(name)` (one IPM iteration, the
scaling, the KKT factor and solves, the step-length search, the polish,
the adjoint) and counts with `count(name)` (`ipm_trips`: trips of the
IPM loop, so its slowest lane's iterations; `eigh`: calls of
`torch.linalg.eigh`). Both do nothing, beyond one flag and one check of
the profiler, unless a `recording()` is open or `torch.profiler`
records: then a span is a profiler range named `cvxpylayers.<name>`,
and inside `recording()` its time is kept and the counters count.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Tuple

import torch


def _cuda_devices(tree):
    """The CUDA devices of every tensor in a tensor or a nested
    list/tuple/dict of them."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


class PhaseTimer:
    """Accumulates wall-clock per named phase (canonicalize / solve /
    backward ...). Not thread-safe; one per layer or experiment."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the body. `block_on`: a tensor (or a nested list, tuple or
        dict of tensors); the card of each CUDA tensor among them is
        synchronized before the clock stops, so the phase covers the
        device work it queued and not only its enqueue."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                for dev in _cuda_devices(block_on):
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for k in sorted(self.totals):
            lines.append(
                f"{k}: {self.totals[k]*1e3:.2f} ms over {self.counts[k]} calls"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named region in `torch.profiler` traces, and an NVTX range for
    Nsight where CUDA is present (NVTX raises on a CPU-only build)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


SPAN_PREFIX = "cvxpylayers."


class Recording:
    """The counters and span times of the solver while it is open.

    On a CUDA `device` a span is timed by two CUDA events on the current
    stream, so it covers the device work queued inside it (or, where the
    device waits on the host, the host's time); otherwise by the host
    clock. Read `span_ms()` after the device has finished the work."""

    def __init__(self, device=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.counts: Dict[str, int] = {}
        self.marks: List[Tuple[str, object, object]] = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def span_ms(self) -> Dict[str, float]:
        """Milliseconds inside each span, summed over its openings."""
        out: Dict[str, float] = {}
        for name, t0, t1 in self.marks:
            ms = t0.elapsed_time(t1) if self.cuda else (t1 - t0) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


_recordings: List[Recording] = []
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def recording(device=None):
    """Within the block the solver's counters count and its spans are
    timed (into every recording open at the time); yields the
    Recording."""
    rec = Recording(device)
    _recordings.append(rec)
    try:
        yield rec
    finally:
        _recordings.remove(rec)


def count(name: str):
    """Adds one to the counter `name` of every open recording."""
    for rec in _recordings:
        rec.counts[name] = rec.counts.get(name, 0) + 1


def span(name: str):
    """A context manager around one part of the solver: nothing unless a
    recording is open or torch.profiler records."""
    if not _recordings and not torch.autograd._profiler_enabled():
        return _OFF
    return _open_span(name)


def spanned(name: str):
    """Decorator: every call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def _open_span(name: str):
    recs = list(_recordings)
    with contextlib.ExitStack() as stack:
        if torch.autograd._profiler_enabled():
            stack.enter_context(
                torch.profiler.record_function(SPAN_PREFIX + name))
        starts = [rec.mark() for rec in recs]
        yield
        for rec, t0 in zip(recs, starts):
            rec.marks.append((name, t0, rec.mark()))


def problem_summary(layer) -> dict:
    """Structured description of a compiled layer's cone program."""
    p = layer.prog
    return {
        "n": p.n,
        "m": p.m,
        "n_param": p.n_param,
        "dims": {
            "zero": p.dims.zero,
            "nonneg": p.dims.nonneg,
            "soc": list(p.dims.soc),
            "exp": p.dims.exp,
            "psd": list(p.dims.psd),
            "pow3": list(p.dims.pow3),
        },
        "nnz_A": int(p.A_rows.size),
        "nnz_P": int(p.P_rows.size),
        "nb": int(p.b_rows.size),
        "objective_offset_exact": bool(p.objective_offset_exact),
        "gp": bool(getattr(layer, "gp", False)),
    }
