"""Observability: phase timers, problem summaries, profiler annotations.

Counterpart of cvxpylayers_tpu/utils/profiling.py, on torch: a phase
waits for the card's work on the tensors it is given before its clock
stops, and an annotation is a `torch.profiler.record_function` range
(plus an NVTX range where CUDA is present), so it shows by name in a
`torch.profiler` trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

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
