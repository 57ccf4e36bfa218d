"""Persistent bucket scheduler: a queue over heterogeneous layer solves
with capacity rounding, so a long-running job (training loop, serving
process) keeps a stable batch shape per bucket and carries warm-start
state across steps.

Counterpart of cvxpylayers_tpu/dist/scheduler.py. `solve_bucketed`
(bucketing.py) groups one call's items into structure buckets; the
scheduler adds the process-level policy on top:

  * capacity classes — each bucket's padded batch is rounded up to
    pad_multiple * 2^k and kept at its high-water mark, so every later
    step whose batch fits solves at the same shape (at most log2(B_max)
    capacities per bucket, one in steady state). `compiles` counts the
    times a bucket's capacity class grew, the reference's recompiles;
  * warm-start carry — each bucket's (x, y, s) state persists across
    flushes and is reused whenever the bucket's item composition is
    unchanged (the training-loop case), cutting ADMM iterations;
  * stats — compiles, flushes, occupancy per bucket, for capacity
    tuning and regression tracking.

Differentiable like solve_bucketed: `.backward()` through the results of
`step()` reaches every item's parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..layer.cvxpylayer import CvxpyLayer, _settings_from_args
from .bucketing import (
    _assemble_batch,
    _recover_items,
    _solve_bucket,
    structure_key,
)


def _round_capacity(B: int, pad_multiple: int) -> int:
    """pad_multiple * next_pow2(ceil(B / pad_multiple))."""
    units = -(-B // pad_multiple)
    p = 1
    while p < units:
        p <<= 1
    return pad_multiple * p


@dataclass
class _Ticket:
    """A submitted item; `result` is set by flush()."""

    layer: CvxpyLayer
    params: tuple
    key: tuple
    batch: Optional[int]
    result: Optional[tuple] = None


@dataclass
class _BucketState:
    capacity: int = 0
    signature: tuple = ()
    warm: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    compiles: int = 0
    flushes: int = 0
    solved_rows: int = 0
    padded_rows: int = 0
    last_iters: Optional[torch.Tensor] = None


class BucketScheduler:
    def __init__(
        self,
        mesh: Optional[DeviceMesh] = None,
        axis_name: str = "data",
        solver_args: Optional[dict] = None,
        pad_multiple: Optional[int] = None,
        warm_start: bool = True,
    ):
        self.mesh = mesh
        self.axis_name = axis_name
        self.solver_args = solver_args
        if pad_multiple is None:
            pad_multiple = mesh.size() if mesh is not None else 1
        self.pad_multiple = int(pad_multiple)
        self.warm_start = bool(warm_start)
        self._queue: List[_Ticket] = []
        self._buckets: Dict[tuple, _BucketState] = {}

    # ------------------------------------------------------------- queueing

    def submit(self, layer: CvxpyLayer, params: tuple) -> _Ticket:
        """Enqueue one item (a layer plus its parameter tensors, batched
        or not); returns a ticket whose .result is filled by flush()."""
        settings = _settings_from_args(layer._base_settings, self.solver_args)
        key = structure_key(layer, settings)
        batch, _ = layer._parse_batch(params)
        t = _Ticket(layer, params, key, batch)
        self._queue.append(t)
        return t

    def step(self, items: Sequence[Tuple[CvxpyLayer, tuple]]) -> List[tuple]:
        """submit() all items, flush(), and return results in order —
        the drop-in persistent replacement for solve_bucketed."""
        tickets = [self.submit(layer, params) for layer, params in items]
        self.flush()
        return [t.result for t in tickets]

    # -------------------------------------------------------------- solving

    def flush(self) -> None:
        """Solve everything queued, bucket by bucket, and fulfill the
        tickets. Padded batch per bucket = its capacity class."""
        by_key: Dict[tuple, List[_Ticket]] = {}
        for t in self._queue:
            by_key.setdefault(t.key, []).append(t)
        self._queue = []

        for key, tickets in by_key.items():
            st = self._buckets.setdefault(key, _BucketState())
            assembled = [
                _assemble_batch(t.layer, t.params) for t in tickets
            ]
            B = sum(a[1].shape[0] for a in assembled)
            cap = _round_capacity(B, self.pad_multiple)
            if cap > st.capacity:
                st.capacity = cap
                st.compiles += 1  # a new capacity class
            cap = st.capacity  # high-water mark: stable shape when B dips

            signature = tuple(
                (id(t.layer), t.batch or 1) for t in tickets
            )
            warm = (st.warm if self.warm_start and st.signature == signature
                    else None)
            x, y, s, status, iters = _solve_bucket(
                key, [a[:4] for a in assembled], cap, warm, self.mesh,
                self.axis_name)
            if self.warm_start:
                st.warm = (x.detach(), y.detach(), s.detach())
                st.signature = signature
            st.flushes += 1
            st.solved_rows += B
            st.padded_rows += cap - B
            st.last_iters = iters

            recovered = _recover_items(
                [(t.layer, t.batch) for t in tickets], x, y)
            for t, outs in zip(tickets, recovered):
                t.result = outs

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[tuple, dict]:
        """Per-bucket counters: capacity, compiles, flushes, occupancy."""
        out = {}
        for key, st in self._buckets.items():
            total = st.solved_rows + st.padded_rows
            out[key] = {
                "capacity": st.capacity,
                "compiles": st.compiles,
                "flushes": st.flushes,
                "occupancy": (st.solved_rows / total) if total else 1.0,
            }
        return out
