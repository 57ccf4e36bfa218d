"""Distributed runtime and bucketed scheduling of batched layer solves.

Counterpart of cvxpylayers_tpu/dist, on torch.distributed:

  runtime.py   — process-group initialization (NCCL on the card, gloo on
                 the CPU), global/host meshes, per-rank batch helpers
  bucketing.py — heterogeneous problem bucketing: instances are grouped
                 by (device, cone pattern, n, solver settings) and each
                 bucket runs ONE shared solver, with feasible
                 repeat-edge padding up to the mesh multiple
  harness.py   — scaling measurement harness: one process on the card,
                 or P hosts x D ranks with gloo on the CPU of one
                 machine
  scheduler.py — persistent bucket scheduler: queue + capacity-class
                 rounding (pad_multiple * 2^k, high-water mark) +
                 cross-step warm-start carry + occupancy stats
"""

from .runtime import (  # noqa: F401
    global_batch,
    host_local_results,
    initialize,
    make_global_mesh,
    make_host_mesh,
)
from .bucketing import bucket_plan, solve_bucketed  # noqa: F401
from .scheduler import BucketScheduler  # noqa: F401
