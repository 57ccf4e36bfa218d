"""Two-phase fallback solve: a fast route for the batch, an accurate route
for the few lanes the fast route failed.

Counterpart of cvxpylayers_tpu/layer/rescue.py::solve_with_rescue, with the
same signature, errors and return. One fast solve runs on the whole batch;
then each stage of `rescue_args` ranks the lanes (MAX_ITERS above any other
failure, solved lanes last), gathers the first `capacity` of them into a
sub-batch, solves it with the stage's settings and writes back only the
lanes that had failed. Failures beyond `capacity` keep their fast-route
status, so the returned statuses stay honest.

Where the reference is traced (top_k, lax.cond, .at[].set), this runs
eagerly on torch tensors:
  * the ranking is a stable descending sort, so equal scores keep the
    lower index first, as jax.lax.top_k does (torch.topk promises no
    order among ties);
  * a stage runs only when a lane failed: one host read of `bad.any()`
    per stage; a skipped stage leaves outputs, statuses and iterations
    as they were;
  * the combine is out of place (index_copy of a where), so autograd
    sends each lane's cotangent to the solve that produced its output,
    through that solve's own implicit adjoint.

The sub-batch solves pass their warm start explicitly and never touch the
layer's eager warm-start cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..solver.settings import MAX_ITERS, SOLVED
from .cvxpylayer import WarmStart


def solve_with_rescue(layer, *params, rescue_args,
                      solver_args: Optional[dict] = None,
                      capacity: int = 64,
                      warm_start_rescue: bool = False):
    """Solve a batch with `solver_args` (fast route), then re-solve up to
    `capacity` failed lanes with `rescue_args` (accurate route).

    ``rescue_args`` may be a single dict or a list of dicts, a rescue
    ladder: stage k re-solves only the lanes every earlier stage left
    unsolved. Each stage costs one solve of a ``min(capacity, B)``-lane
    sub-batch, and only when some lane failed; idle lanes of the sub-batch
    re-solve an already solved instance and are masked out of the
    combine.

    Returns ``(outs, status, iters)`` like ``CvxpyLayer.solve_with_info``:
    rescued lanes carry the rescue solve's status and the sum of both
    iteration counts, lanes beyond capacity keep the fast route's.

    ``warm_start_rescue=True`` starts every stage from the fast route's
    (x, y, s) at its lanes: useful when the fast route merely ran out of
    iterations, counterproductive when it converged to the wrong active
    set (the default keeps the rescue solves cold).
    """
    batch, flags = layer._parse_batch(params)
    if batch is None:
        # _parse_batch returns a batch iff at least one parameter is
        # batched, so this one check covers the unbatched call too
        raise ValueError(
            "solve_with_rescue needs a batched call (the rescue subset "
            "is gathered along the batch axis)"
        )
    cap = int(min(capacity, batch))
    if cap <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    stages = (list(rescue_args) if isinstance(rescue_args, (list, tuple))
              else [rescue_args])
    if not stages:
        raise ValueError("rescue_args must name at least one stage")

    outs, ws, status, iters = layer.solve_and_state(
        *params, solver_args=solver_args
    )

    for stage_args in stages:
        bad = status != SOLVED
        if not bool(bad.any()):
            continue
        # MAX_ITERS lanes (the fast route merely did not finish) rank
        # above infeasible verdicts (which the accurate route would only
        # re-confirm); solved lanes pad the sub-batch
        score = ((status == MAX_ITERS).to(torch.int32) * 2
                 + bad.to(torch.int32))
        idx = torch.sort(score, descending=True, stable=True).indices[:cap]
        mask = bad[idx]

        sub_params = tuple(p[idx] if f else p for p, f in zip(params, flags))
        warm = (WarmStart(x=ws.x[idx], y=ws.y[idx], s=ws.s[idx])
                if warm_start_rescue else False)
        r_outs, r_status, r_iters = layer.solve_with_info(
            *sub_params, solver_args=stage_args, warm_start=warm
        )

        def combine(o, ro, idx=idx, mask=mask):
            m = mask.reshape((cap,) + (1,) * (ro.ndim - 1))
            return o.index_copy(0, idx, torch.where(m, ro, o[idx]))

        outs = tuple(combine(o, ro) for o, ro in zip(outs, r_outs))
        status = status.index_copy(
            0, idx, torch.where(mask, r_status, status[idx]))
        iters = iters.index_copy(
            0, idx, torch.where(mask, iters[idx] + r_iters, iters[idx]))
    return outs, status, iters
