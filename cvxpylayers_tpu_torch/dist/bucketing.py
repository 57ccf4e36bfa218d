"""Heterogeneous problem bucketing: one shared solver per
(device, cone pattern, n, settings) bucket.

Counterpart of cvxpylayers_tpu/dist/bucketing.py. A workload mixing
problem structures would naively build one solver per layer. Here
instances are grouped by the *solver-relevant* structure — the cone
dims, variable count, solver settings and the static P flags — so that
every instance in a bucket runs through ONE shared batched solve, no
matter which layer (i.e. which parameter-affine maps) it came from.
Layers only contribute their cheap per-layer assembly (parameter vector
-> dense (P, q, A, b)) and recovery; the solver is built once per
structure and cached process-wide.

Unlike the reference's key, the bucket key also carries the layer's
`device`: tensors on two devices cannot share a bucket.

Every bucket solves on the dense assembly with the per-instance
`make_diff_solver`, as the reference does, so a polyhedral bucket runs
the fused ADMM epoch (kernel K1) on the card. This holds for layers with
constant P and A too (`sparsemax`, `relu`), whose direct call takes the
shared route: the two agree within the solver's tolerance, not bit for
bit.

Padding: each bucket's batch is padded up to `pad_multiple` (e.g. the
mesh size) by repeating the last instance, and padded rows are dropped
before results are returned.

Differentiability: everything here is plain torch (the only custom
autograd rule is inside the shared solver), so `.backward()` through
`solve_bucketed` reaches every item's parameters.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..diff.derivative import make_diff_solver
from ..layer.cvxpylayer import CvxpyLayer, _settings_from_args
from ..parallel.mesh import _solve_rows
from ..solver.settings import SolverSettings

# process-wide solver cache: one entry per bucket structure (the solver
# takes its device from its inputs)
_EXEC_CACHE: Dict[Tuple, object] = {}


def _shared_core(dims, n, settings: SolverSettings, p_diag_full=True,
                 p_diag_only=False, p_zero=False):
    key = (dims, n, settings, p_diag_full, p_diag_only, p_zero)
    if key not in _EXEC_CACHE:
        _EXEC_CACHE[key] = make_diff_solver(dims, n, settings,
                                            p_diag_full=p_diag_full,
                                            p_diag_only=p_diag_only,
                                            p_zero=p_zero)
    return _EXEC_CACHE[key]


def structure_key(layer: CvxpyLayer, settings: SolverSettings):
    """The bucket key: the layer's device, then everything the solve
    specializes on (incl. the static P-diagonal flags that pick the f32
    KKT route — p_diag_only additionally selects the elementwise
    P-inverse fast path, and p_zero gates the pdhg/hsde routes, so layers
    differing in them must not share a solver). As in the reference,
    key[-2] is p_diag_only and key[-1] is p_zero."""
    return (layer.device, layer.prog.dims, layer.prog.n, settings,
            layer._p_diag_full, layer._p_diag_only,
            layer.prog.P_rows.size == 0)


def _assemble_batch(layer: CvxpyLayer, params):
    """(B, n, n), (B, n), (B, m, n), (B, m) assembled problem data for
    one item (B = 1 for unbatched items), plus the item's batch info."""
    batch, flags = layer._parse_batch(params)
    p_ext = layer._stack_params(params, batch, flags)
    P, q, A, b, _ = layer._assemble(p_ext)
    return P, q, A, b, batch


def _solve_bucket(key, data, Bp: int, warm, mesh, axis_name: str):
    """One bucket's solve: its items' assembled (P, q, A, b), stacked and
    padded to Bp rows by repeating the last real instance (a feasible
    dummy, so the padded solve behaves identically), started from `warm`
    (x, y, s) when that has Bp rows and cold otherwise, split over the
    mesh's ranks. Returns (x, y, s, status, iters) of all Bp rows."""
    _, dims, n, settings, p_diag_full, p_diag_only, p_zero = key
    m = dims.total
    P, q, A, b = (torch.cat([d[k] for d in data]) for k in range(4))
    reps = Bp - q.shape[0]
    if reps:
        P, q, A, b = (torch.cat([a, a[-1:].expand(reps, *a.shape[1:])])
                      for a in (P, q, A, b))
    init = (q.new_zeros(Bp, n), q.new_zeros(Bp, m), q.new_zeros(Bp, m))
    if warm is not None and tuple(warm[0].shape) == (Bp, n):
        init = tuple(w.to(q.dtype) for w in warm)
    solver = _shared_core(dims, n, settings, p_diag_full, p_diag_only,
                          p_zero)
    return _solve_rows(solver, mesh, axis_name, (P, q, A, b, *init))


def _recover_items(entries, x, y):
    """Per-item outputs from a bucket's iterates, in entry order,
    dropping the padded rows; an unbatched item loses its batch axis."""
    off = 0
    for layer, batch in entries:
        Bi = batch or 1
        outs = layer._recover(x[off:off + Bi], y[off:off + Bi])
        if batch is None:
            outs = tuple(o[0] for o in outs)
        yield outs
        off += Bi


def bucket_plan(items: Sequence[Tuple[CvxpyLayer, tuple]],
                solver_args: Optional[dict] = None,
                pad_multiple: int = 1):
    """Diagnostics: bucket keys -> (instance count, padded size)."""
    plan = {}
    for layer, params in items:
        settings = _settings_from_args(layer._base_settings, solver_args)
        key = structure_key(layer, settings)
        batch, _ = layer._parse_batch(params)
        plan[key] = plan.get(key, 0) + (batch or 1)
    return {
        k: (c, -(-c // pad_multiple) * pad_multiple)
        for k, c in plan.items()
    }


def solve_bucketed(items: Sequence[Tuple[CvxpyLayer, tuple]],
                   solver_args: Optional[dict] = None,
                   mesh: Optional[DeviceMesh] = None,
                   axis_name: str = "data",
                   pad_multiple: Optional[int] = None,
                   warm_start: Optional[dict] = None,
                   return_state: bool = False):
    """Solve a heterogeneous list of (layer, params) items.

    Each item is one layer plus its parameter tensors (unbatched, or
    batched with a leading dim). Instances are grouped into buckets by
    `structure_key`, solved with one shared solver per bucket (batch
    padded to `pad_multiple`, default the mesh size), and returned as a
    list of per-item output tuples in input order, with each item's own
    batchedness preserved. With a `mesh` of several ranks, every rank
    passes the same items, solves its own rows of each bucket, and gets
    every item's full outputs (parallel/mesh.py).

    Warm starts: pass `return_state=True` to also receive a per-bucket
    state dict of detached (x, y, s) tensors, and feed it back via
    `warm_start=` on the next call with the same bucket structure;
    mismatched buckets fall back to cold starts.
    """
    if pad_multiple is None:
        pad_multiple = mesh.size() if mesh is not None else 1

    # ---- group items by bucket key, assembling each item's data
    buckets: Dict[Tuple, List] = {}
    for idx, (layer, params) in enumerate(items):
        settings = _settings_from_args(layer._base_settings, solver_args)
        key = structure_key(layer, settings)
        P, q, A, b, batch = _assemble_batch(layer, params)
        buckets.setdefault(key, []).append((idx, layer, batch, P, q, A, b))

    results: List[Optional[tuple]] = [None] * len(items)
    states: Dict[Tuple, tuple] = {}
    for key, entries in buckets.items():
        B = sum(e[4].shape[0] for e in entries)
        Bp = -(-B // pad_multiple) * pad_multiple
        warm = warm_start.get(key) if warm_start is not None else None
        x, y, s, status, iters = _solve_bucket(
            key, [e[3:] for e in entries], Bp, warm, mesh, axis_name)
        if return_state:
            states[key] = (x.detach(), y.detach(), s.detach())
        # scatter back per item, dropping padding
        recovered = _recover_items([(e[1], e[2]) for e in entries], x, y)
        for e, outs in zip(entries, recovered):
            results[e[0]] = outs
    if return_state:
        return results, states
    return results
