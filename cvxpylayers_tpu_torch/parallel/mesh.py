"""Batch sharding of layer solves over torch.distributed ranks.

Counterpart of cvxpylayers_tpu/parallel/mesh.py. In torch each rank is
one device, and a mesh is a `DeviceMesh` over ranks: `make_data_mesh`
gives a 1-D mesh named "data" over the whole world, and `batch_sharding`
/ `replicated` are the `[Shard(0)]` / `[Replicate()]` placements that
stand for the reference's `P("data")` / `P()`.

Each instance's solve is embarrassingly parallel, so a sharded call
needs one collective only: every rank holds the full batch of
parameters, solves its own contiguous rows, and the outputs of all ranks
are gathered so that the call returns the full batch on every rank. The
gather's backward hands each rank the incoming gradient of its own rows
as it is, unreduced: every rank computes the same loss from the gathered
outputs, so a parameter's gradient on a rank is nonzero on that rank's
rows only, and summed over the ranks it equals the single-process
gradient. (An autograd all-gather whose backward sums the incoming
gradients over the ranks would make it W times too large.) A world of
one rank is a plain call.

A mesh needs an initialized process group: call
`cvxpylayers_tpu_torch.dist.initialize(...)` first.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call "
            "cvxpylayers_tpu_torch.dist.initialize(...) first"
        )


def make_data_mesh(device_type: Optional[str] = None,
                   axis_name: str = "data") -> DeviceMesh:
    """1-D mesh named `axis_name` over every rank of the world, on the
    card ("cuda") unless `device_type="cpu"` is asked for."""
    _require_group()
    return init_device_mesh(device_type or "cuda",
                            (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def batch_sharding(mesh: DeviceMesh, axis_name: str = "data") -> list:
    """Shard the leading (batch) dimension over the mesh's `axis_name`
    dimension (replicated over any other)."""
    return [Shard(0) if name == axis_name else Replicate()
            for name in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh) -> list:
    return [Replicate()] * mesh.ndim


def _axis(mesh: DeviceMesh, axis_name: str):
    """(process group, size, this rank's index) of one mesh dimension."""
    dim = mesh.mesh_dim_names.index(axis_name)
    return (mesh.get_group(axis_name), mesh.size(dim),
            mesh.get_local_rank(axis_name))


class _GatherRows(torch.autograd.Function):
    """All-gather of equal row blocks along dim 0. Backward: this rank's
    rows of the incoming gradient, unreduced (see the module docstring)."""

    @staticmethod
    def forward(ctx, local, group, rank, world):
        rows = local.shape[0]
        ctx.rows = (rank * rows, (rank + 1) * rows)
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None, None, None


def _split(mesh: Optional[DeviceMesh], axis_name: str, B: int):
    """(group, rank, world, rows a rank) of a batch of B split over the
    mesh's `axis_name` ranks, or None for a plain call (no mesh, or a
    mesh of one rank). The batch must divide evenly."""
    if mesh is None:
        return None
    group, world, rank = _axis(mesh, axis_name)
    if world == 1:
        return None
    if B % world:
        raise ValueError(
            f"batch {B} is not a multiple of the mesh size {world}; "
            "pad it with pad_batch"
        )
    return group, rank, world, B // world


def _solve_rows(solve, mesh: Optional[DeviceMesh], axis_name: str, data):
    """`solve(*data)` with every tensor of `data` batched along dim 0: each
    rank of the mesh's `axis_name` dimension solves its own rows, and every
    output comes back gathered over the ranks."""
    split = _split(mesh, axis_name, data[0].shape[0])
    if split is None:
        return solve(*data)
    group, rank, world, b = split
    outs = solve(*(t[rank * b:(rank + 1) * b] for t in data))
    return tuple(_GatherRows.apply(o, group, rank, world) for o in outs)


def _solve_with_info(layer, mesh: Optional[DeviceMesh], axis_name: str,
                     params, kw):
    """`layer.solve_with_info(*params, **kw)` split over the ranks of the
    mesh's `axis_name` dimension: (outs, status, iters) of the full
    batch on every rank. Never raises on solver failure."""
    batch, flags = layer._parse_batch(params)
    split = None if batch is None else _split(mesh, axis_name, batch)
    if split is None:
        return layer.solve_with_info(*params, **kw)
    group, rank, world, b = split
    local = tuple(p[rank * b:(rank + 1) * b] if is_b else p
                  for p, is_b in zip(params, flags))
    outs, status, iters = layer.solve_with_info(*local, **kw)
    outs = tuple(_GatherRows.apply(o, group, rank, world) for o in outs)
    return (outs, _GatherRows.apply(status, group, rank, world),
            _GatherRows.apply(iters, group, rank, world))


def shard_layer_call(layer, mesh: DeviceMesh, axis_name: str = "data"):
    """Wrap `layer` so that a batched call is split over the ranks of the
    mesh: each rank solves its own rows and the call returns the full
    batch's outputs on every rank (module docstring). Every rank must
    make the same call with the same full-batch parameters; an
    unbatched call is a plain call on every rank. A failure on any rank
    raises SolverError on every rank, after the gather.

    Batch sizes must be divisible by the mesh size; use `pad_batch` if
    not."""
    _axis(mesh, axis_name)  # a mesh without this dimension fails here

    def call(*params, **kw):
        outs, status, _ = _solve_with_info(layer, mesh, axis_name, params,
                                           kw)
        layer._maybe_raise(status)
        return outs

    return call


def pad_batch(arrs, multiple: int):
    """Pad the leading dim of each tensor up to a multiple (repeat-edge
    padding keeps the padded instances feasible), returning (padded, B)."""
    B = arrs[0].shape[0]
    Bp = ((B + multiple - 1) // multiple) * multiple
    if Bp == B:
        return arrs, B
    out = []
    for a in arrs:
        pad = a[-1:].expand(Bp - B, *a.shape[1:])
        out.append(torch.cat([a, pad], dim=0))
    return tuple(out), B
