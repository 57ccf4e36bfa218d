"""Euclidean projections onto the supported cones, on batched tensors.

Counterpart of cvxpylayers_tpu/cones/projections.py. Every function takes
and returns tensors with a leading batch axis: v is (B, m). This slice
carries the polyhedral blocks (zero and nonneg); the SOC, exponential,
PSD and power blocks arrive with the general-cone later port slice and
raise until then.

Layout convention for the product cone (matches ConeDims):
  [zero | nonneg | soc blocks | exp triples | psd svec blocks | pow triples]
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .dims import ConeDims


def project_zero(v: torch.Tensor) -> torch.Tensor:
    """Projection onto {0}. (Dual variable of equalities is free.)"""
    return torch.zeros_like(v)


def project_nonneg(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(v, 0.0)


def require_polyhedral(dims: ConeDims, what: str) -> None:
    """Raise for cone families this slice does not carry yet."""
    if not dims.is_polyhedral():
        raise NotImplementedError(
            f"{what}: SOC, exponential, PSD and power cones arrive with the "
            "general-cone later port slice; this slice carries zero and "
            "nonneg cones only"
        )


def make_cone_projector(
    dims: ConeDims, psd_mode: str = "exact"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build Pi_K for the product cone described by `dims`.

    Returns a function v (B, m) -> Pi_K(v) (B, m). psd_mode is accepted
    for signature parity with the reference; it only matters for PSD
    blocks, which this slice does not carry."""
    del psd_mode
    require_polyhedral(dims, "make_cone_projector")
    n_zero = dims.zero

    def project(v: torch.Tensor) -> torch.Tensor:
        out = project_nonneg(v)
        if n_zero:
            out[..., :n_zero] = 0.0
        return out

    return project


def svec_indices(s: int):
    """Row/col index lists for the scaled lower-triangular vectorization.

    svec ordering is column-major lower triangle: (0,0), (1,0), ..., (s-1,0),
    (1,1), ..."""
    rows = []
    cols = []
    for j in range(s):
        for i in range(j, s):
            rows.append(i)
            cols.append(j)
    return rows, cols


def svec_to_sym(v: torch.Tensor, s: int) -> torch.Tensor:
    """Unpack svec (B, s(s+1)/2), off-diag scaled by sqrt(2), to (B, s, s)."""
    rows, cols = svec_indices(s)
    r = torch.tensor(rows, device=v.device)
    c = torch.tensor(cols, device=v.device)
    scale = torch.where(r == c, 1.0, 1.0 / math.sqrt(2.0)).to(v.dtype)
    M = v.new_zeros(v.shape[0], s, s)
    M[:, r, c] = v * scale
    M[:, c, r] = v * scale
    return M
