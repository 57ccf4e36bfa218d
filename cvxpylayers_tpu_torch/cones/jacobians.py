"""Generalized Jacobians D Pi_K(v) of the cone projections, batched.

Counterpart of cvxpylayers_tpu/cones/jacobians.py for the polyhedral
blocks this slice carries:
  zero:   0
  nonneg: diag(v > 0)
The SOC, exponential, PSD and power blocks arrive with the general-cone
later port slice (require_polyhedral raises for them).
"""

from __future__ import annotations

import torch

from .dims import ConeDims
from .projections import require_polyhedral


def _active_mask(dims: ConeDims, w: torch.Tensor) -> torch.Tensor:
    """(B, m) 0/1 diagonal of D Pi_K(w): 0 on zero rows, 1[w > 0] on
    nonneg rows."""
    d = (w > 0).to(w.dtype)
    if dims.zero:
        d[..., :dims.zero] = 0.0
    return d


def make_cone_dproj_factored(dims: ConeDims):
    """(factor, apply) pair for repeated D Pi_K(w) matvecs at FIXED w.

    For polyhedral cones the factored state is the 0/1 diagonal."""
    require_polyhedral(dims, "make_cone_dproj_factored")

    def factor(w: torch.Tensor) -> torch.Tensor:
        return _active_mask(dims, w)

    def apply(state: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return state * v

    return factor, apply


def make_cone_dproj_apply(dims: ConeDims):
    """fn(w, v) -> D Pi_K(w) @ v without materializing the (m, m) matrix."""
    factor, apply = make_cone_dproj_factored(dims)

    def apply_once(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return apply(factor(w), v)

    return apply_once


def make_cone_dproj_dense(dims: ConeDims):
    """fn(v) -> dense (B, m, m) generalized Jacobian of Pi_K at v."""
    require_polyhedral(dims, "make_cone_dproj_dense")

    def dproj(v: torch.Tensor) -> torch.Tensor:
        return torch.diag_embed(_active_mask(dims, v))

    return dproj
