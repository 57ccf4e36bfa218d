"""Matmul precision pinning.

Hopper's tensor cores take float32 matrix products in TF32 when
`torch.backends.cuda.matmul.allow_tf32` is set, keeping about three
decimal digits. The solver's cancellation-critical products (the KKT
residual, the duality-gap xPx, the data assembly, the ADMM factor) need
full float32, whatever the caller's global setting.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Run the block with TF32 matmuls off; restore the old value after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
