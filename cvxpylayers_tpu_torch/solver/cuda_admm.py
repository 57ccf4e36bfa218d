"""Fused ADMM inner epoch for polyhedral cones: kernel K1 and its plain
version.

Counterpart of cvxpylayers_tpu/solver/pallas_admm.py::polyhedral_inner_epoch.
`polyhedral_inner_epoch` runs `iters` ADMM steps per instance. On a CUDA
tensor it launches the hand-written kernel in csrc/admm_epoch.cu (one
thread block per instance, A and M^{-1} staged in shared memory, see the
source note); on a CPU tensor it runs `polyhedral_inner_epoch_plain`, the
same loop in batched torch ops. The tests hold the plain version against
the Pallas kernel, and chip_smoke.py holds the kernel against the plain
version on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..cuda_build import load
from ..utils.precision import full_f32

#: launches of the CUDA kernel since import (plain-version calls excluded)
LAUNCHES = 0

_LIB = None


def polyhedral_inner_epoch_plain(minv, A, q, b, rho, x, z, y, *,
                                 n_zero: int, iters: int, sigma: float,
                                 alpha: float):
    """The epoch in batched torch ops: every array leads with the batch
    axis; minv (B, n, n), A (B, m, n), q and x (B, n), b, rho, z and y
    (B, m). Returns (x, z, y) after `iters` steps."""
    m = b.shape[1]
    zero_row = torch.arange(m, device=b.device) < n_zero
    with full_f32():
        for _ in range(iters):
            t = rho * z - y
            rhs = sigma * x - q + torch.bmm(t.unsqueeze(1), A).squeeze(1)
            xt = torch.bmm(minv, rhs.unsqueeze(-1)).squeeze(-1)
            zt = torch.bmm(A, xt.unsqueeze(-1)).squeeze(-1)
            x = alpha * xt + (1 - alpha) * x
            w = alpha * zt + (1 - alpha) * z + y / rho
            z = torch.where(zero_row, b, b - torch.clamp_min(b - w, 0.0))
            y = rho * (w - z)
    return x, z, y


def _library() -> ctypes.CDLL:
    """csrc/admm_epoch.cu, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = load("admm_epoch")
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.admm_polyhedral_epoch_f32,
                   lib.admm_polyhedral_epoch_f64):
            fn.argtypes = [ptr] * 12 + [i32] * 5 + [f64, f64, i32, ptr]
            fn.restype = i32
        lib.admm_polyhedral_epoch_plan.argtypes = [
            i32, i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)
        ]
        lib.admm_polyhedral_epoch_plan.restype = i32
        _LIB = lib
    return _LIB


def epoch_plan(n: int, m: int, dtype: torch.dtype,
               device: torch.device) -> Tuple[bool, int]:
    """(in_shared, smem_bytes): whether K1 stages A and M^{-1} in shared
    memory for this shape on `device`, and the bytes it asks for; when
    they do not fit it takes its device-memory branch (0 bytes)."""
    lib = _library()
    smem = ctypes.c_longlong(0)
    elem = torch.empty((), dtype=dtype).element_size()
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    code = lib.admm_polyhedral_epoch_plan(n, m, elem, index,
                                          ctypes.byref(smem))
    if code < 0:
        raise RuntimeError(
            f"admm_polyhedral_epoch_plan: cudaError {-1 - code}"
        )
    return bool(code), int(smem.value)


def _check(minv, A, q, b, rho, x, z, y, n_zero: int, iters: int):
    if q.dim() != 2 or b.dim() != 2:
        raise ValueError("q must be (B, n) and b (B, m)")
    B, n = q.shape
    m = b.shape[1]
    want = {
        "minv": (minv, (B, n, n)), "A": (A, (B, m, n)), "q": (q, (B, n)),
        "b": (b, (B, m)), "rho": (rho, (B, m)), "x": (x, (B, n)),
        "z": (z, (B, m)), "y": (y, (B, m)),
    }
    if q.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"polyhedral_inner_epoch takes float32 or float64, "
                        f"got {q.dtype}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= n_zero <= m:
        raise ValueError(f"n_zero must lie in [0, {m}], got {n_zero}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if max(m, n) * n >= 2 ** 31:
        raise ValueError("A and M^{-1} must hold fewer than 2^31 entries "
                         "per instance")


def polyhedral_inner_epoch(minv, A, q, b, rho, x, z, y, *, n_zero: int,
                           iters: int, sigma: float, alpha: float):
    """Batched fused inner epoch: all arrays lead with the batch axis.

    A CUDA tensor launches kernel K1; a CPU tensor runs the plain
    version. Returns new (x, z, y) tensors."""
    global LAUNCHES
    _check(minv, A, q, b, rho, x, z, y, n_zero, iters)
    if q.device.type == "cpu":
        return polyhedral_inner_epoch_plain(
            minv, A, q, b, rho, x, z, y, n_zero=n_zero, iters=iters,
            sigma=sigma, alpha=alpha,
        )
    if q.device.type != "cuda":
        raise ValueError(f"polyhedral_inner_epoch runs on cuda or cpu "
                         f"tensors, got {q.device}")
    B, n = q.shape
    m = b.shape[1]
    x_out = torch.empty_like(x)
    z_out = torch.empty_like(z)
    y_out = torch.empty_like(y)
    if B == 0:
        return x_out, z_out, y_out
    lib = _library()
    in_shared, _ = epoch_plan(n, m, q.dtype, q.device)
    work = torch.empty(0 if in_shared else B * (2 * n + m),
                       dtype=q.dtype, device=q.device)
    fn = (lib.admm_polyhedral_epoch_f32 if q.dtype == torch.float32
          else lib.admm_polyhedral_epoch_f64)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(minv.data_ptr(), A.data_ptr(), q.data_ptr(), b.data_ptr(),
                 rho.data_ptr(), x.data_ptr(), z.data_ptr(), y.data_ptr(),
                 x_out.data_ptr(), z_out.data_ptr(), y_out.data_ptr(),
                 work.data_ptr(), B, n, m, n_zero, iters, float(sigma),
                 float(alpha), int(in_shared), stream)
    if err != 0:
        raise RuntimeError(
            f"admm_polyhedral_epoch launch failed: cudaError {err}"
        )
    LAUNCHES += 1
    return x_out, z_out, y_out
