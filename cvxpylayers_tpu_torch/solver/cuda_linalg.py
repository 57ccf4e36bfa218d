"""Batched Householder QR R factor: kernel K2 and its wrapper.

Counterpart of cvxpylayers_tpu/solver/pallas_linalg.py::qr_r_pallas.
`qr_r(M)` returns the upper (B, n, n) R factors of a batch of (m, n)
matrices. On a CUDA tensor it launches the hand-written kernel in
csrc/house_qr.cu (one thread block per instance, the tile staged in
shared memory, see the source note); on a CPU tensor it runs
`batched_linalg.house_qr_r_plain`, the same recurrence in batched torch
ops. The tests hold the plain version against both of the reference's
Householder functions, and chip_smoke.py holds the kernel against the
plain version on the card. The only caller is the interior-point
solver's f32 condensed KKT factor (solver/ipm.py), which uses R through
R'R = M'M.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..cuda_build import load
from .batched_linalg import house_qr_r_plain

#: launches of the CUDA kernel since import (plain-version calls excluded)
LAUNCHES = 0

_LIB = None


def _library() -> ctypes.CDLL:
    """csrc/house_qr.cu, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = load("house_qr")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.house_qr_r_f32, lib.house_qr_r_f64):
            fn.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
            fn.restype = i32
        lib.house_qr_r_plan.argtypes = [
            i32, i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)
        ]
        lib.house_qr_r_plan.restype = i32
        _LIB = lib
    return _LIB


def qr_plan(m: int, n: int, dtype: torch.dtype,
            device: torch.device) -> Tuple[bool, int]:
    """(in_shared, smem_bytes): whether K2 stages the (m, n) tile in shared
    memory for this shape on `device`, and the bytes it asks for; when the
    tile does not fit it works on a device-memory copy and asks only for
    its work vectors."""
    lib = _library()
    smem = ctypes.c_longlong(0)
    elem = torch.empty((), dtype=dtype).element_size()
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    code = lib.house_qr_r_plan(m, n, elem, index, ctypes.byref(smem))
    if code == -1:
        raise ValueError(
            f"qr_r: the work vectors of an ({m}, {n}) matrix do not fit in "
            "one block's shared memory"
        )
    if code < 0:
        raise RuntimeError(f"house_qr_r_plan: cudaError {-2 - code}")
    return bool(code), int(smem.value)


def _check(M: torch.Tensor) -> None:
    if M.dim() != 3:
        raise ValueError(f"M must be (B, m, n), got {tuple(M.shape)}")
    _, m, n = M.shape
    if m < n:
        raise ValueError(f"qr_r needs m >= n, got m={m}, n={n}")
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"qr_r takes float32 or float64, got {M.dtype}")
    if not M.is_contiguous():
        raise ValueError("M must be contiguous")
    if m * n >= 2 ** 31:
        raise ValueError("M must hold fewer than 2^31 entries per instance")


def qr_r(M: torch.Tensor) -> torch.Tensor:
    """Upper R factors of the Householder QR (no pivoting) of a batch of
    (m, n) matrices, m >= n: (B, m, n) -> (B, n, n).

    A CUDA tensor launches kernel K2; a CPU tensor runs the plain
    version."""
    global LAUNCHES
    _check(M)
    if M.device.type == "cpu":
        return house_qr_r_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"qr_r runs on cuda or cpu tensors, got {M.device}")
    B, m, n = M.shape
    R = torch.empty(B, n, n, dtype=M.dtype, device=M.device)
    if B == 0 or n == 0:
        return R
    lib = _library()
    in_shared, _ = qr_plan(m, n, M.dtype, M.device)
    work = torch.empty(0 if in_shared else B * m * n, dtype=M.dtype,
                       device=M.device)
    fn = lib.house_qr_r_f32 if M.dtype == torch.float32 else lib.house_qr_r_f64
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(M.data_ptr(), R.data_ptr(), work.data_ptr(), B, m, n,
                 int(in_shared), stream)
    if err != 0:
        raise RuntimeError(f"house_qr_r launch failed: cudaError {err}")
    LAUNCHES += 1
    return R
