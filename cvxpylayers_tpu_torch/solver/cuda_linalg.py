"""Batched Householder QR R factor: kernel K2 and its wrapper.

K2 replaces the TPU kernel cvxpylayers_tpu/solver/pallas_linalg.py
(`_qr_kernel`, launched by `qr_r_pallas`). `qr_r(M)` returns the upper
(B, n, n) R factors of a batch of (m, n) matrices. On a CUDA tensor it
launches the hand-written kernel in csrc/house_qr.cu; on a CPU tensor it
runs `batched_linalg.house_qr_r_plain`, the same recurrence in batched
torch ops. The only caller is the interior-point solver's f32 condensed
KKT factor (solver/ipm.py), which uses R through R'R = M'M.

What bounds K2: one read of M and one write of R. At the IPM main shape
(B=1024, m=170, n=50, f32) that is 45 MB, 0.01345 ms at 3.35 TB/s; the
0.78 GFLOP of FMA take 0.0117 ms. The kernel is far from that bound:
each instance is a chain of n dependent column steps. Its third version
(see the source note) gives each trailing column to a warp with lanes
over rows, so the dot product is a warp sum and u and the column stay in
registers between the dot and the update; it takes one block barrier per
step by summing the next column's norm inside the update (look-ahead),
applies the reflector as I - beta u u' straight from the tile (no stored
v, no division per element), keeps every loop bound uniform over the
block so the shuffles need no collective fix-up, and runs as many
threads per instance as `launch_plan` picks for the shape: one warp for
a small tile such as the simplex layer's (40, 20). At the main shape
registers hold it to four blocks per SM, so B = 1024 runs in two waves;
PERF.md records what each costs.

The tests hold the plain version and the kernel's recurrence against the
reference's Householder functions, and `launch_plan` over the shapes the
kernel sees; chip_smoke.py holds the kernel against the plain version on
the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..cuda_build import load
from .batched_linalg import house_qr_r_plain

#: launches of the CUDA kernel since import (plain-version calls excluded)
LAUNCHES = 0

# layout of csrc/house_qr.cu: kHeader words (the look-ahead norm), then the
# tile with an odd row stride
_HEADER_WORDS = 8

_LIB = None


def _library() -> ctypes.CDLL:
    """csrc/house_qr.cu, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = load("house_qr")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.house_qr_r_f32, lib.house_qr_r_f64):
            fn.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
            fn.restype = i32
        lib.house_qr_smem_optin.argtypes = [i32]
        lib.house_qr_smem_optin.restype = i32
        _LIB = lib
    return _LIB


class QrPlan(NamedTuple):
    """How K2 is launched for one shape."""

    threads: int      # threads per instance (one block each)
    smem_bytes: int   # dynamic shared memory per block
    in_shared: bool   # tile in shared memory, else on a device-memory copy


def threads_per_instance(m: int, n: int) -> int:
    """Threads per instance by the size of the tile: one warp for the
    simplex layer's (40, 20), four for the box-QP layer's (170, 50), as
    bench_k2.py's sweep on the card found best."""
    size = m * n
    if size <= 1024:
        return 32
    if size <= 4096:
        return 64
    if size <= 16384:
        return 128
    return 256


def launch_plan(m: int, n: int, elem_bytes: int, optin_bytes: int,
                threads: Optional[int] = None) -> QrPlan:
    """K2's launch for an (m, n) matrix of `elem_bytes` words on a card
    whose blocks may opt into `optin_bytes` of shared memory: the tile
    goes to shared memory when it fits there with the header, else
    to a device-memory copy with only the header in shared memory.
    `threads` overrides `threads_per_instance` (bench_k2.py sweeps it)."""
    if threads is None:
        threads = threads_per_instance(m, n)
    header = elem_bytes * _HEADER_WORDS
    tile = elem_bytes * m * (n | 1)
    if header + tile <= optin_bytes:
        return QrPlan(threads, header + tile, True)
    if header > optin_bytes:
        raise ValueError(
            f"qr_r: the shared header of an ({m}, {n}) matrix does not fit "
            "in one block's shared memory"
        )
    return QrPlan(threads, header, False)


def qr_plan(m: int, n: int, dtype: torch.dtype,
            device: torch.device) -> QrPlan:
    """`launch_plan` for this shape and type on `device`."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return _device_plan(m, n, dtype, index)


@functools.lru_cache(maxsize=None)
def _device_plan(m: int, n: int, dtype: torch.dtype, index: int) -> QrPlan:
    optin = _library().house_qr_smem_optin(index)
    if optin < 0:
        raise RuntimeError(f"house_qr_smem_optin: cudaError {-1 - optin}")
    elem = torch.empty((), dtype=dtype).element_size()
    return launch_plan(m, n, elem, optin)


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
    plan = qr_plan(m, n, M.dtype, M.device)
    work = torch.empty(0 if plan.in_shared else B * m * n, dtype=M.dtype,
                       device=M.device)
    fn = lib.house_qr_r_f32 if M.dtype == torch.float32 else lib.house_qr_r_f64
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(M.data_ptr(), R.data_ptr(), work.data_ptr(), B, m, n,
                 plan.threads, plan.smem_bytes, int(plan.in_shared), stream)
    if err != 0:
        raise RuntimeError(f"house_qr_r launch failed: cudaError {err}")
    LAUNCHES += 1
    return R
