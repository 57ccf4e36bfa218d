"""Fused ADMM inner epoch for polyhedral cones: kernel K1 and its plain
version.

Counterpart of cvxpylayers_tpu/solver/pallas_admm.py::polyhedral_inner_epoch.
`polyhedral_inner_epoch` runs `iters` ADMM steps per instance. On a CUDA
tensor it launches the hand-written kernel in csrc/admm_epoch.cu on the
plan `launch_plan` makes for the shape; on a CPU tensor it runs
`polyhedral_inner_epoch_plain`, the same loop in batched torch ops.

K1's version 2 holds A and M^{-1} in registers for the whole epoch
(the register branch, see the source note): each thread owns a tile of
rows by columns of both, a step moves only the vectors and the partial
sums through shared memory, and small programs pack several instances
into one block. `launch_plan` picks the register tile with the fewest
threads that fits the shape within the register budget; shapes beyond
it keep version 1's layouts, A and M^{-1} in shared memory, or read from
device memory beyond what a block may use. The plan is a pure function
of the shape, the word size and the shared memory a block may opt into,
so the tests check it here. The tests hold the plain version against the
Pallas kernel and a numpy model of the register tile against the
reference; chip_smoke.py holds the kernel against the plain version on
the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple

import torch

from ..cuda_build import load
from ..utils.precision import full_f32

#: launches of the CUDA kernel since import (plain-version calls excluded)
LAUNCHES = 0

_LIB = None


class Tile(NamedTuple):
    """A register tile of csrc/admm_epoch.cu (kTiles, same order)."""

    threads: int  # threads per instance: threads / 8 row groups of 8 lanes
    rows_a: int   # rows of A per row group (V, a power of two)
    rows_m: int   # rows of M^{-1} per row group (VM, a power of two)
    cols: int     # columns per lane: tc, tc + 8, ..., tc + 8 (cols - 1)


TILES = (
    Tile(64, 16, 8, 7),   # box-QP in f32 (n <= 56, m <= 128)
    Tile(128, 8, 4, 7),   # box-QP in f64: the same shapes, half the rows
    Tile(32, 8, 8, 3),    # simplex (n <= 24, m <= 32)
    Tile(8, 8, 8, 1),     # LAD (n <= 8, m <= 8)
)
#: operator registers (32-bit words) a thread may hold in the register
#: branch: tile 0 in f64 (336) would spill, so it takes tile 1
REGISTER_BUDGET = 168
#: small tiles pack instances into blocks of this many threads
BLOCK_THREADS = 128
_BRANCH_CODE = {"device": 0, "shared": 1, "register": 2}
_VEC_SLOTS_N, _VEC_SLOTS_M = 4, 5  # version 1's vectors in shared memory


class EpochPlan(NamedTuple):
    """How K1 is launched for one shape. The launch passes the branch and
    the tile; the source derives the rest, and threads, instances and
    smem_bytes state what it derives (chip_smoke.py holds them against
    the source's admm_epoch_geometry on the card)."""

    branch: str       # "register", "shared" or "device"
    threads: int      # threads per instance
    instances: int    # instances per block
    tile: int         # index into TILES (register branch), else -1
    smem_bytes: int   # dynamic shared memory per block


def tile_fits(tile: Tile, n: int, m: int) -> bool:
    """Whether a tile's row groups and columns cover an (m, n) A and an
    (n, n) M^{-1}."""
    groups = tile.threads // 8
    return (n <= 8 * tile.cols and m <= groups * tile.rows_a
            and n <= groups * tile.rows_m)


def tile_registers(tile: Tile, elem_bytes: int) -> int:
    """32-bit registers a thread holds for its tiles of A and M^{-1}."""
    return (tile.rows_a + tile.rows_m) * tile.cols * elem_bytes // 4


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def register_shared_bytes(tile: Tile, elem_bytes: int) -> int:
    """Dynamic shared memory of one block of the register branch: per
    instance t, xt, sigma x - q twice and a partial of A't per warp, each
    padded to 16 bytes (csrc/admm_epoch.cu RegLayout)."""
    vec = 16 // elem_bytes
    groups = tile.threads // 8
    per_warp = min(groups, 4)
    col = 8 * _round_up(tile.cols, vec)
    size = (_round_up(groups * tile.rows_a, vec)
            + (3 + groups // per_warp) * col)
    return elem_bytes * size * instances_per_block(tile.threads)


def instances_per_block(threads: int) -> int:
    return max(1, BLOCK_THREADS // threads)


def shared_bytes(n: int, m: int, elem_bytes: int) -> int:
    """Version 1's shared layout: the vectors, then A and M^{-1} with an
    odd row stride."""
    ld = n | 1
    return elem_bytes * (_VEC_SLOTS_N * n + _VEC_SLOTS_M * m
                         + (m + n) * ld)


def _v1_threads(n: int, m: int) -> int:
    return 128 if max(n, m) <= 128 else 256


def plan_candidates(n: int, m: int, elem_bytes: int,
                    optin_bytes: int) -> List[EpochPlan]:
    """Every plan that can run this shape: each register tile that fits
    it (whatever its registers), then version 1's shared or device-memory
    layout. bench_k1.py times them all."""
    plans = []
    for i, tile in enumerate(TILES):
        if tile_fits(tile, n, m):
            plans.append(EpochPlan(
                "register", tile.threads, instances_per_block(tile.threads),
                i, register_shared_bytes(tile, elem_bytes)))
    need = shared_bytes(n, m, elem_bytes)
    if need <= optin_bytes:
        plans.append(EpochPlan("shared", _v1_threads(n, m), 1, -1, need))
    plans.append(EpochPlan("device", _v1_threads(n, m), 1, -1, 0))
    return plans


def launch_plan(n: int, m: int, elem_bytes: int,
                optin_bytes: int) -> EpochPlan:
    """K1's launch for an (m, n) A of `elem_bytes` words on a card whose
    blocks may opt into `optin_bytes` of shared memory: the register tile
    with the fewest threads that fits the shape and holds its operators
    within REGISTER_BUDGET registers a thread; else A and M^{-1} in
    shared memory when they fit there; else read from device memory."""
    plans = plan_candidates(n, m, elem_bytes, optin_bytes)
    reg = [p for p in plans if p.branch == "register"
           and tile_registers(TILES[p.tile], elem_bytes) <= REGISTER_BUDGET]
    if reg:
        return min(reg, key=lambda p: p.threads)
    return next(p for p in plans if p.branch != "register")


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
        _LIB = bind(load("admm_epoch"))
    return _LIB


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a library built from csrc/admm_epoch.cu."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.admm_polyhedral_epoch_f32, lib.admm_polyhedral_epoch_f64):
        fn.argtypes = [ptr] * 12 + [i32] * 5 + [f64, f64, i32, i32, ptr]
        fn.restype = i32
    lib.admm_epoch_smem_optin.argtypes = [i32]
    lib.admm_epoch_smem_optin.restype = i32
    lib.admm_epoch_geometry.argtypes = [i32] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.admm_epoch_geometry.restype = i32
    return lib


def epoch_plan(n: int, m: int, dtype: torch.dtype,
               device: torch.device) -> EpochPlan:
    """`launch_plan` for this shape and type on `device`."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return _device_plan(n, m, dtype, index)


@functools.lru_cache(maxsize=None)
def _device_plan(n: int, m: int, dtype: torch.dtype,
                 index: int) -> EpochPlan:
    optin = _library().admm_epoch_smem_optin(index)
    if optin < 0:
        raise RuntimeError(f"admm_epoch_smem_optin: cudaError {-1 - optin}")
    elem = torch.empty((), dtype=dtype).element_size()
    return launch_plan(n, m, elem, optin)


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
    plan = epoch_plan(q.shape[1], b.shape[1], q.dtype, q.device)
    out = launch(_library(), plan, minv, A, q, b, rho, x, z, y,
                 n_zero=n_zero, iters=iters, sigma=sigma, alpha=alpha)
    if q.shape[0]:
        LAUNCHES += 1
    return out


def launch(lib: ctypes.CDLL, plan: EpochPlan, minv, A, q, b, rho, x, z, y,
           *, n_zero: int, iters: int, sigma: float, alpha: float):
    """One launch of K1 from `lib` on `plan` (checked arrays on the card;
    bench_k1.py calls it with plans of its own). The source derives the
    launch from the plan's branch and tile alone. Returns (x, z, y)."""
    B, n = q.shape
    m = b.shape[1]
    x_out = torch.empty_like(x)
    z_out = torch.empty_like(z)
    y_out = torch.empty_like(y)
    if B == 0:
        return x_out, z_out, y_out
    work = torch.empty(B * (2 * n + m) if plan.branch == "device" else 0,
                       dtype=q.dtype, device=q.device)
    fn = (lib.admm_polyhedral_epoch_f32 if q.dtype == torch.float32
          else lib.admm_polyhedral_epoch_f64)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(minv.data_ptr(), A.data_ptr(), q.data_ptr(), b.data_ptr(),
                 rho.data_ptr(), x.data_ptr(), z.data_ptr(), y.data_ptr(),
                 x_out.data_ptr(), z_out.data_ptr(), y_out.data_ptr(),
                 work.data_ptr(), B, n, m, n_zero, iters, float(sigma),
                 float(alpha), _BRANCH_CODE[plan.branch], plan.tile, stream)
    if err != 0:
        raise RuntimeError(
            f"admm_polyhedral_epoch launch failed: cudaError {err}"
        )
    return x_out, z_out, y_out
