"""Operations and bytes of the program's hand-written kernels, worked out
from their shapes, and the peaks they are divided by (copied from
chip_smoke.py's `epoch_bound_ms` and `qr_bound_ms`).

A kernel's roofline share is the least time the card could take for the
work, the larger of operations over the peak rate and bytes over the
memory rate, divided by the kernel's measured time. Each input byte is
counted read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12   # float32 on the CUDA cores (no tensor cores)
PEAK_F64_FLOPS = 34e12   # float64 on the CUDA cores
PEAK_BYTES = 3.35e12     # HBM3

# the kernels' symbols in the device trace (csrc/admm_epoch.cu and
# csrc/house_qr.cu)
K1_SYMBOLS = ("admm_epoch_reg_kernel", "admm_polyhedral_epoch_kernel")
K2_SYMBOLS = ("house_qr_r_kernel",)


def _bound(ops, nbytes, elem_bytes):
    peak = PEAK_F32_FLOPS if elem_bytes == 4 else PEAK_F64_FLOPS
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def epoch_bound_ms(B, n, m, iters, elem_bytes=4):
    """K1: `iters` ADMM steps on B instances of n variables and m
    constraint rows. (ms, what bounds it)."""
    ops = B * iters * (4 * m * n + 2 * n * n + 11 * m + 6 * n)
    nbytes = elem_bytes * B * (n * n + m * n + 2 * n + 4 * m + n + 2 * m)
    return _bound(ops, nbytes, elem_bytes)


def qr_bound_ms(B, m, n, elem_bytes=4):
    """K2: the R factors of B (m, n) matrices by Householder,
    2mn^2 - (2/3)n^3 operations each; M read once, R written once.
    (ms, what bounds it)."""
    ops = B * (2.0 * m * n * n - 2.0 * n ** 3 / 3.0)
    nbytes = elem_bytes * B * (m * n + n * n)
    return _bound(ops, nbytes, elem_bytes)
