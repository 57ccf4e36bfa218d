"""Arithmetic shared by the plain references: the working precision.

A reference runs in "float64" to judge the program, and in a lower
precision as the control that the judgement has to fail: "float32" and
"tf32". In "tf32" every product goes through `mm`, which rounds both
factors to TF32's 10-bit mantissa (round to nearest, ties to even)
before a float32 product with float32 sums, as the tensor cores do when
`torch.backends.cuda.matmul.allow_tf32` is set. The rounding is done
here rather than left to that flag, because cuBLAS may take a product
of a matrix and a vector without the tensor cores, and then the flag
changes nothing. Plain torch, importing nothing of the program.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "float32", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (1 sign, 8 exponent, 10 mantissa
    bits), stored as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """torch.matmul(a, b) in the working precision."""
    if precision == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def mv(a: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Batched matrix-vector product a @ x over the leading axis."""
    return mm(a, x.unsqueeze(-1), precision).squeeze(-1)


def tolerance(precision: str) -> float:
    """Relative accuracy a reference solve stops at and certifies: near
    float64's rounding, near float32's, or about two units of TF32's
    (2^-11): residuals computed from TF32-rounded products cannot fall
    much below that, so a lower target would certify no lane that
    the precision itself solved."""
    return {"float64": 1e-10, "float32": 1e-6, "tf32": 1e-3}[precision]
