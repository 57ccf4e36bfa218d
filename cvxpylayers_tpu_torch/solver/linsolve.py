"""Batched conjugate-gradient solves for the KKT systems.

Counterpart of cvxpylayers_tpu/solver/linsolve.py (`_cg_normal`,
`_cg_spd_from`, `_cg_spd`, `_cg_spd_warm`). Vectors are (B, d); every
step size and guard is per lane, so one lane's breakdown never touches
another lane.
"""

from __future__ import annotations

import torch


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(dim=-1)


def _cg_normal(matvec, matvec_T, rhs, iters: int):
    """CG on (A'A) x = A'rhs, `iters` fixed steps."""
    b = matvec_T(rhs)
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = _dot(r, r)
    for _ in range(iters):
        Ap = matvec_T(matvec(p))
        denom = _dot(p, Ap)
        alpha = rs / torch.where(denom > 0, denom, 1.0)
        alpha = torch.where(denom > 0, alpha, 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = _dot(r, r)
        beta = rs_new / torch.where(rs > 0, rs, 1.0)
        p = r + beta[:, None] * p
        rs = rs_new
    return x


def _cg_spd_from(matvec, x0, r0, iters: int):
    """Shared CG loop for an SPD (or SPSD-with-consistent-rhs) system,
    starting from iterate x0 with residual r0 = rhs - A x0."""
    x = x0
    r = r0
    p = r0
    rs = _dot(r0, r0)
    for _ in range(iters):
        Ap = matvec(p)
        denom = _dot(p, Ap)
        alpha = torch.where(
            denom > 0, rs / torch.where(denom > 0, denom, 1.0), 0.0
        )
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = _dot(r, r)
        beta = rs_new / torch.where(rs > 0, rs, 1.0)
        p = r + beta[:, None] * p
        rs = rs_new
    return x


def _cg_spd(matvec, rhs, iters: int):
    """Plain CG from zero."""
    return _cg_spd_from(matvec, torch.zeros_like(rhs), rhs, iters)


def _cg_spd_warm(matvec, rhs, x0, iters: int):
    """CG warm-started at x0: the matrix-free ADMM x-update, where
    consecutive right-hand sides differ by O(step) and the previous
    solution is an excellent first iterate."""
    return _cg_spd_from(matvec, x0, rhs - matvec(x0), iters)
