"""Batched small dense factorizations in plain torch ops.

Counterpart of cvxpylayers_tpu/solver/batched_linalg.py, as far as the
port needs it: the Householder R factor that the interior-point solver's
f32 condensed KKT factor takes (solver/ipm.py), and the size gate that
goes with it. `house_qr_r_plain` is the plain version of kernel K2
(solver/cuda_linalg.py); the Cholesky factors and triangular solves the
reference hand-rolls for its backend are `torch.linalg` calls here.

Convention. The reference holds two Householder forms that agree to
rounding except on a degenerate column: `batched_linalg.house_qr_r`
normalizes u and applies I - 2uu', the Pallas kernel
(`pallas_linalg._qr_kernel`) uses the LAPACK form v = u/u_j,
tau = 2u_j^2/|u|^2 and leaves a column with |x|^2 <= 1e-30 alone
(tau = 0, the diagonal keeps x_j). K2 and this plain version follow the
Pallas kernel's form, the kernel they replace. Row signs of R are not
LAPACK's; every caller uses R only through R'R = M'M.
"""

from __future__ import annotations

import torch

from ..utils.precision import full_f32

_TINY = 1e-30

# Size gate of the reference: up to this dimension its per-column
# Householder loop serves the IPM's condensed factor; above it
# ipm_kkt="auto"/"chol" takes the Jacobi-scaled Cholesky of M'M instead.
MASKED_MAX_DIM = 160


def use_masked(*dims) -> bool:
    """True when the per-column Householder route serves these (static)
    dimensions."""
    return max(dims) <= MASKED_MAX_DIM


def house_qr_r_plain(M: torch.Tensor) -> torch.Tensor:
    """R factors of the QR of a batch of (m, n) matrices, m >= n:
    (B, m, n) -> upper (B, n, n). Householder, no pivoting; one pass per
    column over whole batched tensors."""
    _, m, n = M.shape
    S = M.clone()
    with full_f32():
        for j in range(n):
            x = S[:, j:, j]
            xj = x[:, 0]
            nx2 = (x * x).sum(dim=-1)
            nx = torch.sqrt(torch.clamp_min(nx2, _TINY))
            alpha = torch.where(xj < 0, nx, -nx)
            # u = x - alpha e_j; LAPACK form v = u / u_j
            uj = xj - alpha
            u = torch.cat([uj[:, None], x[:, 1:]], dim=1)
            safe_uj = torch.where(uj.abs() > _TINY, uj, _TINY)
            uu = (u * u).sum(dim=-1)
            tau = 2.0 * safe_uj * safe_uj / torch.clamp_min(uu, _TINY)
            degen = nx2 <= _TINY
            v = torch.where(degen[:, None], 0.0, u / safe_uj[:, None])
            tau = torch.where(degen, 0.0, tau)
            if j + 1 < n:
                # H = I - tau v v' on the trailing block (rows >= j,
                # columns > j)
                trail = S[:, j:, j + 1:]
                w = tau[:, None] * torch.bmm(v.unsqueeze(1), trail).squeeze(1)
                S[:, j:, j + 1:] = trail - v[:, :, None] * w[:, None, :]
            # pin column j: alpha on the diagonal (x_j on a degenerate
            # column), zeros below
            S[:, j, j] = torch.where(degen, xj, alpha)
            S[:, j + 1:, j] = 0.0
    return torch.triu(S[:, :n, :n])
