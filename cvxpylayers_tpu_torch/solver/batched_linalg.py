"""Batched small dense factorizations in plain torch ops.

Counterpart of cvxpylayers_tpu/solver/batched_linalg.py, as far as the
port needs it: the Householder R factor that the interior-point solver's
f32 condensed KKT factor takes (solver/ipm.py), and the size gate that
goes with it; and the masked Cholesky, triangular inverse and SPD
inverse that Anderson acceleration's small (L, L) Gram solve takes
(solver/admm.py). `house_qr_r_plain` is the plain version of kernel K2
(solver/cuda_linalg.py). The masked SPD inverse is the one piece of the
reference's hand-rolled factorizations that a path needs: its pivot is
clamped, sqrt(max(d, 1e-30)), so an all-zero history gives a finite
inverse where `torch.linalg.cholesky_ex` would report a failure. The
other Cholesky factors and triangular solves the reference hand-rolls
for its backend are `torch.linalg` calls here.

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


def chol_masked(A: torch.Tensor) -> torch.Tensor:
    """Right-looking Cholesky of a batch of SPD (L, L) matrices -> lower
    factors, (B, L, L) -> (B, L, L). The reference's recurrence, one
    masked rank-1 update a column: the pivot is sqrt(max(d, 1e-30)), so a
    zero or negative pivot gives a zero column, never NaN.

    The update A - u u' is rounded once, as the reference's compiler
    fuses it into one multiply-add: an f32 factor forms it in f64 (the
    product of two f32 numbers is exact there). A near-singular Gram's
    last pivot is a cancellation at the rounding floor, and a second
    rounding turns it negative far more often (the clamp then gives a
    ~1e30 inverse and, in f32, overflow)."""
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    wide = torch.float64
    A = A.clone()
    for j in range(n):
        d = torch.sqrt(torch.clamp_min(A[:, j, j], _TINY))
        col = torch.where(idx >= j, A[:, :, j] / d[:, None], 0.0)
        u = torch.where(idx > j, col, 0.0).to(wide)
        A = (A.to(wide) - u[:, :, None] * u[:, None, :]).to(col.dtype)
        A[:, :, j] = col
    return torch.tril(A)


def tri_inv_masked(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverses of a batch of lower-triangular (L, L) matrices by
    masked forward substitution on the identity, row by row:
    X[j, :] = (e_j - L[j, :j] X[:j, :]) / L[j, j], with a diagonal below
    1e-30 in magnitude read as 1e-30."""
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    dinv = 1.0 / torch.where(d.abs() > _TINY, d, _TINY)
    X = torch.zeros_like(L)
    for j in range(n):
        lrow = torch.where(idx < j, L[:, j, :], 0.0)
        lx = torch.bmm(lrow.unsqueeze(1), X).squeeze(1)
        X[:, j, :] = ((idx == j).to(L.dtype) - lx) * dinv[:, j:j + 1]
    return X


def spd_inv_via_chol(A: torch.Tensor) -> torch.Tensor:
    """Inverses of a batch of SPD (L, L) matrices: A^{-1} = Li' Li with
    Li the inverse of the masked Cholesky factor."""
    with full_f32():
        Li = tri_inv_masked(chol_masked(A))
        return torch.bmm(Li.mT, Li)
