"""Kernel K2 (batched Householder R factor), version 3, on the CPU.

The CUDA kernel (cvxpylayers_tpu_torch/csrc/house_qr.cu) runs only on the
card, where chip_smoke.py holds it against its plain version. Here:

(a) its recurrence, written out by hand in numpy with the kernel's own
    split of the work (a warp per trailing column, lanes over rows, rows
    beyond the registers in a second pass, the look-ahead norm), is held
    against the reference's Householder function
    (cvxpylayers_tpu/solver/batched_linalg.py::house_qr_r, through
    jax.jit(jax.vmap), f64) and against the port's plain version, through
    R'R and |diag R|, since row signs are a convention;
(b) the wrapper's launch plan (threads per instance, shared bytes, tile in
    shared or device memory) as a pure function of the shape, the word
    size and the shared memory a block may opt into.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvxpylayers_tpu.solver.batched_linalg import house_qr_r as jax_house_qr_r
from cvxpylayers_tpu_torch.solver import cuda_linalg
from cvxpylayers_tpu_torch.solver.batched_linalg import house_qr_r_plain

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_TINY = 1e-30
_OPTIN_H100 = 232448  # shared memory one block may opt into on an H100


def _max_nan(a, lo):
    return a if (a > lo or a != a) else lo


def _warp_columns(warp, warps, cols):
    """The trailing columns (0 = column j + 1) of one warp in one step:
    groups of three, base + warp + q * warps for base = 0, 3 warps, ...,
    the same loop bounds for every warp, no division."""
    return [base + warp + q * warps for base in range(0, cols, 3 * warps)
            for q in range(3) if base + warp + q * warps < cols]


def _k2_by_hand(M, threads, rows_per_lane):
    """Version 3's recurrence for one (m, n) matrix, lane by lane. Lane l
    of a warp holds rows j + l + 32k (k < rows_per_lane) of u and of the
    column in registers, rows beyond those in a second pass; w_c = u'S_c
    is a warp sum and S_c += (-beta w_c) u, with beta = 2 / |u|^2 and
    u_j = x_j - alpha. Warp 0 holds column j + 1 and sums its new squares
    below row j + 1 (the next step's norm). A degenerate column gets
    beta = 0 and keeps x_j; the diagonal is written one step late."""
    dt = M.dtype.type
    m, n = M.shape
    S = M.copy()
    tiny = dt(_TINY)
    warps = threads // 32
    tail2 = np.sum(S[1:, 0] ** 2)
    diag = dt(0)
    for j in range(n):
        xj = S[j, j]
        nx2 = dt(xj * xj + tail2)
        degen = bool(nx2 <= tiny)
        nx = np.sqrt(_max_nan(nx2, tiny))
        alpha = nx if xj < 0 else -nx
        uj = dt(xj - alpha)
        beta = dt(0) if degen else dt(2) / _max_nan(dt(uj * uj + tail2), tiny)
        if j > 0:
            S[j - 1, j - 1] = diag
        diag = xj if degen else alpha
        if j + 1 == n:
            break
        rows = np.arange(j, min(m, j + 32 * rows_per_lane))
        extra = np.arange(j + 32 * rows_per_lane, m)
        u = S[rows, j].copy()
        u[0] = uj
        for warp in range(warps):
            for i in _warp_columns(warp, warps, n - j - 1):
                c = j + 1 + i
                w = -beta * (u @ S[rows, c] + S[extra, j] @ S[extra, c])
                S[rows, c] += w * u
                S[extra, c] += w * S[extra, j]
        tail2 = np.sum(S[j + 2:, j + 1] ** 2)
    S[n - 1, n - 1] = diag
    return np.triu(S[:n, :n])


def _matrix(shape, seed, zero_col=None):
    M = np.random.default_rng(seed).standard_normal(shape)
    if zero_col is not None:
        M[:, zero_col] = 0.0
    return M


def _jax_r(Ms):
    return np.asarray(jax.jit(jax.vmap(jax_house_qr_r))(jnp.asarray(Ms)))


def _assert_same_factor(R, R_ref, M, rtol):
    G = M.T @ M
    scale = np.abs(G).max()
    np.testing.assert_allclose(R.T @ R, R_ref.T @ R_ref, rtol=0,
                               atol=rtol * scale)
    np.testing.assert_allclose(np.abs(np.diag(R)), np.abs(np.diag(R_ref)),
                               rtol=0, atol=rtol * np.sqrt(scale))


@pytest.mark.parametrize("shape,threads,rows_per_lane,zero_col", [
    ((6, 6), 32, 1, None),
    ((9, 1), 32, 1, None),
    ((40, 20), 128, 2, None),
    ((170, 50), 128, 6, None),
    ((100, 40), 64, 2, None),
    ((12, 5), 64, 1, 0),
    ((12, 5), 256, 1, 2),
], ids=["square", "one-column", "simplex-40x20", "box-qp-170x50",
        "rows-beyond-the-registers", "zero-first-column",
        "zero-until-its-own-step"])
def test_recurrence_by_hand_matches_reference_and_plain(shape, threads,
                                                        rows_per_lane,
                                                        zero_col):
    # a zero column stays exactly zero under the earlier reflectors, so it
    # is degenerate at its own step, whether that is the first or a later
    M = _matrix(shape, seed=sum(shape), zero_col=zero_col)
    R = _k2_by_hand(M, threads, rows_per_lane)
    R_jax = _jax_r(M[None])[0]
    R_plain = house_qr_r_plain(torch.as_tensor(M[None]))[0].numpy()
    _assert_same_factor(R, R_jax, M, 1e-12)
    _assert_same_factor(R, R_plain, M, 1e-12)
    if zero_col is not None:
        # the degenerate rule: beta = 0, the diagonal keeps x_j = 0
        assert (R[:zero_col + 1, zero_col] == 0.0).all()
        assert R_plain[zero_col, zero_col] == 0.0


def test_recurrence_by_hand_keeps_nan():
    # a NaN entry reaches its column at step 0 and every later column at
    # its own step, as in the plain version: a failed factor upstream must
    # reach the interior-point step acceptance as NaN
    M = _matrix((10, 5), seed=3)
    M[6, 2] = np.nan
    with np.errstate(invalid="ignore"):
        R = _k2_by_hand(M, 32, 1)
    R_plain = house_qr_r_plain(torch.as_tensor(M[None]))[0].numpy()
    np.testing.assert_array_equal(np.isnan(R), np.isnan(R_plain))
    assert np.isnan(R[2:, 2:][np.triu_indices(3)]).all()
    assert np.isfinite(R[:2, :2]).all()
    R_jax = _jax_r(M[None])[0]
    assert np.isnan(R_jax[2:, 2:][np.triu_indices(3)]).all()


def test_every_trailing_column_goes_to_one_warp():
    # the kernel's split of a step's trailing columns over its warps
    for warps in (1, 2, 4, 8):
        for cols in range(1, 257):
            got = sorted(i for w in range(warps)
                         for i in _warp_columns(w, warps, cols))
            assert got == list(range(cols))
            assert 0 in _warp_columns(0, warps, cols)  # column j + 1


def _plan_by_hand(m, n, elem, threads, optin):
    header = elem * 8  # the look-ahead norm, padded to 8 words
    tile = elem * m * (n | 1)
    if header + tile <= optin:
        return threads, header + tile, True
    return threads, header, False


@pytest.mark.parametrize("m,n,elem,want", [
    (170, 50, 4, (128, 34712, True)),
    (170, 50, 8, (128, 69424, True)),
    (40, 20, 4, (32, 3392, True)),
    (40, 20, 8, (32, 6784, True)),
    (560, 160, 4, (256, 32, False)),
], ids=["box-qp-f32", "box-qp-f64", "simplex-f32", "simplex-f64",
        "beyond-shared-memory-f32"])
def test_launch_plan_at_chip_smoke_shapes(m, n, elem, want):
    plan = cuda_linalg.launch_plan(m, n, elem, _OPTIN_H100)
    assert tuple(plan) == want
    assert tuple(plan) == _plan_by_hand(m, n, elem, want[0], _OPTIN_H100)
    assert isinstance(plan, cuda_linalg.QrPlan)


def test_launch_plan_at_the_shared_memory_edge():
    # n = 160, f32: 32 bytes of header and 644 bytes per row of the tile
    fits = cuda_linalg.launch_plan(360, 160, 4, _OPTIN_H100)
    assert fits == (256, 32 + 360 * 644, True)
    beyond = cuda_linalg.launch_plan(361, 160, 4, _OPTIN_H100)
    assert beyond == (256, 32, False)
    exact = cuda_linalg.launch_plan(170, 50, 4, 34712)
    assert exact.in_shared
    assert not cuda_linalg.launch_plan(170, 50, 4, 34711).in_shared
    with pytest.raises(ValueError, match="header"):
        cuda_linalg.launch_plan(170, 50, 4, 31)
    forced = cuda_linalg.launch_plan(170, 50, 4, _OPTIN_H100, threads=32)
    assert forced == (32, 34712, True)


def test_threads_per_instance_by_tile_size():
    cases = {(32, 32): 32, (41, 25): 64, (64, 64): 64, (4097, 1): 128,
             (128, 128): 128, (16385, 1): 256, (170, 50): 128, (40, 20): 32}
    for (m, n), want in cases.items():
        assert cuda_linalg.threads_per_instance(m, n) == want, (m, n)
