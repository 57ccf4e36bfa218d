"""Port kernel K1 (the fused polyhedral ADMM epoch) against the reference.

The reference's Pallas kernel runs in interpreter mode on the CPU (as
tests/test_solver.py runs it); the port's plain version must give the
same (x, z, y). The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py; here a CPU tensor must never launch it.

Without the reference: the plain version against the ADMM recurrences
written out by hand, the plain version of K2 (the Householder R factor)
against LAPACK at the shapes the interior-point path gives it, and the
kernel loader, which raises when there is no CUDA toolkit.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cvxpylayers_tpu.solver.pallas_admm import (
    polyhedral_inner_epoch as jax_epoch,
)
from cvxpylayers_tpu_torch import cuda_build
from cvxpylayers_tpu_torch.solver import cuda_admm, cuda_linalg

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

# The Pallas kernel accumulates its matvecs in f32 whatever the input
# type (preferred_element_type), so against it both types hold to the f32
# bound: 10 steps of three chained matvecs, summed in another order. The
# f64 check at 1e-10 is against the reference's own epoch scan
# (solver/admm.py inner), the same arithmetic up to reassociation.
_ATOL_PALLAS = 1e-5
_ATOL_SCAN_F64 = 1e-10
_ORDER = ("minv", "A", "q", "b", "rho", "x", "z", "y")


def _inputs(B, n, m, dtype, seed):
    r = np.random.default_rng(seed)
    return dict(
        minv=(r.standard_normal((B, n, n)) * 0.05).astype(dtype),
        A=(r.standard_normal((B, m, n)) * 0.1).astype(dtype),
        q=r.standard_normal((B, n)).astype(dtype),
        b=r.standard_normal((B, m)).astype(dtype),
        rho=np.full((B, m), 0.1, dtype) * (1 + r.random((B, m))).astype(dtype),
        x=(r.standard_normal((B, n)) * 0.1).astype(dtype),
        z=(r.standard_normal((B, m)) * 0.1).astype(dtype),
        y=(r.standard_normal((B, m)) * 0.1).astype(dtype),
    )


def _run_pallas_interpret(arrs, **kw):
    orig_call = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig_call(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp_call):
        out = jax_epoch(*(jnp.asarray(arrs[k]) for k in _ORDER), tile=4,
                        **kw)
    return [np.asarray(o) for o in out]


def _run_reference_scan(arrs, *, n_zero, iters, sigma, alpha):
    """The reference ADMM inner step (solver/admm.py `inner`) as a scan."""
    minv, A, q, b, rho, x, z, y = (jnp.asarray(arrs[k]) for k in _ORDER)
    m = b.shape[1]

    def body(c, _):
        x_, z_, y_ = c
        rhs = sigma * x_ - q + jnp.einsum("bmn,bm->bn", A, rho * z_ - y_)
        xt = jnp.einsum("bnk,bk->bn", minv, rhs)
        zt = jnp.einsum("bmn,bn->bm", A, xt)
        xn = alpha * xt + (1 - alpha) * x_
        w = alpha * zt + (1 - alpha) * z_ + y_ / rho
        zn = jnp.where(jnp.arange(m)[None, :] < n_zero, b,
                       b - jnp.maximum(b - w, 0.0))
        return (xn, zn, rho * (w - zn)), None

    out, _ = jax.lax.scan(body, (x, z, y), None, length=iters)
    return [np.asarray(o) for o in out]


def _run_port(arrs, **kw):
    return cuda_admm.polyhedral_inner_epoch(
        *(torch.as_tensor(arrs[k]) for k in _ORDER), **kw
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_zero", [0, 3])
def test_plain_matches_pallas_interpret(dtype, n_zero):
    arrs = _inputs(8, 6, 10, dtype, seed=n_zero)
    kw = dict(n_zero=n_zero, iters=10, sigma=1e-6, alpha=1.6)
    want = _run_pallas_interpret(arrs, **kw)
    before = cuda_admm.LAUNCHES
    got = _run_port(arrs, **kw)
    assert cuda_admm.LAUNCHES == before  # a CPU tensor never launches K1
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w, atol=_ATOL_PALLAS, rtol=0)


@pytest.mark.parametrize("n_zero", [0, 3])
def test_plain_matches_reference_scan_f64(n_zero):
    arrs = _inputs(5, 6, 10, np.float64, seed=10 + n_zero)
    kw = dict(n_zero=n_zero, iters=12, sigma=1e-6, alpha=1.6)
    want = _run_reference_scan(arrs, **kw)
    got = _run_port(arrs, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=_ATOL_SCAN_F64, rtol=0)


def test_wrapper_checks_inputs():
    arrs = {k: torch.as_tensor(v) for k, v in
            _inputs(2, 3, 4, np.float64, seed=1).items()}
    kw = dict(n_zero=0, iters=2, sigma=1e-6, alpha=1.6)
    order = _ORDER
    bad_shape = dict(arrs, rho=arrs["rho"][:, :3])
    with pytest.raises(ValueError, match="rho"):
        cuda_admm.polyhedral_inner_epoch(*(bad_shape[k] for k in order), **kw)
    bad_dtype = dict(arrs, b=arrs["b"].float())
    with pytest.raises(TypeError, match="b is"):
        cuda_admm.polyhedral_inner_epoch(*(bad_dtype[k] for k in order), **kw)
    strided = dict(arrs, A=arrs["A"].transpose(1, 2).contiguous()
                   .transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_admm.polyhedral_inner_epoch(*(strided[k] for k in order), **kw)
    with pytest.raises(ValueError, match="n_zero"):
        cuda_admm.polyhedral_inner_epoch(*(arrs[k] for k in order),
                                         **dict(kw, n_zero=5))


def _epoch_by_hand(arrs, *, n_zero, iters, sigma, alpha):
    """One instance at a time in numpy, straight from the ADMM recurrences."""
    out = [np.empty_like(arrs[k]) for k in ("x", "z", "y")]
    for i in range(arrs["q"].shape[0]):
        minv, A, q, b, rho, x, z, y = (arrs[k][i] for k in _ORDER)
        for _ in range(iters):
            xt = minv @ (sigma * x - q + A.T @ (rho * z - y))
            zt = A @ xt
            x = alpha * xt + (1 - alpha) * x
            w = alpha * zt + (1 - alpha) * z + y / rho
            z = np.where(np.arange(b.size) < n_zero, b, np.minimum(w, b))
            y = rho * (w - z)
        for o, v in zip(out, (x, z, y)):
            o[i] = v
    return out


@pytest.mark.parametrize("n_zero,alpha,iters",
                         [(0, 1.0, 1), (4, 1.6, 3), (2, 1.6, 0)],
                         ids=["one-step-no-relaxation", "all-rows-equality",
                              "zero-steps"])
def test_plain_matches_recurrences_by_hand(n_zero, alpha, iters):
    # m = 4: n_zero = 4 puts every row in the zero cone (z is pinned to b);
    # zero steps hand the state back unchanged
    arrs = _inputs(3, 5, 4, np.float64, seed=20 + n_zero)
    kw = dict(n_zero=n_zero, iters=iters, sigma=1e-6, alpha=alpha)
    want = _epoch_by_hand(arrs, **kw)
    got = _run_port(arrs, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-12, rtol=0)
    if n_zero == 4 and iters:
        np.testing.assert_array_equal(got[1].numpy(), arrs["b"])


@pytest.mark.parametrize("shape,dtype,tol", [
    ((3, 5, 5), np.float64, 1e-13),     # square
    ((5, 4, 1), np.float64, 1e-13),     # one column: R = -sign(x1) |x|
    ((7, 40, 20), np.float32, 1e-5),    # the simplex layer's tile
    ((2, 170, 50), np.float32, 1e-5),   # the box-QP layer's tile
], ids=["square-f64", "one-column-f64", "40x20-f32", "170x50-f32"])
def test_qr_plain_matches_lapack(shape, dtype, tol):
    # K2's plain version against LAPACK through R'R and |diag R| (row signs
    # are a convention), at the shapes the interior-point path gives it
    M = np.random.default_rng(shape[1]).standard_normal(shape).astype(dtype)
    Mt = torch.as_tensor(M)
    before = cuda_linalg.LAUNCHES
    R = cuda_linalg.qr_r(Mt)
    assert cuda_linalg.LAUNCHES == before
    assert R.dtype == Mt.dtype
    assert tuple(R.shape) == (shape[0], shape[2], shape[2])
    assert bool((R == R.triu()).all())
    G = Mt.double().mT @ Mt.double()
    err = (R.double().mT @ R.double() - G).abs().max() / G.abs().max()
    assert float(err) < tol
    lapack = torch.linalg.qr(Mt, mode="r").R
    np.testing.assert_allclose(
        R.diagonal(dim1=1, dim2=2).abs().numpy(),
        lapack.diagonal(dim1=1, dim2=2).abs().numpy(),
        rtol=50 * tol, atol=0)


@pytest.mark.parametrize("name", cuda_build.KERNEL_SOURCES)
def test_kernel_without_toolkit_raises_and_never_falls_back(name, tmp_path,
                                                            monkeypatch):
    # every kernel has its source in the package; with no CUDA toolkit the
    # loader raises instead of handing back anything else
    assert (cuda_build.SRC_DIR / f"{name}.cu").is_file()
    assert cuda_build.library_path(name).parent == cuda_build.BUILD_DIR
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load(name)
    assert not (tmp_path / "_build").exists() or not list(
        (tmp_path / "_build").iterdir())
