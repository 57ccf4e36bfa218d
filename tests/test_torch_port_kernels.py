"""Port kernel K1 (the fused polyhedral ADMM epoch) against the reference.

The reference's Pallas kernel runs in interpreter mode on the CPU (as
tests/test_solver.py runs it); the port's plain version must give the
same (x, z, y). The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py; here a CPU tensor must never launch it.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cvxpylayers_tpu.solver.pallas_admm import polyhedral_inner_epoch as jax_epoch
from cvxpylayers_tpu_torch.solver import cuda_admm

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
