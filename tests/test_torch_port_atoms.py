"""More of the port's DSL copy against the reference's: matrix-valued and
cone-representable atoms.

tests/test_torch_port_dsl.py holds the vector atoms of the polyhedral
slice. The port carries the whole modelling language, so the atoms that
only later slices can solve (exponential, PSD and power cones) must still
carry across: the same expression over the same parameter values has the
same shape, curvature, sign and value in both packages. Numpy on the
host; no solve.
"""

import numpy as np
import pytest

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct

_R = np.random.default_rng(23)
_M = _R.standard_normal((3, 3))
_S = _M @ _M.T + np.eye(3)
_W = np.abs(_R.standard_normal(4)) + 0.2
_V = _R.standard_normal(4)


def _leaves(mod):
    M = mod.Parameter((3, 3))
    S = mod.Parameter((3, 3), PSD=True)
    w = mod.Parameter(4, pos=True)
    v = mod.Parameter(4)
    M.value, S.value, w.value, v.value = _M, _S, _W, _V
    return M, S, w, v


_EXPRESSIONS = {
    "trace-diag": lambda m, M, S, w, v: m.trace(M) + m.sum(m.diag(M)),
    "transpose-matmul": lambda m, M, S, w, v: M.T @ M + 2.0 * M,
    "vstack-bmat": lambda m, M, S, w, v: m.bmat(
        [[M, M.T], [m.Constant(np.eye(3)), -M]]) @ m.vstack([M, S]),
    "kron": lambda m, M, S, w, v: m.kron(m.Constant(np.eye(2)), M),
    "upper_tri-vec": lambda m, M, S, w, v: m.sum(m.upper_tri(M))
    + m.sum(m.vec(M)),
    "outer-conv": lambda m, M, S, w, v: m.sum(m.outer(v, w))
    + m.sum(m.conv(np.array([1.0, -2.0, 0.5]), v)),
    "mean-var-std": lambda m, M, S, w, v: m.mean(v) + m.var(v) + m.std(v),
    "power-sqrt": lambda m, M, S, w, v: m.sum(m.power(w, 3))
    + m.sum(m.sqrt(w)) + m.sum(m.power(w, -1)),
    "inv_pos-geo_mean": lambda m, M, S, w, v: m.sum(m.inv_pos(w))
    - m.geo_mean(w),
    "kl_div-rel_entr": lambda m, M, S, w, v: m.sum(m.kl_div(w, 2.0 * w))
    + m.sum(m.rel_entr(w, w + 1.0)),
    "logistic-log1p": lambda m, M, S, w, v: m.sum(m.logistic(v))
    - m.sum(m.log1p(w)),
    "lambda_max-min": lambda m, M, S, w, v: m.lambda_max(S)
    - m.lambda_min(S),
    "sigma_max": lambda m, M, S, w, v: m.sigma_max(M),
    "log_det": lambda m, M, S, w, v: -m.log_det(S),
    "matrix_frac-tr_inv": lambda m, M, S, w, v: m.matrix_frac(v[:3], S)
    + m.tr_inv(S),
    "quad_form-scalene": lambda m, M, S, w, v: m.quad_form(
        v[:3], m.Constant(_S)) + m.sum(m.scalene(v, 2.0, 0.5)),
}


@pytest.mark.parametrize("name", sorted(_EXPRESSIONS))
def test_expression_carries_across(name):
    ej = _EXPRESSIONS[name](cj, *_leaves(cj))
    et = _EXPRESSIONS[name](ct, *_leaves(ct))
    assert tuple(et.shape) == tuple(ej.shape)
    assert et.curvature().name == ej.curvature().name
    assert et.sign().name == ej.sign().name
    assert et.is_convex() == ej.is_convex()
    assert et.is_concave() == ej.is_concave()
    want = np.asarray(ej.value, float)
    got = np.asarray(et.value, float)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
