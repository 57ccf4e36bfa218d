"""The port's own copy of the modelling language against the reference's.

The port carries the DSL (expressions and atoms) as its own copy, so that
it imports nothing of the reference. The same expression, built in both
packages over parameters holding the same numpy-seeded values, must have
the same shape, curvature, sign and DCP verdict, and evaluate to the same
number. Everything here is numpy on the host: no solve, no device.
"""

import numpy as np
import pytest

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct

_R = np.random.default_rng(17)
_V = _R.standard_normal(6)
_W = np.abs(_R.standard_normal(6)) + 0.1
_A = _R.standard_normal((4, 6))
_S = (lambda m: m @ m.T + np.eye(3))(_R.standard_normal((3, 3)))


def _leaves(mod):
    v = mod.Parameter(6)
    w = mod.Parameter(6, pos=True)
    A = mod.Parameter((4, 6))
    v.value, w.value, A.value = _V, _W, _A
    return v, w, A


_EXPRESSIONS = {
    "abs": lambda m, v, w, A: m.abs(v),
    "pos-neg": lambda m, v, w, A: m.pos(v) - m.neg(v),
    "square": lambda m, v, w, A: m.square(v),
    "sum_squares": lambda m, v, w, A: m.sum_squares(A @ v),
    "norm1": lambda m, v, w, A: m.norm(A @ v, 1),
    "norm2": lambda m, v, w, A: m.norm(v, 2),
    "norm_inf": lambda m, v, w, A: m.norm(v, "inf"),
    "pnorm3": lambda m, v, w, A: m.pnorm(v, 3),
    "max-min": lambda m, v, w, A: m.maximum(v, 0.2) + m.minimum(v, -0.1),
    "huber": lambda m, v, w, A: m.huber(v, 0.5),
    "quad_over_lin": lambda m, v, w, A: m.quad_over_lin(v, 2.0),
    "log_sum_exp": lambda m, v, w, A: m.log_sum_exp(v),
    "stack-reshape": lambda m, v, w, A: m.reshape(
        m.hstack([A @ v, 2.0 * v[:2] + 1.0]), (3, 2)),
    "cumsum-diff": lambda m, v, w, A: m.cumsum(v) - m.sum(m.diff(v)),
    "quad_form": lambda m, v, w, A: m.quad_form(v[:3], m.Constant(_S)),
    "entr-log-exp": lambda m, v, w, A: m.sum(m.entr(w)) + m.sum(m.log(w))
    - m.sum(m.exp(v)),
}


@pytest.mark.parametrize("name", sorted(_EXPRESSIONS))
def test_expression_carries_across(name):
    ej = _EXPRESSIONS[name](cj, *_leaves(cj))
    et = _EXPRESSIONS[name](ct, *_leaves(ct))
    assert tuple(et.shape) == tuple(ej.shape)
    assert et.curvature().name == ej.curvature().name
    assert et.sign().name == ej.sign().name
    assert et.is_convex() == ej.is_convex()
    assert et.is_nonneg() == ej.is_nonneg()
    want = np.asarray(ej.value, float)
    got = np.asarray(et.value, float)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    # as an objective (where it is a scalar) both packages give one verdict
    if et.shape == ():
        assert (ct.Problem(ct.Minimize(et)).is_dcp()
                == cj.Problem(cj.Minimize(ej)).is_dcp())
