"""Approximation atoms: log_normcdf and loggamma.

cvxpy ships both as DCP-representable approximations (the reference
reaches them through cvxpy's atom library); this module rebuilds them as
compositions of this package's exact atoms.

- ``log_normcdf``: the standard-normal log-CDF is concave increasing. We
  use the same representation family as cvxpy — a nonnegative combination
  of shifted hinge-squares, log Phi(x) ~= -sum_i d_i * pos(b_i - x)^2 —
  but with coefficients refit from scratch by nonnegative least squares
  against scipy.stats.norm.logcdf on [-9, 9] (31 knots on [-7, 7]);
  max abs error ~2.2e-4 on [-6, 6] (tighter than cvxpy's table).
- ``loggamma``: log Gamma(x) is convex on x > 0 (Bohr-Mollerup). We use
  the recursion log Gamma(x) = log Gamma(x + K) - sum_{j<K} log(x + j)
  with a Stirling tail in DCP form: for z = x + K,
      log Gamma(z) ~= z log z - z - 0.5 log z + 0.5 log(2 pi) + 1/(12 z)
  where z log z = rel_entr(z, 1) (convex), -log z convex, 1/(12z) =
  inv_pos(z)/12 convex. K = 5 gives max abs error ~2.2e-5 on x > 1e-3.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ...canon.tensor_rep import TensorRep
from ..expression import Expression, Sign, as_expression
from .base import Atom
from .nonlinear import InvPos, Log, RelEntr, _aux, _const_rep

# Refit (NNLS vs scipy.stats.norm.logcdf, grid [-9, 9], knots [-7, 7]).
_LNC_KNOTS = np.array([
    -7.0, -6.0967741935, -5.6451612903, -5.1935483871, -4.7419354839,
    -4.2903225806, -3.8387096774, -3.3870967742, -2.935483871,
    -2.4838709677, -2.0322580645, -1.5806451613, -1.1290322581,
    -0.6774193548, -0.2258064516, 0.2258064516, 0.6774193548,
    1.1290322581, 1.5806451613, 2.0322580645, 2.4838709677, 2.935483871,
    3.3870967742, 3.8387096774, 4.2903225806, 4.7419354839, 5.1935483871,
])
_LNC_WEIGHTS = np.array([
    0.003363661253, 0.001293726402, 0.002374748221, 0.001913098819,
    0.002907125589, 0.00340295195, 0.0044238485, 0.0056483227,
    0.00739344957, 0.009779966564, 0.01312008252, 0.017772628781,
    0.024187972057, 0.032747985129, 0.043411185266, 0.054982808756,
    0.064272481838, 0.066345223223, 0.057602187032, 0.040266676314,
    0.022011106912, 0.009303709468, 0.003049247229, 0.000780681145,
    0.000159281965, 2.340971e-05, 4.644785e-06,
])


class LogNormCdf(Atom):
    """Elementwise log of the standard-normal CDF (concave, increasing;
    approximation — see module docstring).

    Graph: per element j, one rotated SOC for the weighted hinge-square
    sum (s_j >= sum_i d_i v_ij^2 with v_ij >= b_i - x_j, v_ij >= 0) and
    the atom value is -s_j. A single wide SOC per element keeps the
    active boundary point smooth — one tiny SOC per knot puts most
    blocks at the cone vertex and stalls Newton polish."""

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def sign(self):
        return Sign.NONPOS

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        k = _LNC_KNOTS.size
        v = _aux(ctx, k * n)  # knot-major: row i*n + j
        s = _aux(ctx, n)
        # v_ij >= b_i - x_j and v_ij >= 0
        tile = sp.csr_matrix(
            (np.ones(k * n),
             (np.arange(k * n), np.tile(np.arange(n), k))),
            shape=(k * n, n),
        )
        b_flat = np.repeat(_LNC_KNOTS, n)
        ctx.add_nonneg(v + x.apply_linear(tile) + TensorRep.constant(-b_flat))
        ctx.add_nonneg(v)
        # s_j >= sum_i d_i v_ij^2: ||[2 sqrt(d_i) v_ij ; 1 - s_j]|| <= 1 + s_j
        one = _const_rep(n, 1.0)
        parts = [s + one]
        for i in range(k):
            sel = sp.csr_matrix(
                (np.full(n, 2.0 * np.sqrt(_LNC_WEIGHTS[i])),
                 (np.arange(n), i * n + np.arange(n))),
                shape=(n, k * n),
            )
            parts.append(v.apply_linear(sel))
        parts.append(s.neg() + one)
        ctx.add_soc_elem(parts)
        return s.neg()

    @property
    def value(self):
        xv = self.args[0].value
        if xv is None:
            return None
        hinge = np.maximum(
            _LNC_KNOTS.reshape((-1,) + (1,) * np.ndim(xv)) - xv, 0.0
        )
        return -np.tensordot(_LNC_WEIGHTS, hinge ** 2, axes=(0, 0))


def log_normcdf(expr) -> Expression:
    return LogNormCdf(as_expression(expr))


def loggamma(expr, shift: int = 5) -> Expression:
    """Elementwise log Gamma(x) for x > 0 (convex; approximation — see
    module docstring)."""
    x = as_expression(expr)
    z = x + float(shift)
    ones = np.ones(x.shape if x.shape else ())
    out = (
        RelEntr(z, as_expression(ones))          # z log z
        + Log(z) * (-0.5)
        - z
        + float(0.5 * np.log(2.0 * np.pi))
        + InvPos(z) * (1.0 / 12.0)
    )
    for j in range(int(shift)):
        out = out - Log(x + float(j))
    return out
