"""Structured nonlinear atoms: sorted/ordered statistics (sum_largest,
dotsort), spectral sums (lambda_sum_largest, norm_nuc), harmonic mean,
grouped norms (tv, mixed_norm), and compositions built on them (ptp,
sum_smallest).

Same canonicalization contract as nonlinear.py: `canon(ctx, arg_reps)`
allocates aux columns and cone blocks, returns the replacement TensorRep.
Reference reaches these atoms through cvxpy's atom library (the reference
test corpus and example notebooks use sum_largest/tv/normNuc-style atoms
via cvxpy); here they are native graph implementations.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..expression import Expression, Sign, as_expression
from .base import Atom
from .affine import _selection_matrix, hstack
from .nonlinear import (
    _aux,
    _ones_row,
    norm as _norm,
    max as _max_entries,
    min as _min_entries,
)


# ----------------------------------------------------------------- helpers


def _sym_from_tri(s: int) -> sp.csr_matrix:
    """Map s(s+1)/2 lower-triangular entries (column-major enumeration,
    matching LogDet) to the flat C-order s*s symmetric matrix."""
    rows, cols, vals = [], [], []
    k = 0
    for j in range(s):
        for i in range(j, s):
            rows.append(i * s + j)
            cols.append(k)
            vals.append(1.0)
            if i != j:
                rows.append(j * s + i)
                cols.append(k)
                vals.append(1.0)
            k += 1
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(s * s, s * (s + 1) // 2)
    )


def _tri_diag_row(s: int) -> sp.csr_matrix:
    """1 x s(s+1)/2 row summing the diagonal entries of the triangular
    enumeration used by _sym_from_tri."""
    cols = []
    k = 0
    for j in range(s):
        cols.append(k)          # (j, j) is first in its column block
        k += s - j
    return sp.csr_matrix(
        (np.ones(s), (np.zeros(s, dtype=int), cols)),
        shape=(1, s * (s + 1) // 2),
    )


def _embed_block(br: int, bc: int, r0: int, c0: int, N: int) -> sp.csr_matrix:
    """Map a flat (br*bc) block into positions (r0:r0+br, c0:c0+bc) of a
    flat C-order N x N matrix."""
    src = np.arange(br * bc)
    i = src // bc
    j = src % bc
    return sp.csr_matrix(
        (np.ones(src.size), ((r0 + i) * N + (c0 + j), src)),
        shape=(N * N, br * bc),
    )


def _full_ones(n: int) -> sp.csr_matrix:
    return sp.csr_matrix(np.ones((n, 1)))


# ----------------------------------------------------- ordered statistics


class SumLargest(Atom):
    """Sum of the k largest entries (convex); exact LP epigraph
    sum_largest(x, k) = min_{t, q >= 0, q >= x - t} k t + 1'q."""

    def __init__(self, expr, k):
        self.k = int(k)
        super().__init__(expr)

    def shape_from_args(self):
        if not (1 <= self.k <= self.args[0].size):
            raise ValueError("sum_largest needs 1 <= k <= size")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        t = _aux(ctx, 1)
        q = _aux(ctx, n)
        t_full = t.apply_linear(_full_ones(n))
        ctx.add_nonneg(q)
        ctx.add_nonneg(q + t_full + x.neg())
        return t.scale(float(self.k)) + q.apply_linear(_ones_row(n))


def sum_largest(expr, k) -> Expression:
    return SumLargest(as_expression(expr), k)


def sum_smallest(expr, k) -> Expression:
    """Sum of the k smallest entries (concave)."""
    return -SumLargest(-as_expression(expr), k)


def ptp(expr) -> Expression:
    """Peak-to-peak max(x) - min(x) (convex)."""
    e = as_expression(expr)
    return _max_entries(e) - _min_entries(e)


class Dotsort(Atom):
    """dotsort(x, w) = <sorted(x), sorted(w_padded)> for a CONSTANT weight
    vector w with len(w) <= size(x) (cvxpy.dotsort parity). Exact LP via
    assignment duality: min 1'p + 1'q s.t. p >= 0, p_i + q_j >= w_j x_i."""

    def __init__(self, expr, w):
        w = np.asarray(w.value if hasattr(w, "value") else w,
                       dtype=np.float64).reshape(-1)
        self.w = w
        super().__init__(expr)

    def shape_from_args(self):
        if self.args[0].ndim != 1:
            raise ValueError("dotsort expects a 1-D expression")
        if self.w.size > self.args[0].shape[0]:
            raise ValueError("dotsort needs len(w) <= len(x)")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return bool(np.all(self.w >= 0))

    def is_decr(self, i):
        return bool(np.all(self.w <= 0))

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        w = self.w
        m = w.size
        p = _aux(ctx, n)
        q = _aux(ctx, m)
        rows = np.arange(n * m)
        P_map = sp.csr_matrix(
            (np.ones(n * m), (rows, rows // m)), shape=(n * m, n)
        )
        Q_map = sp.csr_matrix(
            (np.ones(n * m), (rows, rows % m)), shape=(n * m, m)
        )
        X_map = sp.csr_matrix(
            (-np.tile(w, n), (rows, rows // m)), shape=(n * m, n)
        )
        ctx.add_nonneg(p)
        ctx.add_nonneg(
            p.apply_linear(P_map)
            + q.apply_linear(Q_map)
            + x.apply_linear(X_map)
        )
        return p.apply_linear(_ones_row(n)) + q.apply_linear(_ones_row(m))


def dotsort(expr, w) -> Expression:
    return Dotsort(as_expression(expr), w)


# ------------------------------------------------------------ spectral sums


class NormNuc(Atom):
    """Nuclear norm via the SDP epigraph
    t >= ||X||_* iff exists U, V sym: [[U, X], [X', V]] >> 0,
    t = (tr U + tr V) / 2."""

    def shape_from_args(self):
        if self.args[0].ndim != 2:
            raise ValueError("norm_nuc needs a matrix")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        X = arg_reps[0]
        m, n = self.args[0].shape
        N = m + n
        U = _aux(ctx, m * (m + 1) // 2)
        V = _aux(ctx, n * (n + 1) // 2)
        U_emb = U.apply_linear(_embed_block(m, m, 0, 0, N) @ _sym_from_tri(m))
        V_emb = V.apply_linear(_embed_block(n, n, m, m, N) @ _sym_from_tri(n))
        src = np.arange(m * n)
        i = src // n
        j = src % n
        SX = sp.csr_matrix(
            (np.ones(2 * m * n),
             (np.concatenate([i * N + (m + j), (m + j) * N + i]),
              np.concatenate([src, src]))),
            shape=(N * N, m * n),
        )
        ctx.add_psd(U_emb + V_emb + X.apply_linear(SX), N)
        return (
            U.apply_linear(_tri_diag_row(m))
            + V.apply_linear(_tri_diag_row(n))
        ).scale(0.5)


def norm_nuc(expr) -> Expression:
    return NormNuc(as_expression(expr))


class LambdaSumLargest(Atom):
    """Sum of the k largest eigenvalues of a symmetric matrix; exact SDP
    epigraph: min k t + tr Z s.t. Z >> 0, Z + t I - X >> 0."""

    def __init__(self, expr, k):
        self.k = int(k)
        super().__init__(expr)

    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("lambda_sum_largest needs a square matrix")
        if not (1 <= self.k <= s[0]):
            raise ValueError("lambda_sum_largest needs 1 <= k <= n")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def canon(self, ctx, arg_reps):
        X = arg_reps[0]
        s = self.args[0].shape[0]
        t = _aux(ctx, 1)
        Z = _aux(ctx, s * (s + 1) // 2)
        Z_flat = Z.apply_linear(_sym_from_tri(s))
        ctx.add_psd(Z_flat, s)
        tI = t.apply_linear(sp.csr_matrix(np.eye(s).reshape(-1, 1)))
        ctx.add_psd(Z_flat + tI + X.neg(), s)
        return t.scale(float(self.k)) + Z.apply_linear(_tri_diag_row(s))


def lambda_sum_largest(expr, k) -> Expression:
    return LambdaSumLargest(as_expression(expr), k)


def lambda_sum_smallest(expr, k) -> Expression:
    return -LambdaSumLargest(-as_expression(expr), k)


# ------------------------------------------------------------ harmonic mean


class HarmonicMean(Atom):
    """n / (sum 1/x_i) for x > 0 (concave). Hypograph: t <= hm(x)/n iff
    exists r: r_i x_i >= t^2 (rotated SOC per element), sum r <= t."""

    def shape_from_args(self):
        return ()

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        t = _aux(ctx, 1)
        r = _aux(ctx, n)
        t_full = t.apply_linear(_full_ones(n))
        # per element: ||[2 t ; r_i - x_i]|| <= r_i + x_i  (r_i x_i >= t^2)
        ctx.add_soc_elem([r + x, t_full.scale(2.0), r + x.neg()])
        ctx.add_nonneg(t + r.apply_linear(_ones_row(n)).neg())
        return t.scale(float(n))


def harmonic_mean(expr) -> Expression:
    return HarmonicMean(as_expression(expr))


# ------------------------------------------------------------- group norms


class SumGroupNorm2(Atom):
    """sum_i ||(a1_i, ..., ad_i)||_2 over d same-shape vector arguments
    (one interleaved SOC block group — O(n) construction)."""

    def shape_from_args(self):
        s = self.args[0].shape
        for a in self.args[1:]:
            if a.shape != s:
                raise ValueError("SumGroupNorm2 args must share a shape")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        n = arg_reps[0].n_rows
        t = _aux(ctx, n)
        ctx.add_soc_elem([t] + list(arg_reps))
        return t.apply_linear(_ones_row(n))


def tv(expr) -> Expression:
    """Total variation. 1-D: sum |x_{i+1} - x_i|; 2-D: sum over interior
    pixels of the 2-norm of the discrete gradient (cvxpy.tv parity)."""
    from .affine import diff

    e = as_expression(expr)
    if e.ndim == 1:
        return _norm(diff(e), 1)
    if e.ndim != 2:
        raise ValueError("tv needs a vector or matrix")
    m, n = e.shape
    if m < 2 or n < 2:
        raise ValueError("tv needs at least a 2x2 matrix")
    dv = e[1:, : n - 1] - e[: m - 1, : n - 1]
    dh = e[: m - 1, 1:] - e[: m - 1, : n - 1]
    from .affine import reshape

    sz = (m - 1) * (n - 1)
    return SumGroupNorm2(reshape(dv, (sz,)), reshape(dh, (sz,)))


def mixed_norm(X, p=2, q=1) -> Expression:
    """l_{p,q} norm: q-norm of the vector of row p-norms (cvxpy parity)."""
    X = as_expression(X)
    if X.ndim != 2:
        raise ValueError("mixed_norm needs a matrix")
    m, n = X.shape
    if q == 1 and p == 2:
        return SumGroupNorm2(*[X[:, j] for j in range(n)])
    if q == 1 and p == 1:
        from .nonlinear import Norm1
        from .affine import reshape

        return Norm1(reshape(X, (m * n,)))
    rows = [_norm(X[i, :], p) for i in range(m)]
    return _norm(hstack(rows), q)


class CumMax(Atom):
    """Cumulative maximum along an axis (cvxpy's cummax; convex,
    nondecreasing in the argument).

    Graph: the feasible set {t : t >= x, t nondecreasing along axis} has
    least element cummax(x), so replacing the atom by t under DCP use is
    exact (the same chain formulation cvxpy's cummax canon uses)."""

    def __init__(self, expr, axis: int = 0):
        self.axis = int(axis)
        super().__init__(expr)

    def shape_from_args(self):
        s = self.args[0].shape
        if not s:
            raise ValueError("cummax needs at least a vector")
        if not (-len(s) <= self.axis < len(s)):
            raise ValueError("cummax axis out of range")
        return s

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        shape = self.args[0].shape
        ax = self.axis % len(shape)
        n = x.n_rows
        t = _aux(ctx, n)
        ctx.add_nonneg(t + x.neg())  # t >= x
        # chain t[..., k, ...] >= t[..., k-1, ...] along ax
        idx = np.arange(n).reshape(shape)
        cur = np.moveaxis(idx, ax, 0)
        later = cur[1:].reshape(-1)
        earlier = cur[:-1].reshape(-1)
        m = later.size
        if m:
            rows = np.concatenate([np.arange(m), np.arange(m)])
            cols = np.concatenate([later, earlier])
            vals = np.concatenate([np.ones(m), -np.ones(m)])
            D = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
            ctx.add_nonneg(t.apply_linear(D))
        return t

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        return np.maximum.accumulate(v, axis=self.axis)


def cummax(expr, axis: int = 0) -> Expression:
    return CumMax(as_expression(expr), axis=axis)
