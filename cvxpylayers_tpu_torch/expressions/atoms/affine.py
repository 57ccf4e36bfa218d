"""Affine atoms: add, negate, scalar/elementwise/matrix multiplication,
indexing, reshape, transpose, stacking, sum, trace, diag, broadcast.

Canonicalization builds constant linear maps (scipy sparse) applied to the
argument TensorReps, or — when a parameter-dependent factor is involved —
uses the TensorRep join-products that enforce DPP structurally.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..expression import (
    Curvature,
    Expression,
    Sign,
    as_expression,
    broadcast_shapes_add,
    shape_size,
)
from .base import Atom


def _selection_matrix(flat_idx: np.ndarray, n_in: int) -> sp.csr_matrix:
    """L with L[i, flat_idx[i]] = 1."""
    flat_idx = np.asarray(flat_idx, dtype=np.int64).reshape(-1)
    n_out = flat_idx.size
    return sp.csr_matrix(
        (np.ones(n_out), (np.arange(n_out), flat_idx)), shape=(n_out, n_in)
    )


def broadcast_map(from_shape, to_shape) -> sp.csr_matrix:
    """Linear map flattening numpy broadcasting from from_shape to to_shape."""
    src = np.broadcast_to(
        np.arange(shape_size(from_shape)).reshape(from_shape), to_shape
    )
    return _selection_matrix(src.reshape(-1), shape_size(from_shape))


class AddExpression(Atom):
    @staticmethod
    def create(a: Expression, b: Expression) -> Expression:
        return AddExpression(a, b)

    def shape_from_args(self):
        return broadcast_shapes_add(self.args[0].shape, self.args[1].shape)

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def sign(self):
        return Sign.add(self.args[0].sign(), self.args[1].sign())

    def canon(self, ctx, arg_reps):
        out = None
        for a, r in zip(self.args, arg_reps):
            if a.shape != self.shape:
                r = r.apply_linear(broadcast_map(a.shape, self.shape))
            out = r if out is None else out + r
        return out

    @property
    def value(self):
        va, vb = self.args[0].value, self.args[1].value
        if va is None or vb is None:
            return None
        return va + vb


class NegExpression(Atom):
    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_decr(self, i):
        return True

    def sign(self):
        return -self.args[0].sign()

    def canon(self, ctx, arg_reps):
        return arg_reps[0].neg()

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else -v


def multiply_dispatch(a: Expression, b: Expression) -> Expression:
    """`a * b`: scalar scaling or elementwise multiply."""
    if a.is_scalar() or b.is_scalar():
        return ScalarMul(a, b)
    return Multiply(a, b)


class _ProductMixin:
    """Shared DCP/DPP logic for products."""

    def _const_side(self):
        """Index of the variable-free factor, or None."""
        if not self.args[0].has_var():
            return 0
        if not self.args[1].has_var():
            return 1
        return None

    def curvature(self) -> Curvature:
        a, b = self.args
        ci = self._const_side()
        if ci is None:
            return Curvature.UNKNOWN  # var * var is not DCP
        const, other = self.args[ci], self.args[1 - ci]
        oc = other.curvature()
        if oc is Curvature.CONSTANT:
            return Curvature.CONSTANT
        if oc is Curvature.AFFINE:
            return Curvature.AFFINE
        # convex/concave scaled by a sign-known constant
        if const.is_nonneg():
            return oc
        if const.is_nonpos():
            return (
                Curvature.CONCAVE if oc is Curvature.CONVEX else Curvature.CONVEX
            )
        return Curvature.UNKNOWN

    def _dpp_ok(self) -> bool:
        a, b = self.args
        if not all(x._dpp_ok() for x in self.args):
            return False
        # at most one factor may involve parameters, and it must be
        # parameter-affine and variable-free
        if a.has_param() and b.has_param():
            return False
        if a.has_var() and b.has_var():
            return False
        return True

    def sign(self):
        return Sign.mul(self.args[0].sign(), self.args[1].sign())

    def _canon_product(self, ctx, arg_reps, kind: str):
        """kind in {scalar, elemwise}."""
        a, b = self.args
        ra, rb = arg_reps
        if a.has_var() and b.has_var():
            raise ValueError(
                "product of two variable expressions is not DCP"
            )
        # orient: multiplier (var-free) first
        if a.has_var():
            a, b, ra, rb = b, a, rb, ra
        if a.has_param():
            if kind == "scalar":
                if a.is_scalar():
                    return ra.param_scalar_mul(
                        rb if b.shape == self.shape
                        else rb.apply_linear(broadcast_map(b.shape, self.shape))
                    )
                # scalar var-side: broadcast b to a's shape then elementwise
                rb2 = rb.apply_linear(broadcast_map(b.shape, self.shape))
                return ra.param_elemwise(rb2)
            ra2 = (
                ra if a.shape == self.shape
                else ra.apply_linear(broadcast_map(a.shape, self.shape))
            )
            rb2 = (
                rb if b.shape == self.shape
                else rb.apply_linear(broadcast_map(b.shape, self.shape))
            )
            return ra2.param_elemwise(rb2)
        # constant multiplier: a constant ndarray
        c = a.value
        if c is None:
            raise ValueError("non-parameter constant factor without a value")
        cb = np.broadcast_to(np.asarray(c, dtype=np.float64), self.shape).reshape(-1)
        rb2 = (
            rb if b.shape == self.shape
            else rb.apply_linear(broadcast_map(b.shape, self.shape))
        )
        return rb2.apply_linear(sp.diags(cb))


class ScalarMul(_ProductMixin, Atom):
    def shape_from_args(self):
        return broadcast_shapes_add(self.args[0].shape, self.args[1].shape)

    def validate(self):
        if not (self.args[0].is_scalar() or self.args[1].is_scalar()):
            raise ValueError("ScalarMul needs a scalar factor")

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def canon(self, ctx, arg_reps):
        return self._canon_product(ctx, arg_reps, "scalar")

    @property
    def value(self):
        va, vb = self.args[0].value, self.args[1].value
        if va is None or vb is None:
            return None
        return va * vb


class Multiply(_ProductMixin, Atom):
    """Elementwise (Hadamard) product."""

    def shape_from_args(self):
        return broadcast_shapes_add(self.args[0].shape, self.args[1].shape)

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def canon(self, ctx, arg_reps):
        return self._canon_product(ctx, arg_reps, "elemwise")

    @property
    def value(self):
        va, vb = self.args[0].value, self.args[1].value
        if va is None or vb is None:
            return None
        return va * vb


def multiply(a, b) -> Expression:
    return multiply_dispatch(as_expression(a), as_expression(b))


class MatMul(_ProductMixin, Atom):
    @staticmethod
    def create(a: Expression, b: Expression) -> Expression:
        # 0-d operands are not matrices; size-1 vectors/matrices are fine
        if a.ndim == 0 or b.ndim == 0:
            raise ValueError("use * for scalar multiplication, @ for matmul")
        return MatMul(a, b)

    def shape_from_args(self):
        sa, sb = self.args[0].shape, self.args[1].shape
        if len(sa) == 1 and len(sb) == 1:
            if sa[0] != sb[0]:
                raise ValueError(f"matmul mismatch {sa} @ {sb}")
            return ()
        if len(sa) == 2 and len(sb) == 1:
            if sa[1] != sb[0]:
                raise ValueError(f"matmul mismatch {sa} @ {sb}")
            return (sa[0],)
        if len(sa) == 1 and len(sb) == 2:
            if sa[0] != sb[0]:
                raise ValueError(f"matmul mismatch {sa} @ {sb}")
            return (sb[1],)
        if sa[1] != sb[0]:
            raise ValueError(f"matmul mismatch {sa} @ {sb}")
        return (sa[0], sb[1])

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def canon(self, ctx, arg_reps):
        a, b = self.args
        ra, rb = arg_reps
        # 2-D views of both operands
        sa = a.shape if len(a.shape) == 2 else (1, a.shape[0])
        sb = b.shape if len(b.shape) == 2 else (b.shape[0], 1)
        if len(a.shape) == 1 and len(b.shape) == 2:
            sa = (1, a.shape[0])
        if len(a.shape) == 2 and len(b.shape) == 1:
            sb = (b.shape[0], 1)
        # (flat C-order of the 2-D view equals flat of the 1-D vector)
        if not a.has_var():
            if a.has_param():
                return ra.param_matmul_left(sa, rb, sb)
            C = np.asarray(a.value, dtype=np.float64).reshape(sa)
            L = sp.kron(sp.csr_matrix(C), sp.identity(sb[1], format="csr"))
            return rb.apply_linear(L)
        if not b.has_var():
            if b.has_param():
                return rb.param_matmul_right(sb, ra, sa)
            C = np.asarray(b.value, dtype=np.float64).reshape(sb)
            L = sp.kron(sp.identity(sa[0], format="csr"), sp.csr_matrix(C.T))
            return ra.apply_linear(L)
        raise ValueError("matmul of two variable expressions is not DCP")

    @property
    def value(self):
        va, vb = self.args[0].value, self.args[1].value
        if va is None or vb is None:
            return None
        return va @ vb


class Index(Atom):
    def __init__(self, expr, key):
        self.key = key
        super().__init__(expr)

    def shape_from_args(self):
        probe = np.empty(self.args[0].shape, dtype=np.int8)[self.key]
        return probe.shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def sign(self):
        return self.args[0].sign()

    def canon(self, ctx, arg_reps):
        src = np.arange(self.args[0].size).reshape(self.args[0].shape)[self.key]
        return arg_reps[0].apply_linear(
            _selection_matrix(src.reshape(-1), self.args[0].size)
        )

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else v[self.key]


class Reshape(Atom):
    def __init__(self, expr, shape):
        self._shape_arg = tuple(
            int(s) for s in (shape if isinstance(shape, (tuple, list)) else (shape,))
        )
        super().__init__(expr)

    def shape_from_args(self):
        if shape_size(self._shape_arg) != self.args[0].size:
            raise ValueError(
                f"cannot reshape {self.args[0].shape} to {self._shape_arg}"
            )
        return self._shape_arg

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def sign(self):
        return self.args[0].sign()

    def canon(self, ctx, arg_reps):
        # C-order reshape: flat layout unchanged
        r = arg_reps[0]
        return type(r)(self.size, r.rows, r.var_cols, r.param_cols, r.vals)

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else v.reshape(self._shape_arg)


def reshape(expr, shape) -> Expression:
    return Reshape(as_expression(expr), shape)


class Transpose(Atom):
    def shape_from_args(self):
        s = self.args[0].shape
        return (s[1], s[0])

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def sign(self):
        return self.args[0].sign()

    def canon(self, ctx, arg_reps):
        m, n = self.args[0].shape
        src = np.arange(m * n).reshape(m, n).T
        return arg_reps[0].apply_linear(_selection_matrix(src.reshape(-1), m * n))

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else v.T


def reduction_out_index(shape, axis) -> np.ndarray:
    """Flat (C-order) output index for each flat input index under a
    reduction over `axis` (None = reduce everything). Shared by Sum and the
    axis-aware max/min epigraphs."""
    n_in = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if axis is None or not shape:
        return np.zeros(n_in, dtype=np.int64)
    ax = axis % len(shape)
    grid = np.indices(shape)
    kept = [g for d, g in enumerate(grid) if d != ax]
    if not kept:
        return np.zeros(n_in, dtype=np.int64)
    out_shape_nk = tuple(s for d, s in enumerate(shape) if d != ax)
    flat = np.zeros_like(kept[0])
    stride = 1
    for d in range(len(out_shape_nk) - 1, -1, -1):
        flat = flat + kept[d] * stride
        stride *= out_shape_nk[d]
    return flat.reshape(-1)


def reduction_expand_matrix(shape, axis, n_out) -> sp.csr_matrix:
    """(n_in, n_out) 0/1 matrix broadcasting a reduced tensor back over
    `axis` of `shape` (the adjoint pattern of reduction_out_index)."""
    n_in = int(np.prod(shape, dtype=np.int64)) if shape else 1
    out_idx = reduction_out_index(shape, axis)
    return sp.csr_matrix(
        (np.ones(n_in), (np.arange(n_in), out_idx)), shape=(n_in, n_out)
    )


class Sum(Atom):
    def __init__(self, expr, axis=None, keepdims=False):
        self.axis = axis
        self.keepdims = bool(keepdims)
        super().__init__(expr)

    def shape_from_args(self):
        probe = np.empty(self.args[0].shape, dtype=np.int8).sum(
            axis=self.axis, keepdims=self.keepdims
        )
        return probe.shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def sign(self):
        return self.args[0].sign()

    def canon(self, ctx, arg_reps):
        n_in = self.args[0].size
        L = sp.csr_matrix(
            (np.ones(n_in),
             (reduction_out_index(self.args[0].shape, self.axis),
              np.arange(n_in))),
            shape=(self.size, n_in),
        )
        return arg_reps[0].apply_linear(L)

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        return np.sum(v, axis=self.axis, keepdims=self.keepdims)


def sum(expr, axis=None, keepdims=False) -> Expression:  # noqa: A001
    return Sum(as_expression(expr), axis=axis, keepdims=keepdims)


def mean(expr, axis=None, keepdims=False) -> Expression:
    """Arithmetic mean over all entries or along an axis (affine)."""
    expr = as_expression(expr)
    if axis is None:
        k = expr.size
    else:
        k = expr.shape[axis % len(expr.shape)]
    return Sum(expr, axis=axis, keepdims=keepdims) * (1.0 / k)


class Hstack(Atom):
    def shape_from_args(self):
        shapes = [a.shape for a in self.args]
        probes = [np.empty(s, dtype=np.int8) for s in shapes]
        return np.hstack(probes).shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def sign(self):
        if all(a.is_nonneg() for a in self.args):
            return Sign.NONNEG
        if all(a.is_nonpos() for a in self.args):
            return Sign.NONPOS
        return Sign.UNKNOWN

    def canon(self, ctx, arg_reps):
        total = self.size
        out = None
        offset_arrays = np.hstack(
            [
                np.arange(a.size).reshape(a.shape) + sum_
                for a, sum_ in zip(
                    self.args,
                    np.cumsum([0] + [a.size for a in self.args[:-1]]),
                )
            ]
        ).reshape(-1)
        # offset_arrays[j] = global source slot for output flat j, where the
        # "global source" is the concatenation of the args' flat layouts.
        for k, (a, r) in enumerate(zip(self.args, arg_reps)):
            base = int(np.sum([x.size for x in self.args[:k]], dtype=np.int64))
            # positions of this arg's entries in the output
            mask = (offset_arrays >= base) & (offset_arrays < base + a.size)
            tgt = np.flatnonzero(mask)
            src = offset_arrays[mask] - base
            L = sp.csr_matrix(
                (np.ones(tgt.size), (tgt, src)), shape=(total, a.size)
            )
            piece = r.apply_linear(L)
            out = piece if out is None else out + piece
        return out

    @property
    def value(self):
        vals = [a.value for a in self.args]
        if any(v is None for v in vals):
            return None
        return np.hstack(vals)


class Vstack(Atom):
    def shape_from_args(self):
        probes = [np.empty(a.shape, dtype=np.int8) for a in self.args]
        return np.vstack(probes).shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        # vstack promotes 1-D (n,) to (1, n); C-order flat layout is then the
        # simple concatenation of the args' flats.
        out = None
        offset = 0
        for a, r in zip(self.args, arg_reps):
            L = sp.csr_matrix(
                (
                    np.ones(a.size),
                    (np.arange(a.size) + offset, np.arange(a.size)),
                ),
                shape=(self.size, a.size),
            )
            piece = r.apply_linear(L)
            out = piece if out is None else out + piece
            offset += a.size
        return out

    @property
    def value(self):
        vals = [a.value for a in self.args]
        if any(v is None for v in vals):
            return None
        return np.vstack(vals)


def hstack(args) -> Expression:
    return Hstack(*[as_expression(a) for a in args])


def vstack(args) -> Expression:
    return Vstack(*[as_expression(a) for a in args])


class Trace(Atom):
    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("trace needs a square matrix")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        n = self.args[0].shape[0]
        diag_idx = np.arange(n) * n + np.arange(n)
        L = sp.csr_matrix(
            (np.ones(n), (np.zeros(n, dtype=np.int64), diag_idx)),
            shape=(1, n * n),
        )
        return arg_reps[0].apply_linear(L)

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else np.trace(v)


def trace(expr) -> Expression:
    return Trace(as_expression(expr))


class Diag(Atom):
    """vector -> diagonal matrix; matrix -> its diagonal as a vector."""

    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) == 1:
            return (s[0], s[0])
        if len(s) == 2 and s[0] == s[1]:
            return (s[0],)
        raise ValueError("diag needs a vector or square matrix")

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def sign(self):
        return self.args[0].sign()

    def canon(self, ctx, arg_reps):
        s = self.args[0].shape
        if len(s) == 1:
            n = s[0]
            tgt = np.arange(n) * n + np.arange(n)
            L = sp.csr_matrix(
                (np.ones(n), (tgt, np.arange(n))), shape=(n * n, n)
            )
        else:
            n = s[0]
            src = np.arange(n) * n + np.arange(n)
            L = _selection_matrix(src, n * n)
        return arg_reps[0].apply_linear(L)

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else np.diag(v)


def diag(expr) -> Expression:
    return Diag(as_expression(expr))


def bmat(blocks) -> Expression:
    """Block matrix from a 2-D list of blocks (cvxpy.bmat parity):
    vstack of per-row hstacks."""
    return vstack([hstack(row) for row in blocks])


def cumsum(expr, axis: int = 0) -> Expression:
    """Cumulative sum along an axis (lower-triangular selection map)."""
    expr = as_expression(expr)
    if expr.ndim == 1:
        n = expr.shape[0]
        L = sp.csr_matrix(np.tril(np.ones((n, n))))
        return _apply_matrix(expr, L, expr.shape)
    if expr.ndim != 2:
        raise ValueError("cumsum supports 1-D and 2-D expressions")
    m, n = expr.shape
    if axis == 0:
        # out[i, j] = sum_{k <= i} expr[k, j]; flat C-order map
        src = np.arange(m * n)
        rows, cols = [], []
        for i in range(m):
            for j in range(n):
                for k_ in range(i + 1):
                    rows.append(i * n + j)
                    cols.append(k_ * n + j)
        L = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                          shape=(m * n, m * n))
        del src
        return _apply_matrix(expr, L, (m, n))
    if axis == 1:
        rows, cols = [], []
        for i in range(m):
            for j in range(n):
                for k_ in range(j + 1):
                    rows.append(i * n + j)
                    cols.append(i * n + k_)
        L = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                          shape=(m * n, m * n))
        return _apply_matrix(expr, L, (m, n))
    raise ValueError("axis must be 0 or 1")


class _LinearMap(Atom):
    """Internal: fixed sparse linear map applied to the flattened arg."""

    def __init__(self, expr, L, out_shape):
        self._L = L
        self._out_shape = tuple(out_shape)
        super().__init__(expr)

    def shape_from_args(self):
        return self._out_shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return bool((self._L.data >= 0).all())

    def is_decr(self, i):
        return bool((self._L.data <= 0).all())

    def canon(self, ctx, arg_reps):
        return arg_reps[0].apply_linear(self._L)

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        out = self._L @ np.asarray(v, dtype=np.float64).reshape(-1)
        return out.reshape(self._out_shape)


def _apply_matrix(expr, L, out_shape) -> Expression:
    return _LinearMap(expr, L, out_shape)


def conv(c, expr) -> Expression:
    """1-D discrete convolution with a CONSTANT kernel c (cvxpy.conv
    parity): output length n + len(c) - 1, linear in expr."""
    c = np.asarray(as_expression(c).value
                   if hasattr(as_expression(c), "value") else c,
                   dtype=np.float64).reshape(-1)
    expr = as_expression(expr)
    if expr.ndim != 1:
        raise ValueError("conv expects a 1-D expression")
    n = expr.shape[0]
    k_ = c.size
    m_out = n + k_ - 1
    rows, cols, vals = [], [], []
    for i in range(m_out):
        for j in range(max(0, i - k_ + 1), min(n, i + 1)):
            rows.append(i)
            cols.append(j)
            vals.append(c[i - j])
    L = sp.csr_matrix((vals, (rows, cols)), shape=(m_out, n))
    return _apply_matrix(expr, L, (m_out,))


def kron(C, expr) -> Expression:
    """Kronecker product with a CONSTANT left factor C (cvxpy.kron
    parity for the constant-left case): linear in expr."""
    C = np.asarray(C.value if hasattr(C, "value") else C, dtype=np.float64)
    expr = as_expression(expr)
    if C.ndim != 2 or expr.ndim != 2:
        raise ValueError("kron expects 2-D factors")
    p_, q_ = C.shape
    m_, n_ = expr.shape
    # out[(i*m_ + k), (j*n_ + l)] = C[i, j] * X[k, l]; flat C-order map
    rows, cols, vals = [], [], []
    for i in range(p_):
        for j in range(q_):
            if C[i, j] == 0.0:
                continue
            for k_ in range(m_):
                for l_ in range(n_):
                    rows.append((i * m_ + k_) * (q_ * n_) + (j * n_ + l_))
                    cols.append(k_ * n_ + l_)
                    vals.append(C[i, j])
    L = sp.csr_matrix((vals, (rows, cols)),
                      shape=(p_ * m_ * q_ * n_, m_ * n_))
    return _apply_matrix(expr, L, (p_ * m_, q_ * n_))


def vec(expr, order: str = "F") -> Expression:
    """Flatten a matrix to a vector (cvxpy.vec parity; default
    column-major 'F' like cvxpy)."""
    expr = as_expression(expr)
    if expr.ndim <= 1:
        return reshape(expr, (expr.size,))
    if order not in ("F", "C"):
        raise ValueError("vec order must be 'F' or 'C'")
    if order == "C":
        return reshape(expr, (expr.size,))
    # internal flat layout is C-order; emit the F-order permutation
    src = np.arange(expr.size).reshape(expr.shape).reshape(-1, order="F")
    return _apply_matrix(
        expr, _selection_matrix(src, expr.size), (expr.size,)
    )


def upper_tri(expr) -> Expression:
    """Strictly-upper-triangular entries as a vector, row-major
    (cvxpy.upper_tri parity)."""
    expr = as_expression(expr)
    if expr.ndim != 2 or expr.shape[0] != expr.shape[1]:
        raise ValueError("upper_tri needs a square matrix")
    n = expr.shape[0]
    idx = [i * n + j for i in range(n) for j in range(i + 1, n)]
    d = len(idx)
    return _apply_matrix(
        expr, _selection_matrix(np.asarray(idx), expr.size), (d,)
    )


def vec_to_upper_tri(expr, strict: bool = False) -> Expression:
    """Inverse of upper_tri: place a vector of n(n+1)/2 (or n(n-1)/2 if
    strict) entries into the upper triangle of an n x n matrix, row-major,
    zeros elsewhere (cvxpy.vec_to_upper_tri parity)."""
    expr = as_expression(expr)
    if expr.ndim != 1:
        raise ValueError("vec_to_upper_tri needs a vector")
    m = expr.shape[0]
    # solve m = n(n+1)/2 (non-strict) or n(n-1)/2 (strict) for integer n
    disc = 1 + 8 * m
    root = int(np.sqrt(disc))
    if root * root != disc:
        raise ValueError(
            f"vector length {m} does not fit an upper triangle"
        )
    n = (root - 1) // 2 if not strict else (root + 1) // 2
    want = n * (n + 1) // 2 if not strict else n * (n - 1) // 2
    if want != m:
        raise ValueError(
            f"vector length {m} does not fit an upper triangle"
        )
    off = 0 if not strict else 1
    rows = [
        i * n + j for i in range(n) for j in range(i + off, n)
    ]
    L = sp.csr_matrix(
        (np.ones(m), (rows, np.arange(m))), shape=(n * n, m)
    )
    return _apply_matrix(expr, L, (n, n))


def diff(expr, k: int = 1) -> Expression:
    """k-th order forward differences of a vector (cvxpy.diff parity
    for the 1-D case)."""
    expr = as_expression(expr)
    if expr.ndim != 1:
        raise ValueError("diff expects a 1-D expression")
    n = expr.shape[0]
    if not (isinstance(k, int) and 1 <= k < n):
        raise ValueError("diff needs integer 1 <= k < n")
    L = sp.eye(n, format="csr")
    m_ = n
    for _ in range(k):
        D = sp.csr_matrix(
            (
                np.concatenate([-np.ones(m_ - 1), np.ones(m_ - 1)]),
                (
                    np.concatenate([np.arange(m_ - 1), np.arange(m_ - 1)]),
                    np.concatenate([np.arange(m_ - 1), np.arange(1, m_)]),
                ),
            ),
            shape=(m_ - 1, m_),
        )
        L = D @ L
        m_ -= 1
    return _apply_matrix(expr, L, (n - k,))


def matmul(a, b) -> Expression:
    """Matrix product (cvxpy.matmul parity; same as the @ operator)."""
    return as_expression(a) @ as_expression(b)


def scalar_product(a, b) -> Expression:
    """<a, b> = sum(multiply(a, b)) (cvxpy.scalar_product parity)."""
    return Sum(multiply(a, b))


def outer(x, y) -> Expression:
    """Outer product x y^T with a CONSTANT y (linear in x); cvxpy.outer
    parity for the constant-right case."""
    x = as_expression(x)
    y = np.asarray(y.value if hasattr(y, "value") else y,
                   dtype=np.float64).reshape(-1)
    if x.ndim != 1:
        raise ValueError("outer expects a 1-D left argument")
    n, m_ = x.shape[0], y.size
    # out[i*m_ + j] = y[j] * x[i]
    rows = np.arange(n * m_)
    cols = rows // m_
    vals = np.tile(y, n)
    L = sp.csr_matrix((vals, (rows, cols)), shape=(n * m_, n))
    return _apply_matrix(x, L, (n, m_))


def _pt_maps(dims, axis):
    dims = tuple(int(d) for d in dims)
    if axis < 0 or axis >= len(dims):
        raise ValueError("partial_trace/transpose axis out of range")
    N = int(np.prod(dims))
    return dims, N


def partial_trace(expr, dims, axis: int = 0) -> Expression:
    """Partial trace over subsystem `axis` of a matrix on a tensor-product
    space with subsystem dimensions `dims` (cvxpy.partial_trace parity)."""
    expr = as_expression(expr)
    dims, N = _pt_maps(dims, axis)
    if expr.shape != (N, N):
        raise ValueError(f"partial_trace needs a ({N}, {N}) matrix")
    keep = [d for i, d in enumerate(dims) if i != axis]
    M = int(np.prod(keep)) if keep else 1
    # index helpers: full index <-> (sub indices)
    strides = np.cumprod([1] + list(dims[::-1]))[::-1][1:]  # row-major strides

    def full_index(sub):
        return int(np.dot(sub, strides))

    rows, cols, vals = [], [], []
    out_sub_shapes = keep if keep else [1]
    for out_r in range(M):
        for out_c in range(M):
            r_sub = list(np.unravel_index(out_r, out_sub_shapes))
            c_sub = list(np.unravel_index(out_c, out_sub_shapes))
            for t in range(dims[axis]):
                rr = r_sub.copy()
                cc = c_sub.copy()
                rr.insert(axis, t)
                cc.insert(axis, t)
                rows.append(out_r * M + out_c)
                cols.append(full_index(rr) * N + full_index(cc))
                vals.append(1.0)
    L = sp.csr_matrix((vals, (rows, cols)), shape=(M * M, N * N))
    return _apply_matrix(expr, L, (M, M))


def partial_transpose(expr, dims, axis: int = 0) -> Expression:
    """Partial transpose over subsystem `axis` (cvxpy.partial_transpose
    parity)."""
    expr = as_expression(expr)
    dims, N = _pt_maps(dims, axis)
    if expr.shape != (N, N):
        raise ValueError(f"partial_transpose needs a ({N}, {N}) matrix")
    strides = np.cumprod([1] + list(dims[::-1]))[::-1][1:]

    def full_index(sub):
        return int(np.dot(sub, strides))

    rows, cols, vals = [], [], []
    for r in range(N):
        for c in range(N):
            r_sub = list(np.unravel_index(r, dims))
            c_sub = list(np.unravel_index(c, dims))
            r_sub[axis], c_sub[axis] = c_sub[axis], r_sub[axis]
            rows.append(r * N + c)
            cols.append(full_index(r_sub) * N + full_index(c_sub))
            vals.append(1.0)
    L = sp.csr_matrix((vals, (rows, cols)), shape=(N * N, N * N))
    return _apply_matrix(expr, L, (N, N))
