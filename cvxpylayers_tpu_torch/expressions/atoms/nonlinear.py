"""Nonlinear atoms and their conic graph implementations (epigraph/hypograph
transforms into Zero/NonNeg/SOC/Exp/PSD/Pow3D cones).

Atom set is scoped to what the reference's test corpus exercises
(cvxpylayers SURVEY section 4: LAD, least squares, logistic regression,
entropy projection, SDP trace minimization, OptNet QPs, GP problems, and the
functional layer zoo).

Canonicalization contract: `canon(ctx, arg_reps)` may allocate auxiliary
variable columns (ctx.new_aux) and add cone constraint blocks
(ctx.add_zero/add_nonneg/add_soc/add_exp/add_psd/add_pow), and returns the
TensorRep of the atom's replacement expression. Exactness of the relaxation
is guaranteed by DCP validation before canon (standard graph-implementation
argument, as in CVXPY).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ...canon.tensor_rep import TensorRep
from ..expression import Expression, Sign, as_expression
from .base import Atom
from .affine import _selection_matrix


# --------------------------------------------------------------------- helpers


def _ones_row(n: int) -> sp.csr_matrix:
    return sp.csr_matrix(np.ones((1, n)))


def _aux(ctx, n: int) -> TensorRep:
    off = ctx.new_aux(n)
    return TensorRep.variable(n, off)


def _scale_rows(rep: TensorRep, c: float) -> TensorRep:
    return rep.scale(c)


def _const_rep(n: int, val: float) -> TensorRep:
    return TensorRep.constant(np.full(n, float(val)))


# ----------------------------------------------------------------- elementwise


class Abs(Atom):
    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.args[0].is_nonpos()

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        t = _aux(ctx, x.n_rows)
        ctx.add_nonneg(t + x.neg())  # t - x >= 0
        ctx.add_nonneg(t + x)        # t + x >= 0
        return t


def abs(expr) -> Expression:  # noqa: A001
    return Abs(as_expression(expr))


class Pos(Atom):
    """max(x, 0) elementwise."""

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        t = _aux(ctx, x.n_rows)
        ctx.add_nonneg(t + x.neg())
        ctx.add_nonneg(t)
        return t


def pos(expr) -> Expression:
    return Pos(as_expression(expr))


def neg(expr) -> Expression:
    """max(-x, 0), the negative part (nonneg, convex)."""
    return Pos(-as_expression(expr))


class Square(Atom):
    """x^2 elementwise via 3-dim rotated SOC blocks."""

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.args[0].is_nonpos()

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        t = _aux(ctx, n)
        one = _const_rep(n, 1.0)
        # per element: ||[2 x_i ; 1 - t_i]|| <= 1 + t_i (one interleaved
        # block group — O(n) construction)
        ctx.add_soc_elem([t + one, x.scale(2.0), t.neg() + one])
        return t


def square(expr) -> Expression:
    return Square(as_expression(expr))


class Exp(Atom):
    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        t = _aux(ctx, x.n_rows)
        # t_i >= e^{x_i}  <=>  (x_i, 1, t_i) in Kexp
        ctx.add_exp(x, _const_rep(x.n_rows, 1.0), t)
        return t


def exp(expr) -> Expression:
    return Exp(as_expression(expr))


class Log(Atom):
    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        t = _aux(ctx, x.n_rows)
        # t_i <= log x_i  <=>  (t_i, 1, x_i) in Kexp
        ctx.add_exp(t, _const_rep(x.n_rows, 1.0), x)
        return t


def log(expr) -> Expression:
    return Log(as_expression(expr))


class Entr(Atom):
    """-x log x elementwise (concave)."""

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return True

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        t = _aux(ctx, x.n_rows)
        # t_i <= -x_i log x_i  <=>  (t_i, x_i, 1) in Kexp
        ctx.add_exp(t, x, _const_rep(x.n_rows, 1.0))
        return t


def entr(expr) -> Expression:
    return Entr(as_expression(expr))


class RelEntr(Atom):
    """x log(x/y) elementwise (convex, jointly)."""

    def shape_from_args(self):
        if self.args[0].shape != self.args[1].shape:
            raise ValueError("rel_entr args must share a shape")
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def canon(self, ctx, arg_reps):
        x, y = arg_reps
        t = _aux(ctx, x.n_rows)
        # t >= x log(x/y)  <=>  (-t, x, y) in Kexp
        ctx.add_exp(t.neg(), x, y)
        return t


def rel_entr(x, y) -> Expression:
    return RelEntr(as_expression(x), as_expression(y))


def kl_div(x, y) -> Expression:
    """x log(x/y) - x + y (nonneg, convex)."""
    x = as_expression(x)
    y = as_expression(y)
    return RelEntr(x, y) - x + y


class Logistic(Atom):
    """log(1 + e^x) elementwise."""

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        t = _aux(ctx, n)
        u = _aux(ctx, n)
        v = _aux(ctx, n)
        ones = _const_rep(n, 1.0)
        # e^{x - t} <= u, e^{-t} <= v, u + v <= 1
        ctx.add_exp(x + t.neg(), ones, u)
        ctx.add_exp(t.neg(), ones, v)
        ctx.add_nonneg(ones + u.neg() + v.neg())
        return t


def logistic(expr) -> Expression:
    return Logistic(as_expression(expr))


class InvPos(Atom):
    """1/x for x > 0, elementwise, convex decreasing."""

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_decr(self, i):
        return True

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        t = _aux(ctx, n)
        # t x >= 1, x, t >= 0  <=>  ||[2 ; x - t]|| <= x + t  per element
        ctx.add_soc_elem([x + t, _const_rep(n, 2.0), x + t.neg()])
        return t


def inv_pos(expr) -> Expression:
    return InvPos(as_expression(expr))


class Sqrt(Atom):
    """sqrt(x) elementwise, concave increasing on x >= 0."""

    def shape_from_args(self):
        return self.args[0].shape

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
        t = _aux(ctx, n)
        # t^2 <= x  <=>  ||[2t ; x - 1]|| <= x + 1  per element
        ctx.add_soc_elem(
            [x + _const_rep(n, 1.0), t.scale(2.0), x + _const_rep(n, -1.0)]
        )
        return t


def sqrt(expr) -> Expression:
    return Sqrt(as_expression(expr))


class Huber(Atom):
    """Huber loss, elementwise: x^2 for |x|<=M, M(2|x|-M) beyond."""

    def __init__(self, expr, M=1.0):
        self.M = float(M)
        if self.M <= 0:
            raise ValueError("huber threshold M must be positive")
        super().__init__(expr)

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.args[0].is_nonpos()

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        # huber(x) = min_{x = w + v} w^2 + 2 M |v|
        w = _aux(ctx, n)
        v = _aux(ctx, n)
        s = _aux(ctx, n)  # s >= w^2
        a = _aux(ctx, n)  # a >= |v|
        ctx.add_zero(x + w.neg() + v.neg())  # x - w - v == 0
        ctx.add_nonneg(a + v.neg())
        ctx.add_nonneg(a + v)
        one = _const_rep(n, 1.0)
        ctx.add_soc_elem([s + one, w.scale(2.0), s.neg() + one])
        return s + a.scale(2.0 * self.M)


def huber(expr, M=1.0) -> Expression:
    return Huber(as_expression(expr), M)


class Power(Atom):
    """x^p elementwise via 3-D power cones (p in (0,1): concave;
    p > 1: convex on x >= 0; p < 0: convex decreasing on x > 0;
    p = 1 or 2 handled by callers)."""

    def __init__(self, expr, p):
        self.p = float(p)
        super().__init__(expr)

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return self.p >= 1.0 or self.p < 0.0

    def is_atom_concave(self):
        return 0.0 < self.p <= 1.0

    def is_incr(self, i):
        if 0 < self.p <= 1:
            return True
        return self.p > 1 and self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.p < 0

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        t = _aux(ctx, n)
        ones = _const_rep(n, 1.0)
        if 0 < self.p < 1:
            # t <= x^p: (x, 1, t) in Pow(p)
            ctx.add_pow(x, ones, t, self.p)
        elif self.p > 1:
            # t >= x^p (x >= 0): x <= t^{1/p}: (t, 1, x) in Pow(1/p)
            ctx.add_pow(t, ones, x, 1.0 / self.p)
        elif self.p < 0:
            # t >= x^p (x > 0): t^a x^{1-a} >= 1 with a = 1/(1-p):
            # (t, x, 1) in Pow(a)
            ctx.add_pow(t, x, ones, 1.0 / (1.0 - self.p))
        else:
            raise ValueError(f"unsupported power {self.p}")
        return t

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else v ** self.p


def power(expr, p) -> Expression:
    expr = as_expression(expr)
    p = float(p)
    if p == 1.0:
        return expr
    if p == 2.0:
        return Square(expr)
    if p == 0.5:
        return Sqrt(expr)
    if p == 0:
        from ..leaf import Constant

        return Constant(np.ones(expr.shape))
    if p == -1.0:
        return InvPos(expr)  # SOC-representable, cheaper than a pow cone
    return Power(expr, p)


# -------------------------------------------------------------------- norms


class Norm1(Atom):
    def shape_from_args(self):
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.args[0].is_nonpos()

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        t = _aux(ctx, x.n_rows)
        ctx.add_nonneg(t + x.neg())
        ctx.add_nonneg(t + x)
        return t.apply_linear(_ones_row(x.n_rows))


class Norm2(Atom):
    """Euclidean norm of a vector (or Frobenius norm of a matrix)."""

    def shape_from_args(self):
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.args[0].is_nonpos()

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        t = _aux(ctx, 1)
        ctx.add_soc([t, x])
        return t


class NormInf(Atom):
    def shape_from_args(self):
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.args[0].is_nonpos()

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        t = _aux(ctx, 1)
        t_full = t.apply_linear(sp.csr_matrix(np.ones((n, 1))))
        ctx.add_nonneg(t_full + x.neg())
        ctx.add_nonneg(t_full + x)
        return t


class Norm2Grouped(Atom):
    """Euclidean norm along one axis (cvxpy norm(X, 2, axis=...)):
    one interleaved SOC block per output element."""

    def __init__(self, expr, axis, keepdims=False):
        self.axis = axis
        self.keepdims = bool(keepdims)
        super().__init__(expr)

    def shape_from_args(self):
        probe = np.zeros(self.args[0].shape, dtype=np.int8).sum(
            axis=self.axis, keepdims=self.keepdims
        )
        return probe.shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.args[0].is_nonpos()

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        from .affine import reduction_out_index

        x = arg_reps[0]
        shape = self.args[0].shape
        ax = self.axis % len(shape)
        w = shape[ax]
        n_in = x.n_rows
        m = self.size
        t = _aux(ctx, m)
        out_idx = reduction_out_index(shape, ax)
        coord = np.indices(shape)[ax].reshape(-1)
        parts = [t]
        src = np.arange(n_in)
        for k in range(w):
            mask = coord == k
            Sk = sp.csr_matrix(
                (np.ones(mask.sum()), (out_idx[mask], src[mask])),
                shape=(m, n_in),
            )
            parts.append(x.apply_linear(Sk))
        ctx.add_soc_elem(parts)
        return t

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        return np.linalg.norm(v, axis=self.axis, keepdims=self.keepdims)


def norm(expr, p=2, axis=None, keepdims=False) -> Expression:
    expr = as_expression(expr)
    if axis is not None:
        from .affine import Sum

        if p in (1, "1"):
            return Sum(Abs(expr), axis=axis, keepdims=keepdims)
        if p in (2, "2", "fro"):
            return Norm2Grouped(expr, axis, keepdims=keepdims)
        if p in (np.inf, "inf"):
            return MaxEntries(Abs(expr), axis=axis, keepdims=keepdims)
        raise ValueError("norm with axis supports p in {1, 2, inf}")
    if p == "fro":
        return Norm2(expr)
    if p == "nuc":
        raise NotImplementedError(
            "the nuclear norm arrives with the structured-atom later port "
            "slice"
        )
    if expr.ndim == 2:
        # cvxpy matrix-norm semantics: induced norms for p in {1, 2, inf}
        from .affine import Sum

        if p in (2, "2"):
            return SigmaMax(expr)
        if p in (1, "1"):
            # max abs column sum
            return MaxEntries(Sum(Abs(expr), axis=0))
        if p in (np.inf, "inf"):
            # max abs row sum
            return MaxEntries(Sum(Abs(expr), axis=1))
        raise ValueError(f"unsupported matrix norm order {p}")
    if p in (1, "1"):
        return Norm1(expr)
    if p in (2, "2"):
        return Norm2(expr)
    if p in (np.inf, "inf"):
        return NormInf(expr)
    if isinstance(p, (int, float)) and p > 1:
        return PnormGeneral(expr, p)
    raise ValueError(f"unsupported norm order {p}")


def pnorm(expr, p=2, axis=None, keepdims=False) -> Expression:
    """General p-norm; also supports the concave 0 < p < 1 variant
    (sum x^p)^(1/p) on nonneg arguments (cvxpy pnorm parity)."""
    if isinstance(p, (int, float)) and 0 < p < 1:
        if axis is not None:
            raise ValueError("pnorm with 0 < p < 1 does not support axis")
        return PnormGeneral(as_expression(expr), p)
    return norm(expr, p, axis=axis, keepdims=keepdims)


class SumSquares(Atom):
    """||x||^2 as a single scalar (rotated SOC)."""

    def shape_from_args(self):
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.args[0].is_nonpos()

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        t = _aux(ctx, 1)
        # ||[2x ; 1 - t]|| <= 1 + t
        ctx.add_soc([t + _const_rep(1, 1.0), x.scale(2.0),
                     t.neg() + _const_rep(1, 1.0)])
        return t


def sum_squares(expr) -> Expression:
    return SumSquares(as_expression(expr))


class QuadOverLin(Atom):
    """x'x / y (y scalar, positive)."""

    def shape_from_args(self):
        if not self.args[1].is_scalar():
            raise ValueError("quad_over_lin denominator must be scalar")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return i == 0 and self.args[0].is_nonneg()

    def is_decr(self, i):
        return (i == 0 and self.args[0].is_nonpos()) or i == 1

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x, y = arg_reps
        t = _aux(ctx, 1)
        # ||[2x ; y - t]|| <= y + t   (implies y >= 0)
        ctx.add_soc([y + t, x.scale(2.0), y + t.neg()])
        return t


def quad_over_lin(x, y) -> Expression:
    return QuadOverLin(as_expression(x), as_expression(y))


class QuadFormParam(Atom):
    """x' P x with P a PSD *Parameter* — DPP-legal because P enters linearly
    (the reference enables this via the _quad_form_dpp monkey-patch scoped
    to QP-capable solvers, cvxpylayers _quad_form_dpp.py:29-32). Only valid
    in the objective; the stuffer routes it to the native P matrix."""

    def __init__(self, x, P):
        super().__init__(x, P)

    def shape_from_args(self):
        x, P = self.args
        if x.ndim != 1 or P.shape != (x.shape[0], x.shape[0]):
            raise ValueError("quad_form needs x (n,) and P (n, n)")
        return ()

    def validate(self):
        x, P = self.args
        if x.has_param():
            raise ValueError(
                "quad_form with parameter P requires a parameter-free x "
                "(DPP rule; reference _quad_form_dpp.py:142-155)"
            )

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        raise NotImplementedError(
            "quad_form(x, Parameter) is only supported in the objective "
            "(the stuffer extracts it into the native quadratic term)"
        )


def quad_form(x, P) -> Expression:
    """x' P x for constant PSD/NSD P, or a PSD Parameter P (QP path)."""
    from ..leaf import Parameter as _Parameter

    x = as_expression(x)
    if isinstance(P, _Parameter):
        if not getattr(P, "PSD", False):
            raise ValueError(
                "quad_form with a Parameter requires Parameter(..., PSD=True)"
            )
        return QuadFormParam(x, P)
    P = as_expression(P)
    if P.has_var():
        raise ValueError("quad_form requires a constant or parameter P")
    Pv = np.asarray(P.value, dtype=np.float64)
    Pv = 0.5 * (Pv + Pv.T)
    w, V = np.linalg.eigh(Pv)
    if np.all(w >= -1e-9):
        w = np.maximum(w, 0.0)
        F = (V * np.sqrt(w)[None, :]).T  # P = F'F
        return sum_squares(_const_matmul(F, x))
    if np.all(w <= 1e-9):
        w = np.maximum(-w, 0.0)
        F = (V * np.sqrt(w)[None, :]).T
        return -sum_squares(_const_matmul(F, x))
    raise ValueError("quad_form requires a definite (PSD or NSD) matrix")


def _const_matmul(F, x):
    from ..leaf import Constant

    return Constant(F) @ x


# ----------------------------------------------------- max / min family


class MaxEntries(Atom):
    """max over all entries, or along an axis (cvxpy max(x, axis=...))."""

    def __init__(self, expr, axis=None, keepdims=False):
        self.axis = axis
        self.keepdims = bool(keepdims)
        super().__init__(expr)

    def shape_from_args(self):
        probe = np.zeros(self.args[0].shape, dtype=np.int8).max(
            axis=self.axis, keepdims=self.keepdims
        )
        return probe.shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        from .affine import reduction_expand_matrix

        x = arg_reps[0]
        t = _aux(ctx, self.size)
        L = reduction_expand_matrix(self.args[0].shape, self.axis, self.size)
        ctx.add_nonneg(t.apply_linear(L) + x.neg())
        return t

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        return np.max(v, axis=self.axis, keepdims=self.keepdims)


class MinEntries(Atom):
    def __init__(self, expr, axis=None, keepdims=False):
        self.axis = axis
        self.keepdims = bool(keepdims)
        super().__init__(expr)

    def shape_from_args(self):
        probe = np.zeros(self.args[0].shape, dtype=np.int8).min(
            axis=self.axis, keepdims=self.keepdims
        )
        return probe.shape

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        from .affine import reduction_expand_matrix

        x = arg_reps[0]
        t = _aux(ctx, self.size)
        L = reduction_expand_matrix(self.args[0].shape, self.axis, self.size)
        ctx.add_nonneg(x + t.apply_linear(L).neg())
        return t

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        return np.min(v, axis=self.axis, keepdims=self.keepdims)


def max(expr, axis=None, keepdims=False):  # noqa: A001
    return MaxEntries(as_expression(expr), axis=axis, keepdims=keepdims)


def min(expr, axis=None, keepdims=False):  # noqa: A001
    return MinEntries(as_expression(expr), axis=axis, keepdims=keepdims)


class Maximum(Atom):
    """Elementwise maximum of expressions."""

    def shape_from_args(self):
        from ..expression import broadcast_shapes_add

        s = self.args[0].shape
        for a in self.args[1:]:
            s = broadcast_shapes_add(s, a.shape)
        return s

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        from .affine import broadcast_map

        t = _aux(ctx, self.size)
        for a, r in zip(self.args, arg_reps):
            if a.shape != self.shape:
                r = r.apply_linear(broadcast_map(a.shape, self.shape))
            ctx.add_nonneg(t + r.neg())
        return t


class Minimum(Atom):
    def shape_from_args(self):
        from ..expression import broadcast_shapes_add

        s = self.args[0].shape
        for a in self.args[1:]:
            s = broadcast_shapes_add(s, a.shape)
        return s

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return True

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        from .affine import broadcast_map

        t = _aux(ctx, self.size)
        for a, r in zip(self.args, arg_reps):
            if a.shape != self.shape:
                r = r.apply_linear(broadcast_map(a.shape, self.shape))
            ctx.add_nonneg(r + t.neg())
        return t


def maximum(*args) -> Expression:
    return Maximum(*[as_expression(a) for a in args])


def minimum(*args) -> Expression:
    return Minimum(*[as_expression(a) for a in args])


# -------------------------------------------------------- log_sum_exp, geo


class LogSumExp(Atom):
    def __init__(self, expr, axis=None, keepdims=False):
        self.axis = axis
        self.keepdims = bool(keepdims)
        super().__init__(expr)

    def shape_from_args(self):
        probe = np.zeros(self.args[0].shape, dtype=np.int8).sum(
            axis=self.axis, keepdims=self.keepdims
        )
        return probe.shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        from .affine import reduction_expand_matrix

        x = arg_reps[0]
        n = x.n_rows
        m = self.size
        t = _aux(ctx, m)
        u = _aux(ctx, n)
        L = reduction_expand_matrix(self.args[0].shape, self.axis, m)
        ones = _const_rep(n, 1.0)
        # e^{x_i - t_{g(i)}} <= u_i, per group g: sum u <= 1
        ctx.add_exp(x + t.apply_linear(L).neg(), ones, u)
        ctx.add_nonneg(_const_rep(m, 1.0) + u.apply_linear(L.T.tocsr()).neg())
        return t

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        from scipy.special import logsumexp as _lse

        return _lse(v, axis=self.axis, keepdims=self.keepdims)


def log_sum_exp(expr, axis=None, keepdims=False) -> Expression:
    return LogSumExp(as_expression(expr), axis=axis, keepdims=keepdims)


class GeoMean(Atom):
    """prod x_i^{p_i / sum(p)} for a nonneg vector (p=None: uniform
    weights, the plain geometric mean), via a power-cone chain
    (cvxpy.geo_mean(x, p) parity)."""

    def __init__(self, expr, p=None):
        if p is not None:
            p = np.asarray(p, dtype=np.float64).reshape(-1)
            if np.any(p < 0) or p.sum() <= 0:
                raise ValueError("geo_mean weights must be nonneg, sum > 0")
        self.p = p
        super().__init__(expr)

    def validate(self):
        if self.p is not None and self.p.size != self.args[0].size:
            raise ValueError(
                f"geo_mean weight length {self.p.size} != "
                f"argument size {self.args[0].size}"
            )

    def shape_from_args(self):
        if self.args[0].ndim != 1:
            raise ValueError("geo_mean needs a vector")
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
        w = np.ones(n) if self.p is None else self.p
        idx = np.flatnonzero(w > 0)
        if idx.size == 1:
            return x.apply_linear(_selection_matrix([int(idx[0])], n))
        # y_1 = x_{i1}; y_k <= x_{ik}^{a_k} y_{k-1}^{1-a_k} with
        # a_k = w_{ik} / (w_{i1} + ... + w_{ik}) — telescopes to
        # prod x^{w/sum(w)}
        cum = np.cumsum(w[idx])
        y_prev = x.apply_linear(_selection_matrix([int(idx[0])], n))
        for j in range(1, idx.size):
            xk = x.apply_linear(_selection_matrix([int(idx[j])], n))
            yk = _aux(ctx, 1)
            ctx.add_pow(xk, y_prev, yk, float(w[idx[j]] / cum[j]))
            y_prev = yk
        return y_prev

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        v = np.asarray(v, dtype=np.float64).reshape(-1)
        w = np.ones(v.size) if self.p is None else self.p
        w = w / w.sum()
        return float(np.prod(v ** w))


def geo_mean(expr, p=None) -> Expression:
    return GeoMean(as_expression(expr), p)


class Perspective(Atom):
    """persp(f, s)(x, s) = s * f(x/s) for s >= 0 (closure at s = 0).

    Conic construction: canonicalize f's graph in a sandbox window (fresh
    rep cache so shared subexpressions get their own homogenized copies),
    then rewrite every captured cone block A(p)[x;u] + c(p) in K to
    A(p)[x;u] + c(p)*s in K — cones are invariant under positive scaling,
    so this is exactly the perspective's graph (cvxpy parity:
    cvxpy/atoms/perspective.py; reference corpus via interop)."""

    raw_canon = True

    def shape_from_args(self):
        return ()

    def validate(self):
        f, s = self.args
        if not f.is_scalar():
            raise ValueError("perspective needs a scalar expression f")
        if not s.is_scalar():
            raise ValueError("perspective needs a scalar scale s")
        if f.has_param() and s.has_param():
            raise ValueError(
                "DPP violation: perspective with parameters in both f and s"
            )

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def curvature(self):
        from ..expression import Curvature

        f, s = self.args
        if not s.is_affine():
            return Curvature.UNKNOWN
        fc = f.curvature()
        if fc.is_affine():
            return Curvature.AFFINE
        if fc.is_convex():
            return Curvature.CONVEX
        if fc.is_concave():
            return Curvature.CONCAVE
        return Curvature.UNKNOWN

    def sign(self):
        return self.args[0].sign()

    def canon(self, ctx, _):
        f, s = self.args
        rep_s = ctx.rep_of(s)
        ctx.add_nonneg(rep_s)  # domain: s >= 0
        fc = f.curvature()
        saved = ctx._rep_cache
        ctx._rep_cache = {}
        marks = ctx.block_marks()
        try:
            rep_f = ctx.rep_of(f)
            if fc.is_affine():
                t = None
            else:
                t = _aux(ctx, 1)
                if fc.is_convex():
                    ctx.add_nonneg(t + rep_f.neg())
                else:
                    ctx.add_nonneg(rep_f + t.neg())
            ctx.homogenize_since(marks, rep_s)
        finally:
            ctx._rep_cache = saved
        if t is None:
            return rep_f.homogenize_const(rep_s)
        return t

def perspective(f, s) -> Expression:
    """s * f(x/s) with s >= 0 (cvxpy.perspective parity)."""
    return Perspective(as_expression(f), as_expression(s))


def inv_prod(expr) -> Expression:
    """1/prod(x) for positive x (convex; cvxpy's inv_prod):
    geo_mean(x)^{-n} — Power(p<0, convex decreasing) of a concave
    argument is DCP."""
    expr = as_expression(expr)
    n = expr.size
    if expr.ndim != 1:
        from .affine import reshape

        expr = reshape(expr, (n,))
    if n == 1:
        return InvPos(expr)
    return Power(GeoMean(expr), -float(n))


# ------------------------------------------------------------ spectral atoms


class LambdaMax(Atom):
    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("lambda_max needs a square matrix")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def canon(self, ctx, arg_reps):
        X = arg_reps[0]
        s = self.args[0].shape[0]
        t = _aux(ctx, 1)
        # t I - X >= 0 (PSD)
        tI = t.apply_linear(
            sp.csr_matrix(np.eye(s).reshape(-1, 1))
        )
        ctx.add_psd(tI + X.neg(), s)
        return t


class LambdaMin(Atom):
    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("lambda_min needs a square matrix")
        return ()

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return True

    def canon(self, ctx, arg_reps):
        X = arg_reps[0]
        s = self.args[0].shape[0]
        t = _aux(ctx, 1)
        tI = t.apply_linear(sp.csr_matrix(np.eye(s).reshape(-1, 1)))
        ctx.add_psd(X + tI.neg(), s)
        return t


def lambda_max(expr) -> Expression:
    return LambdaMax(as_expression(expr))


def lambda_min(expr) -> Expression:
    return LambdaMin(as_expression(expr))


# ----------------------------------------------------- general p-norms


class PnormGeneral(Atom):
    """||x||_p for general p > 1 (convex), and the concave p in (0, 1)
    "pnorm" (sum x^p)^(1/p) on x >= 0, via 3-D power cones — the route
    the reference reaches through cvxpy's pnorm canon + SCS power cones
    (reference docs/guide; cvxpy pnorm power-cone reduction)."""

    def __init__(self, expr, p):
        self.p = float(p)
        if self.p <= 0 or self.p == 1.0:
            raise ValueError("PnormGeneral needs p > 1 or 0 < p < 1")
        super().__init__(expr)

    def shape_from_args(self):
        return ()

    def is_atom_convex(self):
        return self.p > 1

    def is_atom_concave(self):
        return 0 < self.p < 1

    def is_incr(self, i):
        return (0 < self.p < 1) or self.args[0].is_nonneg()

    def is_decr(self, i):
        return self.p > 1 and self.args[0].is_nonpos()

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        t = _aux(ctx, 1)
        r = _aux(ctx, n)
        t_n = t.apply_linear(sp.csr_matrix(np.ones((n, 1))))
        sum_row = sp.csr_matrix(np.ones((1, n)))
        if self.p > 1:
            # |x_i| <= r_i^{1/p} t^{1-1/p}  <=>  (r_i, t, x_i) in Pow(1/p);
            # with sum r = t this gives sum |x_i|^p <= t^p
            ctx.add_pow(r, t_n, x, 1.0 / self.p)
            ctx.add_zero(r.apply_linear(sum_row) + t.neg())
        else:
            # r_i <= x_i^p t^{1-p}  <=>  (x_i, t, r_i) in Pow(p);
            # sum r >= t gives t^p <= sum x_i^p
            ctx.add_pow(x, t_n, r, self.p)
            ctx.add_nonneg(r.apply_linear(sum_row) + t.neg())
        return t


# ------------------------------------------------------- matrix atoms


class MatrixFrac(Atom):
    """x' P^{-1} x via the Schur-complement epigraph
    [[P, x], [x', t]] >> 0 (reference reaches this through cvxpy's
    matrix_frac canon)."""

    def shape_from_args(self):
        xs = self.args[0].shape
        Ps = self.args[1].shape
        if len(Ps) != 2 or Ps[0] != Ps[1]:
            raise ValueError("matrix_frac needs a square matrix P")
        if len(xs) != 1 or xs[0] != Ps[0]:
            raise ValueError("matrix_frac needs x (n,) matching P (n, n)")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x, Prep = arg_reps
        n = self.args[0].shape[0]
        N = n + 1
        t = _aux(ctx, 1)
        # embed into flat C-order (N x N): P at (i, j), x at (i, n) and
        # (n, i), t at (n, n)
        src = np.arange(n * n)
        SP = sp.csr_matrix(
            (np.ones(n * n), ((src // n) * N + src % n, src)),
            shape=(N * N, n * n),
        )
        xi = np.arange(n)
        Sx = sp.csr_matrix(
            (np.ones(2 * n),
             (np.concatenate([xi * N + n, n * N + xi]),
              np.concatenate([xi, xi]))),
            shape=(N * N, n),
        )
        St = sp.csr_matrix(
            (np.ones(1), ([N * N - 1], [0])), shape=(N * N, 1)
        )
        flat = (
            Prep.apply_linear(SP)
            + x.apply_linear(Sx)
            + t.apply_linear(St)
        )
        ctx.add_psd(flat, N)
        return t


class SigmaMax(Atom):
    """Largest singular value: t >= sigma_max(X) iff
    [[t I_m, X], [X', t I_n]] >> 0."""

    def shape_from_args(self):
        if len(self.args[0].shape) != 2:
            raise ValueError("sigma_max needs a matrix")
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
        t = _aux(ctx, 1)
        diag_pos = np.arange(N) * N + np.arange(N)
        St = sp.csr_matrix(
            (np.ones(N), (diag_pos, np.zeros(N, dtype=int))),
            shape=(N * N, 1),
        )
        src = np.arange(m * n)
        i = src // n
        j = src % n
        SX = sp.csr_matrix(
            (np.ones(2 * m * n),
             (np.concatenate([i * N + (m + j), (m + j) * N + i]),
              np.concatenate([src, src]))),
            shape=(N * N, m * n),
        )
        ctx.add_psd(t.apply_linear(St) + X.apply_linear(SX), N)
        return t


class LogDet(Atom):
    """log det X (concave, X symmetric PSD) via the standard triangular
    factor canon: [[diag(d), Z'], [Z, X]] >> 0 with Z lower triangular,
    d = diag(Z), gives det X >= prod d; log_det = sum log d via exp
    cones (the cvxpy log_det reduction the reference relies on)."""

    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("log_det needs a square matrix")
        return ()

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return True

    def canon(self, ctx, arg_reps):
        X = arg_reps[0]
        n = self.args[0].shape[0]
        N = 2 * n
        # lower-triangular Z: n(n+1)/2 aux entries, row k <-> (i_k, j_k)
        tri_i, tri_j = [], []
        for jj in range(n):
            for ii in range(jj, n):
                tri_i.append(ii)
                tri_j.append(jj)
        tri_i = np.asarray(tri_i)
        tri_j = np.asarray(tri_j)
        ntri = tri_i.size
        Z = _aux(ctx, ntri)
        diag_mask = tri_i == tri_j
        # PSD block positions: diag(d) at (k, k) for k < n (sourced from
        # the diagonal entries of Z), Z at (n + i, j), Z' at (j, n + i),
        # X at (n + i, n + j)
        rows = []
        cols = []
        for k in range(ntri):
            i_, j_ = int(tri_i[k]), int(tri_j[k])
            rows.extend([(n + i_) * N + j_, j_ * N + (n + i_)])
            cols.extend([k, k])
            if i_ == j_:
                rows.append(i_ * N + i_)
                cols.append(k)
        SZ = sp.csr_matrix(
            (np.ones(len(rows)), (rows, cols)), shape=(N * N, ntri)
        )
        src = np.arange(n * n)
        SXm = sp.csr_matrix(
            (np.ones(n * n),
             ((n + src // n) * N + (n + src % n), src)),
            shape=(N * N, n * n),
        )
        ctx.add_psd(Z.apply_linear(SZ) + X.apply_linear(SXm), N)
        # t_i <= log d_i: exp cone (t_i, 1, d_i)
        d_sel = sp.csr_matrix(
            (np.ones(n), (np.arange(n), np.where(diag_mask)[0])),
            shape=(n, ntri),
        )
        d = Z.apply_linear(d_sel)
        t = _aux(ctx, n)
        ctx.add_exp(t, _const_rep(n, 1.0), d)
        return t.apply_linear(sp.csr_matrix(np.ones((1, n))))


class XExp(Atom):
    """x * e^x elementwise, convex increasing on the domain x >= 0
    (cvxpy's xexp atom; the reference reaches it through cvxpy).

    Graph: t >= x e^x on x >= 0 iff exists s with s >= x^2 and
    (s, x, t) in Kexp (x e^{s/x} <= t) — tight at s = x^2."""

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        x = arg_reps[0]
        n = x.n_rows
        t = _aux(ctx, n)
        s = _aux(ctx, n)
        one = _const_rep(n, 1.0)
        ctx.add_soc_elem([s + one, x.scale(2.0), s.neg() + one])  # s >= x^2
        ctx.add_exp(s, x, t)  # x e^{s/x} <= t
        ctx.add_nonneg(x)     # domain
        return t

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else v * np.exp(v)


class TrInv(Atom):
    """trace(X^{-1}) for X symmetric positive definite (cvxpy's tr_inv).

    Graph: tr(X^{-1}) <= t iff exists Y with [[X, I], [I, Y]] >> 0 and
    trace(Y) <= t (Schur complement: Y >> X^{-1})."""

    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("tr_inv needs a square matrix")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        X = arg_reps[0]
        n = self.args[0].shape[0]
        N = 2 * n
        Y = _aux(ctx, n * n)
        src = np.arange(n * n)
        i, j = src // n, src % n
        SX = sp.csr_matrix(
            (np.ones(n * n), (i * N + j, src)), shape=(N * N, n * n)
        )
        SY = sp.csr_matrix(
            (np.ones(n * n), ((n + i) * N + (n + j), src)),
            shape=(N * N, n * n),
        )
        # constant identity in the off-diagonal blocks
        const = np.zeros(N * N)
        k = np.arange(n)
        const[k * N + (n + k)] = 1.0
        const[(n + k) * N + k] = 1.0
        flat = (
            X.apply_linear(SX)
            + Y.apply_linear(SY)
            + TensorRep.constant(const)
        )
        ctx.add_psd(flat, N)
        tr_row = sp.csr_matrix(
            (np.ones(n), (np.zeros(n, dtype=int), k * n + k)),
            shape=(1, n * n),
        )
        return Y.apply_linear(tr_row)

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else float(np.trace(np.linalg.inv(v)))


def xexp(expr) -> Expression:
    return XExp(as_expression(expr))


def tr_inv(expr) -> Expression:
    return TrInv(as_expression(expr))


def log1p(expr) -> Expression:
    """log(1 + x) elementwise (concave increasing; cvxpy's log1p)."""
    return Log(as_expression(expr) + 1.0)


def scalene(expr, alpha, beta) -> Expression:
    """alpha * pos(x) + beta * neg(x) — the tilted absolute loss
    (cvxpy's scalene)."""
    expr = as_expression(expr)
    return float(alpha) * Pos(expr) + float(beta) * Pos(-expr)


def std(expr, ddof=0) -> Expression:
    """Standard deviation over all entries: ||x - mean(x)||_2 /
    sqrt(n - ddof) (convex; cvxpy's std)."""
    from .affine import mean, vec

    expr = as_expression(expr)
    n = expr.size
    if n - ddof <= 0:
        raise ValueError("std needs size > ddof")
    centered = vec(expr) - mean(expr)
    return pnorm(centered, 2) * (1.0 / np.sqrt(n - ddof))


def var(expr, ddof=0) -> Expression:
    """Variance over all entries: sum_squares(x - mean(x)) / (n - ddof)
    (convex)."""
    from .affine import mean, vec

    expr = as_expression(expr)
    n = expr.size
    if n - ddof <= 0:
        raise ValueError("var needs size > ddof")
    centered = vec(expr) - mean(expr)
    return sum_squares(centered) * (1.0 / (n - ddof))


def matrix_frac(x, P) -> Expression:
    return MatrixFrac(as_expression(x), as_expression(P))


def sigma_max(expr) -> Expression:
    return SigmaMax(as_expression(expr))


def log_det(expr) -> Expression:
    return LogDet(as_expression(expr))
