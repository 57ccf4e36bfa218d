"""Atoms that only exist for DGP (log-log / geometric programming):
they are rejected by DCP validation but consumed by the Dgp2Dcp transform
(canon/dgp.py), mirroring the reference's gp=True pipeline
(cvxpylayers utils/parse_args.py:437-453)."""

from __future__ import annotations

import numpy as np

from ..expression import Curvature, Expression, Sign, broadcast_shapes_add
from .base import Atom


class DivExpression(Atom):
    """a / b with a non-constant divisor (monomial division under DGP)."""

    def shape_from_args(self):
        return broadcast_shapes_add(self.args[0].shape, self.args[1].shape)

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return False

    def curvature(self) -> Curvature:
        return Curvature.UNKNOWN  # never DCP; DGP-only

    def sign(self):
        return Sign.mul(self.args[0].sign(), self.args[1].sign())

    def canon(self, ctx, arg_reps):
        raise ValueError(
            "division by a variable or parameter expression is not DCP/DPP; "
            "it is only valid in log-log (gp=True) problems"
        )

    @property
    def value(self):
        va, vb = self.args[0].value, self.args[1].value
        if va is None or vb is None:
            return None
        return va / vb


class PowerParam(Atom):
    """x ** p with a parameter exponent (DGP: p * log x)."""

    def shape_from_args(self):
        if not self.args[1].is_scalar():
            raise ValueError("parameter exponent must be scalar")
        return self.args[0].shape

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return False

    def curvature(self) -> Curvature:
        return Curvature.UNKNOWN  # never DCP; DGP-only

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        raise ValueError(
            "x ** Parameter is not DCP; it is only valid in log-log "
            "(gp=True) problems"
        )

    @property
    def value(self):
        va, vp = self.args[0].value, self.args[1].value
        if va is None or vp is None:
            return None
        return va ** vp


class LogAddExp(Atom):
    """Elementwise log(e^x + e^y) — the binary posynomial-add image in log
    space. Convex and increasing in both args (DCP-valid)."""

    def shape_from_args(self):
        return broadcast_shapes_add(self.args[0].shape, self.args[1].shape)

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        from ...canon.tensor_rep import TensorRep
        from .affine import broadcast_map

        reps = []
        for a, r in zip(self.args, arg_reps):
            if a.shape != self.shape:
                r = r.apply_linear(broadcast_map(a.shape, self.shape))
            reps.append(r)
        x, y = reps
        n = x.n_rows
        t_off = ctx.new_aux(n)
        u_off = ctx.new_aux(n)
        v_off = ctx.new_aux(n)
        t = TensorRep.variable(n, t_off)
        u = TensorRep.variable(n, u_off)
        v = TensorRep.variable(n, v_off)
        ones = TensorRep.constant(np.ones(n))
        # e^{x - t} <= u, e^{y - t} <= v, u + v <= 1
        ctx.add_exp(x + t.neg(), ones, u)
        ctx.add_exp(y + t.neg(), ones, v)
        ctx.add_nonneg(ones + u.neg() + v.neg())
        return t


# --------------------------------------------------------- DGP-only atoms
# (cvxpy's DGP atom set: prod, gmatmul, one_minus_pos, pf_eigenvalue,
# eye_minus_inv — cvxpylayers reaches these through cvxpy's Dgp2Dcp.)


class Prod(Atom):
    """prod(x) over all entries — log-log affine (DGP-only)."""

    def shape_from_args(self):
        return ()

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return False

    def curvature(self) -> Curvature:
        return Curvature.UNKNOWN  # never DCP; DGP-only

    def sign(self):
        return Sign.NONNEG if self.args[0].is_nonneg() else Sign.UNKNOWN

    def canon(self, ctx, arg_reps):
        raise ValueError(
            "prod is not DCP; it is only valid in log-log (gp=True) problems"
        )

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else np.prod(v)


class GMatMul(Atom):
    """gmatmul(A, x): prod_j x_j^{A_ij} for a constant real matrix A and a
    positive vector x — log-log affine (A @ log x)."""

    def __init__(self, A, x):
        self.A = np.asarray(A, dtype=np.float64)
        if self.A.ndim != 2:
            raise ValueError("gmatmul needs a constant 2-D matrix A")
        super().__init__(x)

    def shape_from_args(self):
        xs = self.args[0].shape
        if len(xs) != 1 or xs[0] != self.A.shape[1]:
            raise ValueError("gmatmul needs x (n,) matching A (m, n)")
        return (self.A.shape[0],)

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return False

    def curvature(self) -> Curvature:
        return Curvature.UNKNOWN  # never DCP; DGP-only

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        raise ValueError(
            "gmatmul is not DCP; it is only valid in log-log (gp=True) "
            "problems"
        )

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else np.exp(self.A @ np.log(v))


class OneMinusPos(Atom):
    """1 - x on 0 < x < 1 — log-log concave (DGP-only)."""

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return False

    def curvature(self) -> Curvature:
        return Curvature.UNKNOWN  # affine in DCP terms, but kept DGP-only
        # to mirror cvxpy's one_minus_pos (an explicit DGP atom)

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        raise ValueError(
            "one_minus_pos is only valid in log-log (gp=True) problems; "
            "write (1 - x) directly for DCP use"
        )

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else 1.0 - v


class PfEigenvalue(Atom):
    """Perron-Frobenius eigenvalue (spectral radius) of an elementwise
    positive matrix — log-log convex (DGP-only)."""

    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("pf_eigenvalue needs a square matrix")
        return ()

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return False

    def curvature(self) -> Curvature:
        return Curvature.UNKNOWN  # never DCP; DGP-only

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        raise ValueError(
            "pf_eigenvalue is not DCP; it is only valid in log-log "
            "(gp=True) problems"
        )

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        return float(np.max(np.real(np.linalg.eigvals(v))))


class EyeMinusInv(Atom):
    """(I - X)^{-1} for elementwise positive X with pf_eigenvalue(X) < 1 —
    log-log convex, entrywise (DGP-only)."""

    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("eye_minus_inv needs a square matrix")
        return s

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return False

    def curvature(self) -> Curvature:
        return Curvature.UNKNOWN  # never DCP; DGP-only

    def sign(self):
        return Sign.NONNEG

    def canon(self, ctx, arg_reps):
        raise ValueError(
            "eye_minus_inv is not DCP; it is only valid in log-log "
            "(gp=True) problems"
        )

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        return np.linalg.inv(np.eye(v.shape[0]) - v)


def prod(expr) -> Expression:
    from ..expression import as_expression

    return Prod(as_expression(expr))


def gmatmul(A, x) -> Expression:
    from ..expression import as_expression

    return GMatMul(A, as_expression(x))


def one_minus_pos(expr) -> Expression:
    from ..expression import as_expression

    return OneMinusPos(as_expression(expr))


def pf_eigenvalue(expr) -> Expression:
    from ..expression import as_expression

    return PfEigenvalue(as_expression(expr))


def eye_minus_inv(expr) -> Expression:
    from ..expression import as_expression

    return EyeMinusInv(as_expression(expr))


# ------------------------------------------------ log-space graph atoms
# (the DCP images of the DGP atoms above; emitted by canon/dgp.py)


class LogOneMinusExp(Atom):
    """log(1 - e^x) for x < 0 — concave, decreasing (the log-space image
    of one_minus_pos).

    Hypograph: s <= log(1 - e^x) iff e^s + e^x <= 1."""

    def shape_from_args(self):
        return self.args[0].shape

    def is_atom_convex(self):
        return False

    def is_atom_concave(self):
        return True

    def is_decr(self, i):
        return True

    def sign(self):
        return Sign.NONPOS

    def canon(self, ctx, arg_reps):
        from ...canon.tensor_rep import TensorRep

        x = arg_reps[0]
        n = x.n_rows
        s = TensorRep.variable(n, ctx.new_aux(n))
        u = TensorRep.variable(n, ctx.new_aux(n))
        v = TensorRep.variable(n, ctx.new_aux(n))
        ones = TensorRep.constant(np.ones(n))
        ctx.add_exp(s, ones, u)  # u >= e^s
        ctx.add_exp(x, ones, v)  # v >= e^x
        ctx.add_nonneg(ones + u.neg() + v.neg())  # u + v <= 1
        return s

    @property
    def value(self):
        v = self.args[0].value
        return None if v is None else np.log1p(-np.exp(v))


class LogPfEig(Atom):
    """log pf_eigenvalue(exp(T)) for the elementwise log T of a positive
    matrix — convex, increasing (the log-space image of pf_eigenvalue).

    Epigraph (the classic GP characterization lambda_pf(A) =
    inf_{v>0} max_i (A v)_i / v_i): s >= atom iff exists u with
    log sum_j e^{T_ij + u_j} <= s + u_i for every row i."""

    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("LogPfEig needs a square matrix")
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        import scipy.sparse as sp

        from ...canon.tensor_rep import TensorRep

        T = arg_reps[0]  # n*n rows, C-order (i, j) -> i*n + j
        n = self.args[0].shape[0]
        nn = n * n
        s = TensorRep.variable(1, ctx.new_aux(1))
        u = TensorRep.variable(n, ctx.new_aux(n))
        w = TensorRep.variable(nn, ctx.new_aux(nn))
        src = np.arange(nn)
        i, j = src // n, src % n
        Mj = sp.csr_matrix((np.ones(nn), (src, j)), shape=(nn, n))
        Mi = sp.csr_matrix((-np.ones(nn), (src, i)), shape=(nn, n))
        Ms = sp.csr_matrix(
            (-np.ones(nn), (src, np.zeros(nn, dtype=int))), shape=(nn, 1)
        )
        # a_ij = T_ij + u_j - u_i - s; w_ij >= e^{a_ij}
        a = T + u.apply_linear(Mj) + u.apply_linear(Mi) + s.apply_linear(Ms)
        ctx.add_exp(a, TensorRep.constant(np.ones(nn)), w)
        # row sums: sum_j w_ij <= 1
        R = sp.csr_matrix((np.ones(nn), (i, src)), shape=(n, nn))
        ctx.add_nonneg(
            TensorRep.constant(np.ones(n)) + w.apply_linear(R).neg()
        )
        return s

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        return float(
            np.log(np.max(np.real(np.linalg.eigvals(np.exp(v)))))
        )


class LogEyeMinusInv(Atom):
    """log (I - exp(T))^{-1} entrywise — convex, increasing (the log-space
    image of eye_minus_inv).

    Epigraph: W >= atom iff exp(W) >= I + exp(T) exp(W) entrywise (the
    Neumann-series fixed point Y = I + X Y at Y = (I-X)^{-1}): per entry
    log(delta_ij + sum_k e^{T_ik + W_kj}) <= W_ij."""

    def shape_from_args(self):
        s = self.args[0].shape
        if len(s) != 2 or s[0] != s[1]:
            raise ValueError("LogEyeMinusInv needs a square matrix")
        return s

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def is_incr(self, i):
        return True

    def canon(self, ctx, arg_reps):
        import scipy.sparse as sp

        from ...canon.tensor_rep import TensorRep

        T = arg_reps[0]  # (i, k) -> i*n + k, C-order
        n = self.args[0].shape[0]
        nn, nnn = n * n, n * n * n
        W = TensorRep.variable(nn, ctx.new_aux(nn))
        w = TensorRep.variable(nnn, ctx.new_aux(nnn))
        d = TensorRep.variable(n, ctx.new_aux(n))
        src = np.arange(nnn)  # flat (i, k, j) -> i*n^2 + k*n + j
        i = src // nn
        k = (src // n) % n
        j = src % n
        MT = sp.csr_matrix((np.ones(nnn), (src, i * n + k)), shape=(nnn, nn))
        MW1 = sp.csr_matrix((np.ones(nnn), (src, k * n + j)), shape=(nnn, nn))
        MW2 = sp.csr_matrix(
            (-np.ones(nnn), (src, i * n + j)), shape=(nnn, nn)
        )
        # w_ikj >= e^{T_ik + W_kj - W_ij}
        a = T.apply_linear(MT) + W.apply_linear(MW1) + W.apply_linear(MW2)
        ctx.add_exp(a, TensorRep.constant(np.ones(nnn)), w)
        # d_i >= e^{-W_ii}
        diag_sel = sp.csr_matrix(
            (-np.ones(n), (np.arange(n), np.arange(n) * n + np.arange(n))),
            shape=(n, nn),
        )
        ctx.add_exp(
            W.apply_linear(diag_sel), TensorRep.constant(np.ones(n)), d
        )
        # per (i, j): sum_k w_ikj + delta_ij d_i <= 1
        ij = np.arange(nn)
        Rs = sp.csr_matrix((np.ones(nnn), (i * n + j, src)), shape=(nn, nnn))
        Dsel = sp.csr_matrix(
            (np.ones(n), (np.arange(n) * n + np.arange(n), np.arange(n))),
            shape=(nn, n),
        )
        del ij
        ctx.add_nonneg(
            TensorRep.constant(np.ones(nn))
            + w.apply_linear(Rs).neg()
            + d.apply_linear(Dsel).neg()
        )
        return W

    @property
    def value(self):
        v = self.args[0].value
        if v is None:
            return None
        X = np.exp(v)
        return np.log(np.linalg.inv(np.eye(X.shape[0]) - X))
