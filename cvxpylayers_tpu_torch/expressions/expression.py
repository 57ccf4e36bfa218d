"""Expression DAG with DCP curvature / sign analysis and DPP tracking.

This is the symbolic front end of the framework — the role CVXPY's atom
library and DCP verifier play for the reference (cvxpylayers SURVEY
section 2.2, "CVXPY" row). It is a from-scratch design, scoped to the atom
set the reference's test corpus exercises, with C-order flattening semantics
throughout.

Conventions:
  * shapes are () / (n,) / (m, n); flattening is C-order (row-major);
  * `@` is matrix multiplication, `*` is scalar or elementwise multiply,
    `==`, `<=`, `>=` build constraints;
  * curvature is with respect to *variables* (parameters are constants for
    DCP); DPP additionally requires products to have at most one
    parameter-dependent factor, which canonicalization enforces structurally
    (tensor_rep raises on param-param or var-var products).
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np


class Curvature(enum.Enum):
    CONSTANT = 0
    AFFINE = 1
    CONVEX = 2
    CONCAVE = 3
    UNKNOWN = 4

    def is_convex(self) -> bool:
        return self in (Curvature.CONSTANT, Curvature.AFFINE, Curvature.CONVEX)

    def is_concave(self) -> bool:
        return self in (Curvature.CONSTANT, Curvature.AFFINE, Curvature.CONCAVE)

    def is_affine(self) -> bool:
        return self in (Curvature.CONSTANT, Curvature.AFFINE)


class Sign(enum.Enum):
    ZERO = 0
    NONNEG = 1
    NONPOS = 2
    UNKNOWN = 3

    def __neg__(self) -> "Sign":
        if self is Sign.NONNEG:
            return Sign.NONPOS
        if self is Sign.NONPOS:
            return Sign.NONNEG
        return self

    @staticmethod
    def add(a: "Sign", b: "Sign") -> "Sign":
        if a is Sign.ZERO:
            return b
        if b is Sign.ZERO:
            return a
        if a is b:
            return a
        return Sign.UNKNOWN

    @staticmethod
    def mul(a: "Sign", b: "Sign") -> "Sign":
        if a is Sign.ZERO or b is Sign.ZERO:
            return Sign.ZERO
        if Sign.UNKNOWN in (a, b):
            return Sign.UNKNOWN
        return Sign.NONNEG if a is b else Sign.NONPOS


def shape_size(shape: Tuple[int, ...]) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _is_zero(e) -> bool:
    """Static check: is `e` the literal constant 0 (any shape)?"""
    from .leaf import Constant

    if not isinstance(e, Constant):
        return False
    import numpy as _np

    return bool(_np.all(_np.asarray(e.value) == 0))


class Expression:
    """Base class for all symbolic expressions."""

    shape: Tuple[int, ...]
    args: Tuple["Expression", ...]

    # --------------------------------------------------------------- metadata

    @property
    def size(self) -> int:
        return shape_size(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def is_scalar(self) -> bool:
        return self.size == 1

    def variables(self):
        seen = {}
        for a in self.args:
            for v in a.variables():
                seen[id(v)] = v
        return list(seen.values())

    def parameters(self):
        seen = {}
        for a in self.args:
            for p in a.parameters():
                seen[id(p)] = p
        return list(seen.values())

    def has_var(self) -> bool:
        return bool(self.variables())

    def has_param(self) -> bool:
        return bool(self.parameters())

    # ------------------------------------------------------------- DCP / DPP

    def curvature(self) -> Curvature:
        raise NotImplementedError

    def sign(self) -> Sign:
        return Sign.UNKNOWN

    def is_convex(self) -> bool:
        return self.curvature().is_convex()

    def is_concave(self) -> bool:
        return self.curvature().is_concave()

    def is_affine(self) -> bool:
        return self.curvature().is_affine()

    def is_constant(self) -> bool:
        return not self.has_var()

    def is_nonneg(self) -> bool:
        return self.sign() in (Sign.NONNEG, Sign.ZERO)

    def is_nonpos(self) -> bool:
        return self.sign() in (Sign.NONPOS, Sign.ZERO)

    def is_dpp(self) -> bool:
        """DPP: DCP plus every product has at most one parameter-dependent
        factor and parameters enter affinely."""
        return self.curvature() is not Curvature.UNKNOWN and self._dpp_ok()

    def _dpp_ok(self) -> bool:
        return all(a._dpp_ok() for a in self.args)

    def is_param_affine(self) -> bool:
        """Affine as a function of the parameters (variables fixed)."""
        if not self.has_param():
            return True
        if not self.is_affine() and self.has_var():
            return False
        return self._dpp_ok()

    # ------------------------------------------------------------- operators

    def __add__(self, other):
        from .atoms.affine import AddExpression

        return AddExpression.create(self, as_expression(other))

    def __radd__(self, other):
        return as_expression(other) + self

    def __sub__(self, other):
        return self + (-as_expression(other))

    def __rsub__(self, other):
        return as_expression(other) + (-self)

    def __neg__(self):
        from .atoms.affine import NegExpression

        return NegExpression(self)

    def __mul__(self, other):
        from .atoms.affine import multiply_dispatch

        return multiply_dispatch(self, as_expression(other))

    def __rmul__(self, other):
        from .atoms.affine import multiply_dispatch

        return multiply_dispatch(as_expression(other), self)

    def __matmul__(self, other):
        from .atoms.affine import MatMul

        return MatMul.create(self, as_expression(other))

    def __rmatmul__(self, other):
        from .atoms.affine import MatMul

        return MatMul.create(as_expression(other), self)

    def __truediv__(self, other):
        other = as_expression(other)
        if other.has_var() or other.has_param():
            # not DCP/DPP, but valid under DGP (monomial division): build the
            # marker atom; DCP validation rejects it outside gp=True
            from .atoms.gp import DivExpression

            return DivExpression(self, other)
        from .atoms.affine import multiply_dispatch
        from .leaf import Constant

        return multiply_dispatch(Constant(1.0 / other.value), self)

    def __rtruediv__(self, other):
        return as_expression(other) / self

    def __pow__(self, p):
        if isinstance(p, Expression):
            # parameter exponent: valid only under DGP (y**c -> c*log y)
            from .atoms.gp import PowerParam

            return PowerParam(self, p)
        from .atoms.nonlinear import power

        return power(self, p)

    def __getitem__(self, key):
        from .atoms.affine import Index

        return Index(self, key)

    @property
    def T(self):
        from .atoms.affine import Transpose

        if self.ndim < 2:
            return self
        return Transpose(self)

    # ------------------------------------------------------------ constraints

    def __eq__(self, other):  # type: ignore[override]
        from .constraints import Equality

        return Equality(self, as_expression(other))

    def __le__(self, other):
        from .constraints import Inequality

        return Inequality(self, as_expression(other))

    def __ge__(self, other):
        from .constraints import Inequality

        return Inequality(as_expression(other), self)

    def __rshift__(self, other):
        """X >> Y: X - Y is positive semidefinite (cvxpy operator
        parity; `ct.PSD(X - Y)` is the explicit spelling)."""
        from .constraints import PSD

        other = as_expression(other)
        return PSD(self if _is_zero(other) else self - other)

    def __lshift__(self, other):
        """X << Y: Y - X is positive semidefinite."""
        from .constraints import PSD

        other = as_expression(other)
        return PSD(other if _is_zero(self) else other - self)

    def __rrshift__(self, other):
        # `other >> self` with a non-Expression lhs (e.g. `0 >> X`)
        return self.__lshift__(other)

    def __rlshift__(self, other):
        # `other << self` (e.g. `0 << X`)
        return self.__rshift__(other)

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------------ misc

    def __repr__(self):
        return f"{type(self).__name__}(shape={self.shape})"

    @property
    def value(self):
        """Numeric value for constant expressions (None otherwise)."""
        return None


def as_expression(x) -> Expression:
    from .leaf import Constant

    if isinstance(x, Expression):
        return x
    return Constant(np.asarray(x, dtype=np.float64))


def broadcast_shapes_add(s1, s2):
    """Shape of s1 + s2 with numpy-style broadcasting."""
    try:
        return tuple(np.broadcast_shapes(s1, s2))
    except ValueError:
        raise ValueError(f"incompatible shapes for addition: {s1} and {s2}")
