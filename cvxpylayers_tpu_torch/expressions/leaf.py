"""Leaf expressions: Variable, Parameter, Constant.

API mirrors the reference's user surface (cvxpy Variable/Parameter as used in
cvxpylayers README.md:84-101 and the test corpus): shapes up to 2-D,
attribute flags nonneg/nonpos/symmetric/PSD/pos, and Parameter.value for
eager evaluation in tests.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np

from .expression import Curvature, Expression, Sign

_leaf_counter = itertools.count()


def _canon_shape(shape) -> Tuple[int, ...]:
    if shape is None:
        return ()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    shape = tuple(int(s) for s in shape)
    # N-D (>2) leaves are supported for the elementwise/sum/reshape/
    # indexing surface (everything canonicalizes over flattened reps);
    # matrix-structured atoms (matmul, trace, PSD, ...) validate their
    # own 2-D requirements.
    return shape


class Leaf(Expression):
    args: Tuple[Expression, ...] = ()

    def __init__(self, shape, name: Optional[str]):
        self.shape = _canon_shape(shape)
        self.id = next(_leaf_counter)
        self.name = name or f"{type(self).__name__.lower()}{self.id}"

    def __repr__(self):
        return f"{type(self).__name__}({self.name}, shape={self.shape})"


class Variable(Leaf):
    """Decision variable.

    Attribute flags:
      nonneg / nonpos: implicit sign constraint added at problem canon.
      symmetric:       square matrix variable restricted to symmetric values;
                       canonicalized in svec coordinates (s(s+1)/2 columns).
      PSD:             symmetric + an implicit PSD cone constraint.
    """

    def __init__(self, shape=(), name=None, *, nonneg=False, nonpos=False,
                 symmetric=False, PSD=False, pos=False, neg=False):
        super().__init__(shape, name)
        if PSD:
            symmetric = True
        if symmetric:
            if len(self.shape) != 2 or self.shape[0] != self.shape[1]:
                raise ValueError("symmetric/PSD variables must be square")
        if nonneg and nonpos:
            raise ValueError("variable cannot be both nonneg and nonpos")
        self.nonneg = bool(nonneg or pos)
        self.nonpos = bool(nonpos or neg)
        self.symmetric = bool(symmetric)
        self.PSD = bool(PSD)
        self._value = None  # populated by Problem.solve()

    @property
    def value(self):
        """Solution value after Problem.solve() (cvxpy API)."""
        return self._value

    @value.setter
    def value(self, v):
        self._value = None if v is None else np.asarray(v, dtype=np.float64)

    def variables(self):
        return [self]

    def parameters(self):
        return []

    def curvature(self) -> Curvature:
        return Curvature.AFFINE

    def sign(self) -> Sign:
        if self.nonneg:
            return Sign.NONNEG
        if self.nonpos:
            return Sign.NONPOS
        return Sign.UNKNOWN


class Parameter(Leaf):
    """Problem parameter — an input of the compiled layer.

    `pos=True`/`nonneg=True` mark sign (needed for DGP and for sign-dependent
    DCP monotonicity); `value` supports eager evaluation outside the layer.
    """

    def __init__(self, shape=(), name=None, *, nonneg=False, nonpos=False,
                 pos=False, neg=False, PSD=False, value=None):
        super().__init__(shape, name)
        if PSD and (len(self.shape) != 2 or self.shape[0] != self.shape[1]):
            raise ValueError("PSD parameters must be square matrices")
        self.PSD = bool(PSD)
        self.pos = bool(pos)
        self.neg = bool(neg)
        self.nonneg = bool(nonneg or pos)
        self.nonpos = bool(nonpos or neg)
        self._value = None
        if value is not None:
            self.value = value

    def variables(self):
        return []

    def parameters(self):
        return [self]

    def curvature(self) -> Curvature:
        return Curvature.CONSTANT

    def sign(self) -> Sign:
        if self.nonneg:
            return Sign.NONNEG
        if self.nonpos:
            return Sign.NONPOS
        return Sign.UNKNOWN

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        v = np.asarray(v, dtype=np.float64)
        if v.shape != self.shape:
            raise ValueError(
                f"parameter {self.name} expects shape {self.shape}, got {v.shape}"
            )
        self._value = v


class Constant(Expression):
    args: Tuple[Expression, ...] = ()

    def __init__(self, value):
        v = np.asarray(value, dtype=np.float64)
        self._value = v
        self.shape = v.shape

    def variables(self):
        return []

    def parameters(self):
        return []

    def curvature(self) -> Curvature:
        return Curvature.CONSTANT

    def sign(self) -> Sign:
        if np.all(self._value == 0):
            return Sign.ZERO
        if np.all(self._value >= 0):
            return Sign.NONNEG
        if np.all(self._value <= 0):
            return Sign.NONPOS
        return Sign.UNKNOWN

    @property
    def value(self):
        return self._value

    def __repr__(self):
        return f"Constant(shape={self.shape})"
