"""Constraint objects.

Sign/dual conventions (calibrated to match the reference's cvxpy-style
duals, cvxpylayers tests/test_dual_variables.py):
  * Equality lhs == rhs: cone row block s = rhs - lhs in Zero; the free dual
    y enters the Lagrangian as y'(lhs - rhs).
  * Inequality lhs <= rhs: s = rhs - lhs in NonNeg; dual y >= 0 multiplies
    (lhs - rhs).
  * SOC(t, X): ||X||_2 <= t.
  * ExpCone(x, y, z): y e^{x/y} <= z (elementwise triples).
  * PSD(X): X symmetric PSD; dual returned as a symmetric matrix.
  * PowCone3D(x, y, z, alpha): x^alpha y^(1-alpha) >= |z|.
"""

from __future__ import annotations

import itertools

import numpy as np

from .expression import Expression, as_expression

_constraint_counter = itertools.count()


class DualVariable:
    """Handle for (one part of) a constraint's dual variable — pass it in
    a CvxpyLayer's `variables` list to have the dual returned (reference
    API: constraint.dual_variables[i], cvxpylayers
    tests/test_dual_variables.py:28,807-974). Cone constraints expose the
    reference's multi-part structure: SOC has parts (t-dual, X-dual);
    ExpCone/PowCone3D have parts (x-dual, y-dual, z-dual)."""

    def __init__(self, constraint: "Constraint", part: int = 0):
        self.constraint = constraint
        self.part = int(part)
        #: populated by Problem.solve() (cvxpy-style plain-solve path)
        self.value = None

    def __repr__(self):
        return f"DualVariable(of={self.constraint!r}, part={self.part})"


class Constraint:
    N_DUAL_PARTS = 1

    def __init__(self, args):
        self.args = tuple(args)
        self.id = next(_constraint_counter)
        self._dual_vars = [
            DualVariable(self, k) for k in range(self.N_DUAL_PARTS)
        ]

    @property
    def dual_variables(self):
        return list(self._dual_vars)

    @property
    def dual_value(self):
        """First dual part's value after Problem.solve() (cvxpy API);
        multi-part cone constraints expose the rest via dual_values."""
        return self._dual_vars[0].value

    @property
    def dual_values(self):
        return [d.value for d in self._dual_vars]

    def violation(self):
        """Numeric constraint violation at the current leaf values
        (cvxpy API): 0 iff satisfied; None if values are missing."""
        r = self.residual
        return None if r is None else np.max(np.abs(np.asarray(r)))

    @property
    def residual(self):
        raise NotImplementedError

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

    def is_dcp(self) -> bool:
        raise NotImplementedError

    def _dpp_ok(self) -> bool:
        return all(a._dpp_ok() for a in self.args)

    def __bool__(self):
        raise TypeError(
            "A constraint has no truth value; use it in Problem(constraints=[...])."
        )

    def __hash__(self):
        return id(self)


class Equality(Constraint):
    def __init__(self, lhs: Expression, rhs: Expression):
        super().__init__([lhs, rhs])

    def is_dcp(self) -> bool:
        return self.args[0].is_affine() and self.args[1].is_affine()

    @property
    def residual(self):
        a, b = self.args[0].value, self.args[1].value
        if a is None or b is None:
            return None
        return np.abs(np.asarray(a, float) - np.asarray(b, float))

    @property
    def shape(self):
        from .expression import broadcast_shapes_add

        return broadcast_shapes_add(self.args[0].shape, self.args[1].shape)

    def __repr__(self):
        return f"Equality({self.args[0]} == {self.args[1]})"


class Inequality(Constraint):
    """lhs <= rhs."""

    def __init__(self, lhs: Expression, rhs: Expression):
        super().__init__([lhs, rhs])

    def is_dcp(self) -> bool:
        return self.args[0].is_convex() and self.args[1].is_concave()

    @property
    def residual(self):
        a, b = self.args[0].value, self.args[1].value
        if a is None or b is None:
            return None
        return np.maximum(
            np.asarray(a, float) - np.asarray(b, float), 0.0
        )

    @property
    def shape(self):
        from .expression import broadcast_shapes_add

        return broadcast_shapes_add(self.args[0].shape, self.args[1].shape)

    def __repr__(self):
        return f"Inequality({self.args[0]} <= {self.args[1]})"


class SOC(Constraint):
    """||X||_2 <= t, t scalar affine, X affine (flattened).

    dual_variables: [t-dual (scalar), X-dual (X's shape)]."""

    N_DUAL_PARTS = 2

    def __init__(self, t, X):
        t = as_expression(t)
        X = as_expression(X)
        if not t.is_scalar():
            raise ValueError("SOC t must be scalar")
        super().__init__([t, X])

    def is_dcp(self) -> bool:
        return all(a.is_affine() for a in self.args)

    @property
    def residual(self):
        t, X = self.args[0].value, self.args[1].value
        if t is None or X is None:
            return None
        return np.maximum(
            np.linalg.norm(np.asarray(X, float).ravel()) - float(t), 0.0
        )

    def __repr__(self):
        return f"SOC(t={self.args[0]}, X={self.args[1]})"


class ExpCone(Constraint):
    """(x, y, z) in Kexp elementwise: y e^(x/y) <= z.

    dual_variables: [x-dual, y-dual, z-dual] (each argument-shaped)."""

    N_DUAL_PARTS = 3

    def __init__(self, x, y, z):
        x, y, z = (as_expression(a) for a in (x, y, z))
        if not (x.shape == y.shape == z.shape):
            raise ValueError("ExpCone arguments must share a shape")
        super().__init__([x, y, z])

    def is_dcp(self) -> bool:
        return all(a.is_affine() for a in self.args)

    @property
    def residual(self):
        raise NotImplementedError(
            "ExpCone.residual needs the exponential-cone projection, which "
            "arrives with the general-cone later port slice"
        )


class PSD(Constraint):
    """X >> 0 for a square affine expression (symmetrized)."""

    def __init__(self, X):
        X = as_expression(X)
        if X.ndim != 2 or X.shape[0] != X.shape[1]:
            raise ValueError("PSD constraint needs a square matrix")
        super().__init__([X])

    def is_dcp(self) -> bool:
        return self.args[0].is_affine()

    @property
    def residual(self):
        X = self.args[0].value
        if X is None:
            return None
        X = np.asarray(X, float)
        lmin = np.linalg.eigvalsh(0.5 * (X + X.T)).min()
        return np.maximum(-lmin, 0.0)


class PowCone3D(Constraint):
    """(x, y, z) with x^alpha y^(1-alpha) >= |z| elementwise.

    dual_variables: [x-dual, y-dual, z-dual] (each argument-shaped)."""

    N_DUAL_PARTS = 3

    def __init__(self, x, y, z, alpha):
        x, y, z = (as_expression(a) for a in (x, y, z))
        if not (x.shape == y.shape == z.shape):
            raise ValueError("PowCone3D arguments must share a shape")
        self.alpha = np.broadcast_to(
            np.asarray(alpha, dtype=np.float64), x.shape if x.shape else ()
        ).reshape(-1)
        super().__init__([x, y, z])

    def is_dcp(self) -> bool:
        return all(a.is_affine() for a in self.args)

    @property
    def residual(self):
        raise NotImplementedError(
            "PowCone3D.residual needs the power-cone projection, which "
            "arrives with the general-cone later port slice"
        )


class NonNeg(Constraint):
    """x >= 0."""

    def __init__(self, x):
        super().__init__([as_expression(x)])

    def is_dcp(self) -> bool:
        return self.args[0].is_affine()

    @property
    def residual(self):
        v = self.args[0].value
        if v is None:
            return None
        return np.maximum(-np.asarray(v, float), 0.0)
