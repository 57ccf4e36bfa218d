"""Atom base class: generic DCP curvature composition.

Each atom declares its own convexity/concavity and per-argument monotonicity
(possibly sign-dependent); `curvature()` applies the standard DCP composition
rule. Canonicalization is per-atom via `canon(ctx, arg_reps)` where ctx is a
`cvxpylayers_tpu.canon.canonicalizer.Canonicalizer` and arg_reps are the
arguments' TensorReps (affine over global columns).
"""

from __future__ import annotations

from ..expression import Curvature, Expression, Sign


class Atom(Expression):
    def __init__(self, *args):
        self.args = tuple(args)
        self.shape = self.shape_from_args()
        self.validate()

    # ------------------------------------------------------------- overrides

    def shape_from_args(self):
        raise NotImplementedError

    def validate(self):
        pass

    def is_atom_convex(self) -> bool:
        raise NotImplementedError

    def is_atom_concave(self) -> bool:
        raise NotImplementedError

    def is_atom_affine(self) -> bool:
        return self.is_atom_convex() and self.is_atom_concave()

    def is_incr(self, i: int) -> bool:
        """Nondecreasing in argument i (given the actual args' signs)."""
        return False

    def is_decr(self, i: int) -> bool:
        return False

    def sign(self) -> Sign:
        return Sign.UNKNOWN

    def canon(self, ctx, arg_reps):
        raise NotImplementedError(f"{type(self).__name__}.canon")

    @property
    def value(self):
        """Numeric value from the arguments' values (cvxpy post-solve
        API). Affine/gp atoms override with their own properties; the
        rest evaluate through atoms/numeric.py. None when any leaf has
        no value."""
        from . import numeric

        return numeric.atom_value(self)

    # --------------------------------------------------------- DCP machinery

    def curvature(self) -> Curvature:
        argc = [a.curvature() for a in self.args]
        if all(c is Curvature.CONSTANT for c in argc):
            return Curvature.CONSTANT

        def comp_ok(convex: bool) -> bool:
            atom_ok = self.is_atom_convex() if convex else self.is_atom_concave()
            if not atom_ok:
                return False
            for i, c in enumerate(argc):
                if c.is_affine():
                    continue
                want_cvx = convex == self.is_incr(i)
                # argument must be convex if (checking convex and incr) or
                # (checking concave and decr); mirrored otherwise
                if convex:
                    ok = (self.is_incr(i) and c.is_convex()) or (
                        self.is_decr(i) and c.is_concave()
                    )
                else:
                    ok = (self.is_incr(i) and c.is_concave()) or (
                        self.is_decr(i) and c.is_convex()
                    )
                del want_cvx
                if not ok:
                    return False
            return True

        cvx = comp_ok(True)
        ccv = comp_ok(False)
        if cvx and ccv:
            return Curvature.AFFINE
        if cvx:
            return Curvature.CONVEX
        if ccv:
            return Curvature.CONCAVE
        return Curvature.UNKNOWN
