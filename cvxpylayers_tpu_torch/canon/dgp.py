"""Dgp2Dcp: log-log (geometric programming) problems -> DCP problems.

The reference delegates this to cvxpy's Dgp2Dcp reduction and keeps a
param -> log-param map (cvxpylayers utils/parse_args.py:437-453,
torch/cvxpylayer.py:58-81): positive parameters are log()-ed on the way in,
primal variables exp()-ed on the way out, duals pass through. This module
is the from-scratch equivalent: it rebuilds the expression DAG in log
space.

Transform rules (T = log of the positive expression):
  Variable(pos)            -> fresh unconstrained Variable
  Parameter(pos)           -> fresh Parameter, mask "log this input"
  Parameter (exponent use) -> passed through raw (PowerParam only)
  Constant c > 0           -> Constant(log c)
  a * b, a / b             -> T(a) + T(b), T(a) - T(b)
  x ** p (float p)         -> p * T(x)
  x ** c (param c)         -> c * T(x)   (DPP: param times var-affine)
  a + b (posynomial)       -> logaddexp(T(a), T(b))
  sum(x)                   -> log_sum_exp(T(x))
  maximum / max            -> maximum / max of transforms
  minimum / min            -> minimum / min (log-log concave side)
  sqrt/square/inv_pos      -> 0.5*T, 2*T, -T
  geo_mean(x)              -> mean(T(x))
  lhs <= rhs               -> T(lhs) <= T(rhs)
  lhs == rhs               -> T(lhs) == T(rhs)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..expressions import constraints as cons
from ..expressions.atoms import affine as aff
from ..expressions.atoms import gp as gpat
from ..expressions.atoms import nonlinear as nl
from ..expressions.expression import Expression
from ..expressions.leaf import Constant, Parameter, Variable
from ..expressions.problem import Maximize, Minimize, Problem


class DgpError(ValueError):
    pass


class Dgp2Dcp:
    def __init__(self):
        self.var_map: Dict[int, Variable] = {}
        self.param_map: Dict[int, Tuple[Parameter, bool]] = {}  # id -> (new, logged)
        self._cache: Dict[int, Expression] = {}

    def transform_problem(self, problem: Problem) -> Problem:
        obj_expr = self.transform(problem.objective.expr)
        objective = (
            Minimize(obj_expr)
            if isinstance(problem.objective, Minimize)
            else Maximize(obj_expr)
        )
        constraints = []
        for c in problem.constraints:
            constraints.append(self.transform_constraint(c))
        return Problem(objective, constraints)

    def transform_constraint(self, c: cons.Constraint) -> cons.Constraint:
        if isinstance(c, cons.Inequality):
            lhs = self.transform(c.args[0])
            rhs = self.transform(c.args[1])
            out = cons.Inequality(lhs, rhs)
        elif isinstance(c, cons.Equality):
            lhs = self.transform(c.args[0])
            rhs = self.transform(c.args[1])
            out = cons.Equality(lhs, rhs)
        else:
            raise DgpError(
                f"constraint type {type(c).__name__} is not supported under "
                "gp=True"
            )
        return out

    # ------------------------------------------------------------- expression

    def transform(self, e: Expression) -> Expression:
        key = id(e)
        if key in self._cache:
            return self._cache[key]
        out = self._transform(e)
        self._cache[key] = out
        return out

    def _transform(self, e: Expression) -> Expression:
        if isinstance(e, Variable):
            if not e.nonneg:
                raise DgpError(
                    f"variable {e.name} must be declared pos=True for gp=True"
                )
            if id(e) not in self.var_map:
                self.var_map[id(e)] = Variable(e.shape, name=f"log_{e.name}")
            return self.var_map[id(e)]
        if isinstance(e, Parameter):
            if id(e) not in self.param_map:
                if not e.nonneg:
                    raise DgpError(
                        f"parameter {e.name} appears multiplicatively but is "
                        "not pos=True"
                    )
                self.param_map[id(e)] = (
                    Parameter(e.shape, name=f"log_{e.name}"), True
                )
            return self.param_map[id(e)][0]
        if isinstance(e, Constant):
            v = np.asarray(e.value, dtype=np.float64)
            if np.any(v <= 0):
                raise DgpError("constants must be positive under gp=True")
            return Constant(np.log(v))

        a = e.args
        if isinstance(e, (aff.ScalarMul, aff.Multiply)):
            return self.transform(a[0]) + self.transform(a[1])
        if isinstance(e, gpat.DivExpression):
            return self.transform(a[0]) - self.transform(a[1])
        if isinstance(e, gpat.PowerParam):
            base = self.transform(a[0])
            pexp = a[1]
            if not isinstance(pexp, Parameter):
                raise DgpError("exponent must be a Parameter or a number")
            if id(pexp) not in self.param_map:
                # exponents enter raw (no log); any sign allowed
                self.param_map[id(pexp)] = (
                    Parameter(pexp.shape, name=f"raw_{pexp.name}"), False
                )
            newp, logged = self.param_map[id(pexp)]
            if logged:
                raise DgpError(
                    f"parameter {pexp.name} is used both multiplicatively "
                    "and as an exponent; that mixture is not supported"
                )
            return newp * base
        if isinstance(e, nl.Power):
            return float(e.p) * self.transform(a[0])
        if isinstance(e, nl.Square):
            return 2.0 * self.transform(a[0])
        if isinstance(e, nl.Sqrt):
            return 0.5 * self.transform(a[0])
        if isinstance(e, nl.InvPos):
            return -self.transform(a[0])
        if isinstance(e, aff.AddExpression):
            return gpat.LogAddExp(self.transform(a[0]), self.transform(a[1]))
        if isinstance(e, aff.Sum):
            return nl.log_sum_exp(
                self.transform(a[0]), axis=e.axis, keepdims=e.keepdims
            )
        if isinstance(e, nl.Maximum):
            return nl.maximum(*[self.transform(x) for x in a])
        if isinstance(e, nl.Minimum):
            return nl.minimum(*[self.transform(x) for x in a])
        if isinstance(e, nl.MaxEntries):
            return nl.max(self.transform(a[0]), axis=e.axis,
                          keepdims=e.keepdims)
        if isinstance(e, nl.MinEntries):
            return nl.min(self.transform(a[0]), axis=e.axis,
                          keepdims=e.keepdims)
        if isinstance(e, gpat.Prod):
            return aff.Sum(self.transform(a[0]))
        if isinstance(e, gpat.GMatMul):
            return Constant(e.A) @ self.transform(a[0])
        if isinstance(e, gpat.OneMinusPos):
            return gpat.LogOneMinusExp(self.transform(a[0]))
        if isinstance(e, gpat.PfEigenvalue):
            return gpat.LogPfEig(self.transform(a[0]))
        if isinstance(e, gpat.EyeMinusInv):
            return gpat.LogEyeMinusInv(self.transform(a[0]))
        if isinstance(e, nl.XExp):
            # log(x e^x) = log x + x = t + e^t (log-log convex)
            t = self.transform(a[0])
            return t + nl.exp(t)
        if isinstance(e, nl.Exp):
            # log(e^x) = x = e^t (log-log convex)
            return nl.exp(self.transform(a[0]))
        if isinstance(e, nl.Log):
            # log(log x) = log t on t > 0, i.e. x > 1 (log-log concave)
            return nl.log(self.transform(a[0]))
        if isinstance(e, nl.QuadOverLin):
            # log(sum x_i^2 / y) = LSE(2 t_x) - t_y (log-log convex)
            tx = self.transform(a[0])
            ty = self.transform(a[1])
            return nl.log_sum_exp(2.0 * tx) - ty
        if isinstance(e, nl.Norm2):
            return 0.5 * nl.log_sum_exp(2.0 * self.transform(a[0]))
        if isinstance(e, nl.PnormGeneral):
            p = float(e.p)
            if p <= 0:
                raise DgpError("pnorm under gp=True needs p > 0")
            return (1.0 / p) * nl.log_sum_exp(p * self.transform(a[0]))
        if isinstance(e, nl.GeoMean):
            t = self.transform(a[0])
            n = a[0].size
            return aff.Sum(t) * (1.0 / n)
        if isinstance(e, nl.Norm1):
            return nl.log_sum_exp(self.transform(a[0]))
        if isinstance(e, nl.NormInf):
            return nl.max(self.transform(a[0]))
        if isinstance(e, (aff.Index, aff.Reshape, aff.Transpose)):
            # positional atoms commute with elementwise log
            inner = self.transform(a[0])
            if isinstance(e, aff.Index):
                return aff.Index(inner, e.key)
            if isinstance(e, aff.Reshape):
                return aff.Reshape(inner, e.shape)
            return aff.Transpose(inner)
        if isinstance(e, aff.Hstack):
            return aff.Hstack(*[self.transform(x) for x in a])
        if isinstance(e, aff.Vstack):
            return aff.Vstack(*[self.transform(x) for x in a])
        raise DgpError(
            f"atom {type(e).__name__} is not log-log convex (DGP) or not "
            "supported under gp=True"
        )


def is_dgp(problem: Problem) -> bool:
    try:
        t = Dgp2Dcp()
        dcp = t.transform_problem(problem)
    except DgpError:
        return False
    return dcp.is_dcp()
