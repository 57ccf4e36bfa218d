"""Numeric evaluation of atoms — the post-solve `expr.value` surface.

cvxpy users evaluate arbitrary expressions after a solve
(`(A @ x - b).value`, `cp.norm(x).value`); each rule here mirrors the
atom's mathematical definition with plain numpy. Atoms with their own
`value` property (most affine/gp ones) are untouched; `Atom.value`
(base.py) falls back to this table. A missing leaf value propagates as
None, matching cvxpy.
"""

from __future__ import annotations

import functools

import numpy as np


def _eig_desc(v):
    return np.sort(np.linalg.eigvalsh(np.atleast_2d(v)))[::-1]


def _entr(v):
    v = np.asarray(v, float)
    out = np.where(v > 0, -v * np.log(np.where(v > 0, v, 1.0)), 0.0)
    return np.where(v < 0, -np.inf, out)


def _huber(e, vals):
    v = vals[0]
    a = np.abs(v)
    return np.where(a <= e.M, v * v, e.M * (2 * a - e.M))


def _pnorm(e, vals):
    v = vals[0]
    f = np.abs(np.asarray(v, float).ravel()) if e.p > 1 else np.asarray(
        v, float).ravel()
    return np.power(np.power(f, e.p).sum(), 1.0 / e.p)


def _dotsort(e, vals):
    x = np.sort(np.asarray(vals[0], float).ravel())
    w = np.zeros_like(x)
    w[: e.w.size] = e.w
    return float(x @ np.sort(w))


def _perspective(e, vals):
    # persp(f, s) = s * f(x/s): evaluate f with its variables scaled by
    # 1/s (temporarily — values are restored). Defined for s > 0; the
    # s = 0 closure (recession function) is not evaluated numerically.
    f, s_expr = e.args
    s = vals[1]
    if s is None or float(s) <= 0:
        return None
    s = float(s)
    fvars = f.variables()
    saved = [v.value for v in fvars]
    if any(sv is None for sv in saved):
        return None
    try:
        for v, sv in zip(fvars, saved):
            v.value = np.asarray(sv, float) / s
        inner = f.value
    finally:
        for v, sv in zip(fvars, saved):
            v.value = sv
    if inner is None:
        return None
    return s * np.asarray(inner, float)


EVALUATORS = {
    # ---- nonlinear elementwise / reductions
    "Abs": lambda e, v: np.abs(v[0]),
    "Pos": lambda e, v: np.maximum(v[0], 0.0),
    "Square": lambda e, v: np.square(v[0]),
    "Exp": lambda e, v: np.exp(v[0]),
    "Log": lambda e, v: np.log(v[0]),
    "Entr": lambda e, v: _entr(v[0]),
    "RelEntr": lambda e, v: np.asarray(v[0], float)
    * np.log(np.asarray(v[0], float) / np.asarray(v[1], float)),
    "Logistic": lambda e, v: np.logaddexp(0.0, v[0]),
    "InvPos": lambda e, v: 1.0 / np.asarray(v[0], float),
    "Sqrt": lambda e, v: np.sqrt(v[0]),
    "Huber": _huber,
    "Norm1": lambda e, v: np.abs(v[0]).sum(),
    "Norm2": lambda e, v: float(np.linalg.norm(np.asarray(v[0]).ravel())),
    "NormInf": lambda e, v: np.abs(v[0]).max(),
    "SumSquares": lambda e, v: float(np.square(v[0]).sum()),
    "QuadOverLin": lambda e, v: float(np.square(v[0]).sum() / v[1]),
    "QuadFormParam": lambda e, v: float(
        np.asarray(v[0]).ravel()
        @ np.atleast_2d(v[1])
        @ np.asarray(v[0]).ravel()
    ),
    "Maximum": lambda e, v: functools.reduce(np.maximum, v),
    "Minimum": lambda e, v: functools.reduce(np.minimum, v),
    "PnormGeneral": _pnorm,
    # ---- spectral / matrix
    "LambdaMax": lambda e, v: float(_eig_desc(v[0])[0]),
    "LambdaMin": lambda e, v: float(_eig_desc(v[0])[-1]),
    "MatrixFrac": lambda e, v: float(
        np.asarray(v[0]).ravel()
        @ np.linalg.solve(np.atleast_2d(v[1]), np.asarray(v[0]).ravel())
    ),
    "SigmaMax": lambda e, v: float(np.linalg.svd(
        np.atleast_2d(v[0]), compute_uv=False)[0]),
    "LogDet": lambda e, v: (lambda sg, ld: float(ld) if sg > 0
                            else -np.inf)(
        *np.linalg.slogdet(np.atleast_2d(v[0]))),
    "NormNuc": lambda e, v: float(np.linalg.svd(
        np.atleast_2d(v[0]), compute_uv=False).sum()),
    "LambdaSumLargest": lambda e, v: float(_eig_desc(v[0])[: e.k].sum()),
    # ---- structured
    "SumLargest": lambda e, v: float(
        np.sort(np.asarray(v[0], float).ravel())[::-1][: e.k].sum()
    ),
    "Dotsort": _dotsort,
    "HarmonicMean": lambda e, v: float(
        np.asarray(v[0]).size / (1.0 / np.asarray(v[0], float)).sum()
    ),
    "SumGroupNorm2": lambda e, v: float(
        np.sqrt(sum(np.square(np.asarray(x, float)) for x in v)).sum()
    ),
    # ---- gp
    "LogAddExp": lambda e, v: np.logaddexp(v[0], v[1]),
}

def _suppfunc(e, vals):
    # sup_{y in S} <x, y>: one plain inner solve over the set variable
    x = vals[0]
    if x is None:
        return None
    from ..problem import Maximize, Problem
    from .affine import ScalarMul, Sum
    from .affine import Multiply  # noqa: F401 (vector/matrix dispatch)

    xv = np.asarray(x, float)
    from ..expression import as_expression

    obj = Sum(Multiply(as_expression(xv), e._y)) if xv.ndim else ScalarMul(
        as_expression(float(xv)), e._y
    )
    inner = Problem(Maximize(obj), list(e._constraints))
    val = inner.solve()
    return None if val is None else np.asarray(val, float)


def _partial_optimize(e, vals):
    # inf/sup over the bound variables with the outer variables pinned
    # at their current values (cvxpy partial_optimize numeric)
    del vals
    if any(v.value is None for v in e._outer_vars):
        return None
    from ..problem import Problem

    cons = list(e._prob.constraints)
    for v in e._outer_vars:
        cons.append(v == np.asarray(v.value, float))
    inner = Problem(e._prob.objective, cons)
    val = inner.solve()
    return None if val is None else np.asarray(val, float)


# rules that need the raw (possibly-None) values / expression internals
_SPECIAL = {
    "Perspective": _perspective,
    "SuppFunc": _suppfunc,
    "PartialOptimize": _partial_optimize,
}


def atom_value(expr):
    name = type(expr).__name__
    sp = _SPECIAL.get(name)
    if sp is not None:
        return sp(expr, [a.value for a in expr.args])
    fn = EVALUATORS.get(name)
    if fn is None:
        return None
    vals = [a.value for a in expr.args]
    if any(v is None for v in vals):
        return None
    vals = [np.asarray(v, dtype=np.float64) for v in vals]
    out = fn(expr, vals)
    return None if out is None else np.asarray(out, dtype=np.float64)
