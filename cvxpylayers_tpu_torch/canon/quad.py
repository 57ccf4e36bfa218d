"""Quadratic-objective extraction: route sum_squares / quad_form objective
terms into the native P matrix of min (1/2)x'Px + q'x instead of SOC
epigraphs.

This is the parity feature behind the reference's QP-capable backends and
its _quad_form_dpp patch (cvxpylayers _quad_form_dpp.py: parametric
quad_form allowed in the objective for MOREAU/CUCLARABEL/MPAX), and a
performance feature here: projection layers (sum_squares(x - v)) become
pure small-cone QPs.

Extractable patterns (walked through +, -, and scalar multiplications):
  c * sum_squares(affine)   with param-free variable coefficients V:
        P += 2c V'V, q += 2c V'c0 (c0 the param-affine offset),
        offset += c*c0'c0 when c0 is param-free (else dropped, flagged)
  gamma_param * sum_squares(affine) with fully param-free affine:
        P entries carry gamma's parameter column
  c * quad_form(x_affine_paramfree, P_parameter):
        P += 2c * V' P_param V  (entries carry P_param's columns)
Everything else stays in the epigraph pipeline (still correct, just conic).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..expressions.atoms import affine as aff
from ..expressions.atoms import nonlinear as nl
from ..expressions.leaf import Parameter
from .tensor_rep import CONST, TensorRep


class QuadAccumulator:
    """Collects P-matrix entries: (i, j, param_col, val) with x'Px/2
    convention (so quad_form contributes 2x its matrix)."""

    def __init__(self):
        self.pi: List[np.ndarray] = []
        self.pj: List[np.ndarray] = []
        self.pp: List[np.ndarray] = []
        self.pv: List[np.ndarray] = []
        self.q_extra: List[TensorRep] = []  # scalar (1-row) objective reps
        self.offset_exact = True

    def add_entries(self, i, j, p, v):
        self.pi.append(np.asarray(i, dtype=np.int64))
        self.pj.append(np.asarray(j, dtype=np.int64))
        self.pp.append(np.asarray(p, dtype=np.int64))
        self.pv.append(np.asarray(v, dtype=np.float64))

    def concat(self):
        if not self.pi:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy(), np.zeros(0)
        return (
            np.concatenate(self.pi),
            np.concatenate(self.pj),
            np.concatenate(self.pp),
            np.concatenate(self.pv),
        )


def _const_scalar(e) -> float | None:
    """Value of a parameter-free scalar constant expression, else None."""
    if e.has_var() or e.has_param() or not e.is_scalar():
        return None
    v = e.value
    return None if v is None else float(np.asarray(v).reshape(()))


def _pure_param_scalar(canon, e):
    """(weight, param_col) if e is exactly w * p for one scalar parameter,
    else None."""
    if e.has_var() or not e.has_param() or not e.is_scalar():
        return None
    rep = canon.rep_of(e)
    if rep.nnz != 1 or rep.var_cols[0] != CONST or rep.param_cols[0] == CONST:
        return None
    return float(rep.vals[0]), int(rep.param_cols[0])


def _split_rep(rep: TensorRep):
    """Split an affine rep into variable part entries and offset entries."""
    is_var = rep.var_cols != CONST
    V = (rep.rows[is_var], rep.var_cols[is_var], rep.param_cols[is_var],
         rep.vals[is_var])
    C = (rep.rows[~is_var], rep.param_cols[~is_var], rep.vals[~is_var])
    return V, C


def try_extract(canon, expr, acc: QuadAccumulator,
                cval: float = 1.0, cparam: int = CONST) -> bool:
    """Walk `expr`; on success the quadratic terms are accumulated and True
    is returned. Returns False when `expr` must go through epigraph canon."""
    if isinstance(expr, aff.AddExpression) and expr.is_scalar():
        # speculative: try both arms; on any failure the caller re-canons
        # the whole expr, so keep a checkpoint to roll back
        state = _checkpoint(acc)
        if try_extract(canon, expr.args[0], acc, cval, cparam) and \
           try_extract(canon, expr.args[1], acc, cval, cparam):
            return True
        _rollback(acc, state)
        return False
    if isinstance(expr, aff.NegExpression):
        return try_extract(canon, expr.args[0], acc, -cval, cparam)
    if isinstance(expr, aff.ScalarMul):
        a, b = expr.args
        for scal, other in ((a, b), (b, a)):
            c = _const_scalar(scal)
            if c is not None:
                return try_extract(canon, other, acc, cval * c, cparam)
        if cparam == CONST:
            for scal, other in ((a, b), (b, a)):
                ps = _pure_param_scalar(canon, scal)
                if ps is not None and not other.has_param():
                    w, pc = ps
                    return try_extract(canon, other, acc, cval * w, pc)
        return False
    if expr.is_affine():
        rep = canon.rep_of(expr)
        if cparam != CONST and np.any(rep.param_cols != CONST):
            return False  # param x param
        params = (
            np.full(rep.nnz, cparam, dtype=np.int64)
            if cparam != CONST else rep.param_cols
        )
        acc.q_extra.append(TensorRep(
            1, np.zeros(rep.nnz, dtype=np.int64), rep.var_cols, params,
            cval * rep.vals,
        ))
        return True
    if (
        isinstance(expr, aff.Sum)
        and expr.axis is None
        and isinstance(expr.args[0], nl.Square)
    ):
        # sum(square(e)) == sum_squares(e): route through the same path
        expr = nl.SumSquares(expr.args[0].args[0])
    if isinstance(expr, nl.SumSquares):
        if cval < 0:
            return False
        rep = canon.rep_of(expr.args[0])
        (vr, vc, vp, vv), (cr, cp, cvals) = _split_rep(rep)
        if np.any(vp != CONST):
            return False  # parameter-dependent variable coefficients
        if cparam != CONST and np.any(cp != CONST):
            return False  # would create param x param terms
        from .tensor_rep import join_pairs

        # P += 2 cval V'V: join V entries on their row index
        left, right = join_pairs(vr, vr)
        acc.add_entries(
            vc[left], vc[right],
            np.full(left.size, cparam, dtype=np.int64),
            2.0 * cval * vv[left] * vv[right],
        )
        # q += 2 cval V'c0 (join on row)
        if cr.size and vr.size:
            lv, rc = join_pairs(vr, cr)
            param_out = np.where(
                cparam != CONST, cparam, cp[rc]
            ).astype(np.int64)
            acc.q_extra.append(TensorRep(
                1,
                np.zeros(lv.size, dtype=np.int64),
                vc[lv],
                param_out,
                2.0 * cval * vv[lv] * cvals[rc],
            ))
        # offset cval * c0'c0
        if cr.size:
            if np.all(cp == CONST) and cparam == CONST:
                val = cval * float(np.sum(
                    np.bincount(cr, weights=cvals) ** 2
                ))
                acc.q_extra.append(TensorRep(
                    1, np.zeros(1, dtype=np.int64),
                    np.full(1, CONST, dtype=np.int64),
                    np.full(1, CONST, dtype=np.int64),
                    np.array([val]),
                ))
            else:
                acc.offset_exact = False
        return True
    if isinstance(expr, nl.QuadFormParam):
        if cval < 0 or cparam != CONST:
            return False
        x_e, P_e = expr.args
        rep = canon.rep_of(x_e)
        (vr, vc, vp, vv), (cr, cp, cvals) = _split_rep(rep)
        if np.any(vp != CONST) or cr.size:
            # x must be param-free; affine offsets in x would put parameter
            # products into q — keep the reference's restriction instead
            return False
        assert isinstance(P_e, Parameter)
        p_off = canon.param_offsets[id(P_e)]
        npx = x_e.size
        # x'Px = sum_ij P_ij xe_i xe_j with xe = Vz: P_z = V' P V
        # entries: for each (i, j) and V entries (i,k,w1), (j,l,w2):
        # P_z[k,l] += w1 w2 * P_param[i,j]
        # build via double join on rows
        for i_ent in range(vr.size):
            i_row, k_col, w1 = int(vr[i_ent]), int(vc[i_ent]), float(vv[i_ent])
            pj_cols = p_off + i_row * npx + vr  # param col of P[i_row, j]
            acc.add_entries(
                np.full(vr.size, k_col, dtype=np.int64),
                vc,
                pj_cols.astype(np.int64),
                2.0 * cval * w1 * vv,
            )
        return True
    return False


def _checkpoint(acc: QuadAccumulator):
    return (len(acc.pi), len(acc.q_extra), acc.offset_exact)


def _rollback(acc: QuadAccumulator, state):
    np_, nq, ex = state
    del acc.pi[np_:], acc.pj[np_:], acc.pp[np_:], acc.pv[np_:]
    del acc.q_extra[nq:]
    acc.offset_exact = ex
