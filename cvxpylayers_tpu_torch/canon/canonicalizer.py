"""Canonicalizer: expression DAG -> cone constraint blocks over global columns.

This plus `stuffer.py` replaces CVXPY's reduction stack + cvxcore matrix
stuffing for the supported atom set (reference call sites:
problem.get_problem_data in cvxpylayers utils/parse_args.py:436-464). The
output preserves the reference's key architectural invariant: fixed sparsity
patterns with parameter-affine data maps, computed once per problem.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from ..expressions import constraints as cons
from ..expressions.leaf import Constant, Parameter, Variable
from .tensor_rep import TensorRep


class ConeBlock:
    """One block of cone rows: s = rep in K_kind."""

    def __init__(self, kind: str, rep: TensorRep, meta=None, constraint_id=None):
        self.kind = kind
        self.rep = rep
        self.meta = meta
        self.constraint_id = constraint_id


def _svec_map(s: int) -> sp.csr_matrix:
    """Linear map: flat (C-order) s x s matrix -> svec (column-major lower
    triangle, off-diag scaled by sqrt(2)), symmetrizing the input."""
    rows, cols, vals = [], [], []
    k = 0
    r2 = math.sqrt(2.0) / 2.0
    for j in range(s):
        for i in range(j, s):
            if i == j:
                rows.append(k)
                cols.append(i * s + i)
                vals.append(1.0)
            else:
                rows.append(k)
                cols.append(i * s + j)
                vals.append(r2)
                rows.append(k)
                cols.append(j * s + i)
                vals.append(r2)
            k += 1
    d = s * (s + 1) // 2
    return sp.csr_matrix((vals, (rows, cols)), shape=(d, s * s))


def _unsvec_map(s: int) -> sp.csr_matrix:
    """Linear map svec -> flat symmetric matrix (inverse of _svec_map on
    symmetric inputs)."""
    d = s * (s + 1) // 2
    rows, cols, vals = [], [], []
    k = 0
    inv_r2 = 1.0 / math.sqrt(2.0)
    for j in range(s):
        for i in range(j, s):
            if i == j:
                rows.append(i * s + i)
                cols.append(k)
                vals.append(1.0)
            else:
                rows.append(i * s + j)
                cols.append(k)
                vals.append(inv_r2)
                rows.append(j * s + i)
                cols.append(k)
                vals.append(inv_r2)
            k += 1
    return sp.csr_matrix((vals, (rows, cols)), shape=(s * s, d))


def _shift_rows(rep: TensorRep, mult: int, offset: int, n_rows: int) -> TensorRep:
    """New rep with rows' = mult * rows + offset (for cone interleaving)."""
    return TensorRep(
        n_rows, rep.rows * mult + offset, rep.var_cols, rep.param_cols, rep.vals
    )


class Canonicalizer:
    def __init__(self, params: List[Parameter]):
        self.params = list(params)
        self.param_offsets: Dict[int, int] = {}
        off = 0
        for p in self.params:
            self.param_offsets[id(p)] = off
            off += p.size
        self.n_param = off

        self.n_var = 0
        self.var_offsets: Dict[int, Tuple[int, Variable]] = {}
        self._rep_cache: Dict[int, TensorRep] = {}

        # blocks per cone family, in declaration order
        self.zero_blocks: List[ConeBlock] = []
        self.nonneg_blocks: List[ConeBlock] = []
        self.soc_blocks: List[ConeBlock] = []
        self.exp_blocks: List[ConeBlock] = []
        self.psd_blocks: List[ConeBlock] = []
        self.pow_blocks: List[ConeBlock] = []

    # --------------------------------------------------------------- columns

    def new_aux(self, size: int) -> int:
        off = self.n_var
        self.n_var += size
        return off

    def register_variable(self, var: Variable) -> int:
        if id(var) in self.var_offsets:
            return self.var_offsets[id(var)][0]
        ncols = (
            var.shape[0] * (var.shape[0] + 1) // 2 if var.symmetric else var.size
        )
        off = self.new_aux(ncols)
        self.var_offsets[id(var)] = (off, var)
        # implicit attribute constraints
        rep = self._var_rep(var)
        if var.nonneg:
            self.add_nonneg(rep)
        if var.nonpos:
            self.add_nonneg(rep.neg())
        if var.PSD:
            self.add_psd(rep, var.shape[0])
        return off

    def _var_rep(self, var: Variable) -> TensorRep:
        off, _ = self.var_offsets[id(var)]
        if not var.symmetric:
            return TensorRep.variable(var.size, off)
        s = var.shape[0]
        d = s * (s + 1) // 2
        base = TensorRep.variable(d, off)
        return base.apply_linear(_unsvec_map(s))

    # ------------------------------------------------------------------ reps

    def rep_of(self, expr) -> TensorRep:
        key = id(expr)
        if key in self._rep_cache:
            return self._rep_cache[key]
        if isinstance(expr, Variable):
            self.register_variable(expr)
            rep = self._var_rep(expr)
        elif isinstance(expr, Parameter):
            rep = TensorRep.parameter(expr.size, self.param_offsets[id(expr)])
        elif isinstance(expr, Constant):
            rep = TensorRep.constant(expr.value)
        elif getattr(expr, "raw_canon", False):
            # atom drives its own sub-canonicalization (e.g. perspective,
            # which must intercept and homogenize its argument's blocks)
            rep = expr.canon(self, None)
        else:
            arg_reps = [self.rep_of(a) for a in expr.args]
            rep = expr.canon(self, arg_reps)
        self._rep_cache[key] = rep
        return rep

    _BLOCK_LISTS = (
        "zero_blocks", "nonneg_blocks", "soc_blocks",
        "exp_blocks", "psd_blocks", "pow_blocks",
    )

    def block_marks(self):
        """Snapshot of per-family block counts (for windowed transforms)."""
        return {k: len(getattr(self, k)) for k in self._BLOCK_LISTS}

    def homogenize_since(self, marks, s_rep: TensorRep):
        """Rewrite every block added since `marks` to its perspective:
        constants c(p) become c(p)*s (conic perspective transform)."""
        for name in self._BLOCK_LISTS:
            lst = getattr(self, name)
            for i in range(marks[name], len(lst)):
                b = lst[i]
                lst[i] = ConeBlock(
                    b.kind, b.rep.homogenize_const(s_rep), b.meta,
                    b.constraint_id,
                )

    # ------------------------------------------------------------ cone blocks

    def add_zero(self, rep: TensorRep, constraint_id=None):
        self.zero_blocks.append(ConeBlock("zero", rep, None, constraint_id))

    def add_nonneg(self, rep: TensorRep, constraint_id=None):
        self.nonneg_blocks.append(ConeBlock("nonneg", rep, None, constraint_id))

    def add_soc(self, parts: List[TensorRep], constraint_id=None):
        """One SOC block: rows = concat(parts) = [t; x]."""
        total = sum(p.n_rows for p in parts)
        out = TensorRep.empty(total)
        off = 0
        for p in parts:
            out = out + _shift_rows(p, 1, off, total)
            off += p.n_rows
        self.soc_blocks.append(ConeBlock("soc", out, total, constraint_id))

    def add_soc_elem(self, parts: List[TensorRep], constraint_id=None):
        """n parallel SOC blocks of size len(parts): block i has rows
        [p0_i, p1_i, ...] — the vectorized form of n per-element add_soc
        calls (one interleaved rep instead of n O(n) selection matmuls,
        which made elementwise-atom canonicalization O(n^2))."""
        d = len(parts)
        n = parts[0].n_rows
        total = d * n
        out = TensorRep.empty(total)
        for k, p in enumerate(parts):
            assert p.n_rows == n, (p.n_rows, n)
            out = out + _shift_rows(p, d, k, total)
        self.soc_blocks.append(ConeBlock("soc", out, (d,) * n, constraint_id))

    def add_exp(self, x: TensorRep, y: TensorRep, z: TensorRep, constraint_id=None):
        """n_rows(x) exponential cones, rows interleaved (x_i, y_i, z_i)."""
        n = x.n_rows
        assert y.n_rows == n and z.n_rows == n
        total = 3 * n
        out = (
            _shift_rows(x, 3, 0, total)
            + _shift_rows(y, 3, 1, total)
            + _shift_rows(z, 3, 2, total)
        )
        self.exp_blocks.append(ConeBlock("exp", out, n, constraint_id))

    def add_psd(self, rep_flat: TensorRep, s: int, constraint_id=None):
        """rep_flat is the flattened (s*s) matrix expression; stored in svec."""
        svec_rep = rep_flat.apply_linear(_svec_map(s))
        self.psd_blocks.append(ConeBlock("psd", svec_rep, s, constraint_id))

    def add_pow(self, x: TensorRep, y: TensorRep, z: TensorRep, alpha,
                constraint_id=None):
        n = x.n_rows
        assert y.n_rows == n and z.n_rows == n
        alphas = np.broadcast_to(np.asarray(alpha, dtype=np.float64), (n,))
        total = 3 * n
        out = (
            _shift_rows(x, 3, 0, total)
            + _shift_rows(y, 3, 1, total)
            + _shift_rows(z, 3, 2, total)
        )
        self.pow_blocks.append(
            ConeBlock("pow", out, tuple(alphas.tolist()), constraint_id)
        )

    # --------------------------------------------------------- constraint canon

    def canon_constraint(self, c: cons.Constraint):
        if isinstance(c, cons.Equality):
            lhs, rhs = c.args
            rep = self._diff_rep(rhs, lhs)
            self.add_zero(rep, c.id)
        elif isinstance(c, cons.Inequality):
            lhs, rhs = c.args
            rep = self._diff_rep(rhs, lhs)
            self.add_nonneg(rep, c.id)
        elif isinstance(c, cons.NonNeg):
            self.add_nonneg(self.rep_of(c.args[0]), c.id)
        elif isinstance(c, cons.SOC):
            t, X = c.args
            self.add_soc([self.rep_of(t), self.rep_of(X)], c.id)
        elif isinstance(c, cons.ExpCone):
            x, y, z = (self.rep_of(a) for a in c.args)
            self.add_exp(x, y, z, c.id)
        elif isinstance(c, cons.PSD):
            X = c.args[0]
            self.add_psd(self.rep_of(X), X.shape[0], c.id)
        elif isinstance(c, cons.PowCone3D):
            x, y, z = (self.rep_of(a) for a in c.args)
            self.add_pow(x, y, z, c.alpha, c.id)
        else:
            raise ValueError(f"unsupported constraint type {type(c).__name__}")

    def _diff_rep(self, a, b) -> TensorRep:
        """rep(a - b) with broadcasting."""
        from ..expressions.atoms.affine import broadcast_map
        from ..expressions.expression import broadcast_shapes_add

        shape = broadcast_shapes_add(a.shape, b.shape)
        ra = self.rep_of(a)
        rb = self.rep_of(b)
        if a.shape != shape:
            ra = ra.apply_linear(broadcast_map(a.shape, shape))
        if b.shape != shape:
            rb = rb.apply_linear(broadcast_map(b.shape, shape))
        return ra + rb.neg()
