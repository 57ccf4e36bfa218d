"""Support-function atom: sigma_S(x) = sup_{y in S} <x, y>.

cvxpy parity: cp.suppfunc(y, constraints) returns a callable whose value
at an affine expression x is the support function of
S = {y : constraints} (reference corpus uses it for structured convex
regularizers and dual-representable penalties).

Conic construction — one-shot dualization at canonicalization time. The
set constraints are canonicalized in a sandbox window as

    S = {y : exists u,  G_y y + G_u u + h in K},

and conic (Lagrange) duality of the linear program sup <x, y> over S
gives the exact epigraph

    sigma_S(x) <= t  <=>  exists nu in K*:
        G_y' nu + x = 0,   G_u' nu = 0,   h' nu <= t.

The window blocks are *popped* (they describe S, they are not problem
constraints); the dual variable nu is materialized per block with its
cone appended directly. zero/nonneg/SOC/PSD are (anti-)self-dual (PSD in
svec coordinates); the exp and pow dual cones are LINEAR images of their
primals —

    (u, v, w) in Kexp*    <=>  (u - v, -u, w) in Kexp
    (u, v, w) in Kpow(a)* <=>  (u/a, v/(1-a), w) in Kpow(a)

— so every cone family the framework supports can describe S.
"""

from __future__ import annotations

import numpy as np

from ...canon.tensor_rep import CONST, TensorRep
from ..constraints import Constraint
from ..expression import Expression, Sign, as_expression
from .base import Atom


class SuppFunc(Atom):
    raw_canon = True

    def __init__(self, x, y, constraints, device=None):
        from ..leaf import Variable

        x = as_expression(x)
        if not isinstance(y, Variable):
            raise ValueError("suppfunc set variable must be a Variable")
        if y.symmetric or y.PSD:
            raise ValueError(
                "suppfunc set variable may not use symmetric/PSD storage; "
                "add an explicit PSD(...) constraint on a plain variable"
            )
        if x.shape != y.shape:
            raise ValueError(
                f"suppfunc argument shape {x.shape} != set variable "
                f"shape {y.shape}"
            )
        self._y = y
        # where the numeric value's inner solve runs (Problem.solve's
        # device: the card by default)
        self.device = device
        self._constraints = list(constraints)
        for c in self._constraints:
            if not isinstance(c, Constraint):
                raise ValueError(f"not a constraint: {c!r}")
            if not c.is_dcp():
                raise ValueError(f"suppfunc set constraint is not DCP: {c!r}")
            for v in c.variables():
                if v is not y:
                    raise ValueError(
                        "suppfunc set constraints may involve only the "
                        "set variable"
                    )
        super().__init__(x)

    def shape_from_args(self):
        return ()

    def is_atom_convex(self):
        return True

    def is_atom_concave(self):
        return False

    def sign(self):
        return Sign.UNKNOWN

    def parameters(self):
        seen = {id(p): p for p in self.args[0].parameters()}
        for c in self._constraints:
            for p in c.parameters():
                seen[id(p)] = p
        return list(seen.values())

    def canon(self, ctx, _):
        from ...canon.canonicalizer import ConeBlock

        x_rep = ctx.rep_of(self.args[0])
        y = self._y
        if id(y) in ctx.var_offsets:
            raise ValueError(
                "suppfunc set variable may not appear outside its set"
            )
        n_before = ctx.n_var
        marks = ctx.block_marks()
        saved = ctx._rep_cache
        ctx._rep_cache = {}
        try:
            ctx.register_variable(y)
            for c in self._constraints:
                ctx.canon_constraint(c)
        finally:
            ctx._rep_cache = saved
        n_after = ctx.n_var
        L = n_after - n_before

        popped = []
        for name in ctx._BLOCK_LISTS:
            lst = getattr(ctx, name)
            popped.extend(lst[marks[name]:])
            del lst[marks[name]:]

        gt_rows, gt_vars, gt_pars, gt_vals = [], [], [], []
        h_vars, h_pars, h_vals = [], [], []
        import scipy.sparse as sp

        for b in popped:
            rep = b.rep
            nu_off = ctx.new_aux(rep.n_rows)
            nu = TensorRep.variable(rep.n_rows, nu_off)
            if b.kind in ("nonneg", "soc", "psd"):  # self-dual
                getattr(ctx, b.kind + "_blocks").append(
                    ConeBlock(b.kind, nu, b.meta)
                )
            elif b.kind == "exp":
                # Kexp* is the linear image (u-v, -u, w) in Kexp
                nt = b.meta  # number of (u, v, w) triples
                rows3 = rep.n_rows
                Su = sp.csr_matrix(
                    (np.ones(nt), (np.arange(nt), 3 * np.arange(nt))),
                    shape=(nt, rows3))
                Sv = sp.csr_matrix(
                    (np.ones(nt), (np.arange(nt), 3 * np.arange(nt) + 1)),
                    shape=(nt, rows3))
                Sw = sp.csr_matrix(
                    (np.ones(nt), (np.arange(nt), 3 * np.arange(nt) + 2)),
                    shape=(nt, rows3))
                ctx.add_exp(
                    nu.apply_linear(Su - Sv),
                    nu.apply_linear(Su).neg(),
                    nu.apply_linear(Sw),
                )
            elif b.kind == "pow":
                # Kpow(a)* = diag(1/a, 1/(1-a), 1) Kpow(a)
                alphas = np.asarray(b.meta, dtype=np.float64)
                nt = alphas.size
                rows3 = rep.n_rows
                Su = sp.csr_matrix(
                    (1.0 / alphas, (np.arange(nt), 3 * np.arange(nt))),
                    shape=(nt, rows3))
                Sv = sp.csr_matrix(
                    (1.0 / (1.0 - alphas),
                     (np.arange(nt), 3 * np.arange(nt) + 1)),
                    shape=(nt, rows3))
                Sw = sp.csr_matrix(
                    (np.ones(nt), (np.arange(nt), 3 * np.arange(nt) + 2)),
                    shape=(nt, rows3))
                ctx.add_pow(
                    nu.apply_linear(Su), nu.apply_linear(Sv),
                    nu.apply_linear(Sw), alphas,
                )
            # b.kind == "zero": dual of {0} is free — no cone constraint
            const_mask = rep.var_cols == CONST
            h_vars.append(nu_off + rep.rows[const_mask])
            h_pars.append(rep.param_cols[const_mask])
            h_vals.append(rep.vals[const_mask])
            var_mask = ~const_mask
            vc = rep.var_cols[var_mask]
            if np.any((vc < n_before) | (vc >= n_after)):
                raise ValueError(
                    "suppfunc set constraints may involve only the set "
                    "variable"
                )
            gt_rows.append(vc - n_before)
            gt_vars.append(nu_off + rep.rows[var_mask])
            gt_pars.append(rep.param_cols[var_mask])
            gt_vals.append(rep.vals[var_mask])

        def cat(parts, dtype=np.int64):
            return (np.concatenate(parts).astype(dtype) if parts
                    else np.zeros(0, dtype))

        # G' nu + [x; 0] = 0  (y rows carry x; sandbox-aux rows carry 0)
        Gt_nu = TensorRep(L, cat(gt_rows), cat(gt_vars), cat(gt_pars),
                          cat(gt_vals, np.float64))
        x_pad = TensorRep(L, x_rep.rows, x_rep.var_cols, x_rep.param_cols,
                          x_rep.vals)
        ctx.add_zero(Gt_nu + x_pad)

        # t >= h' nu
        t_off = ctx.new_aux(1)
        n_h = sum(len(v) for v in h_vars)
        h_nu = TensorRep(1, np.zeros(n_h, np.int64), cat(h_vars),
                         cat(h_pars), cat(h_vals, np.float64))
        t_rep = TensorRep.variable(1, t_off)
        ctx.add_nonneg(t_rep + h_nu.neg())
        return t_rep


def suppfunc(y, constraints, device=None):
    """sigma_S with S = {y : constraints}: returns a callable f such that
    f(x) is the support function of S evaluated at the affine expression
    x (cvxpy.suppfunc parity). `device` is where f(x).value runs its
    inner Problem.solve: the card by default, "cpu" on request."""

    def make(x) -> Expression:
        return SuppFunc(x, y, constraints, device=device)

    return make
