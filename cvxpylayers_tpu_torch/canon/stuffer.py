"""Cone matrix stuffing: canonicalized blocks -> ConeProgram.

Produces the framework's central compile-time artifact: fixed sparsity
patterns (A_rows/A_cols, b_rows) plus parameter-affine value maps

    A_data = reduced_A @ [p; 1],   b = scatter(reduced_b @ [p; 1], b_rows),
    q      = reduced_q @ [p; 1]    (last row = constant objective offset)

mirroring the reference's reduced_A / q_mat contract (cvxpylayers SURVEY
section 0; utils/parse_args.py:482,503-505) with the standard-form sign
convention s = b - Ax (A = -V for s = Vx + c, cf. diffcp_if.py:46-70).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from ..cones.dims import ConeDims
from ..expressions.leaf import Parameter
from ..expressions.problem import Maximize, Problem
from .canonicalizer import Canonicalizer, ConeBlock
from .tensor_rep import CONST, TensorRep


@dataclasses.dataclass
class DualInfo:
    """Where a user constraint's dual lives in the cone-ordered y vector."""

    offset: int
    length: int
    kind: str
    meta: object  # psd side, soc size, exp count, pow alphas
    shape: Tuple[int, ...]  # user-facing shape for zero/nonneg duals


@dataclasses.dataclass
class VarInfo:
    offset: int
    shape: Tuple[int, ...]
    symmetric: bool


@dataclasses.dataclass
class ConeProgram:
    dims: ConeDims
    n: int
    m: int
    n_param: int
    params: List[Parameter]
    param_offsets: Dict[int, int]
    # fixed sparsity + parameter-affine maps
    A_rows: np.ndarray
    A_cols: np.ndarray
    reduced_A: sp.csr_matrix      # (nnz_A, n_param + 1)
    b_rows: np.ndarray
    reduced_b: sp.csr_matrix      # (nb, n_param + 1)
    reduced_q: sp.csr_matrix      # (n + 1, n_param + 1)
    # quadratic objective (1/2)x'Px: fixed sparsity + param-affine values
    P_rows: np.ndarray
    P_cols: np.ndarray
    reduced_P: sp.csr_matrix      # (nnz_P, n_param + 1)
    objective_offset_exact: bool
    var_info: Dict[int, VarInfo]  # id(var) -> VarInfo
    dual_info: Dict[int, DualInfo]  # constraint.id -> DualInfo
    maximize: bool

    # ---- constant-data detection (the reference's `PA_is_constant`,
    # moreau_if.py:237-256): a matrix is parameter-independent iff its
    # reduced map has nonzeros only in the constant (last) column —
    # detection is free because the stuffer already separates columns
    # by parameter.

    @property
    def A_is_constant(self) -> bool:
        """True iff A's entries do not depend on any parameter."""
        return self.reduced_A[:, :-1].count_nonzero() == 0

    @property
    def P_is_constant(self) -> bool:
        """True iff P's entries do not depend on any parameter
        (structurally-zero P counts as constant)."""
        return (self.P_rows.size == 0
                or self.reduced_P[:, :-1].count_nonzero() == 0)

    def constant_A(self) -> np.ndarray:
        """Dense constant A (m, n); only valid when A_is_constant."""
        A = np.zeros((self.m, self.n))
        data = np.asarray(
            self.reduced_A[:, -1].todense()
        ).ravel()
        A[self.A_rows, self.A_cols] = data
        return A

    def constant_P(self) -> np.ndarray:
        """Dense constant P (n, n); only valid when P_is_constant."""
        P = np.zeros((self.n, self.n))
        if self.P_rows.size:
            data = np.asarray(
                self.reduced_P[:, -1].todense()
            ).ravel()
            np.add.at(P, (self.P_rows, self.P_cols), data)
            P = 0.5 * (P + P.T)
        return P


def _collect(blocks: List[ConeBlock]):
    reps = [b.rep for b in blocks]
    sizes = [r.n_rows for r in reps]
    return reps, sizes


def stuff(problem: Problem, params: List[Parameter]) -> ConeProgram:
    """Canonicalize and stuff `problem` over the given parameter order."""
    canon = Canonicalizer(params)

    # Register user variables first for stable, user-var-first column layout.
    for v in problem.variables():
        canon.register_variable(v)

    from .quad import QuadAccumulator, try_extract

    maximize = isinstance(problem.objective, Maximize)
    acc = QuadAccumulator()
    if try_extract(canon, problem.objective.expr, acc,
                   cval=(-1.0 if maximize else 1.0)):
        obj_rep = TensorRep.empty(1)
        for r in acc.q_extra:
            obj_rep = obj_rep + r
    else:
        acc = QuadAccumulator()  # discard partial state
        obj_rep = canon.rep_of(problem.objective.expr)
        if maximize:
            obj_rep = obj_rep.neg()

    for c in problem.constraints:
        canon.canon_constraint(c)

    # ---- order blocks: zero, nonneg, soc, exp, psd, pow -------------------
    ordered: List[Tuple[str, ConeBlock]] = []
    for fam, blist in (
        ("zero", canon.zero_blocks),
        ("nonneg", canon.nonneg_blocks),
        ("soc", canon.soc_blocks),
        ("exp", canon.exp_blocks),
        ("psd", canon.psd_blocks),
        ("pow", canon.pow_blocks),
    ):
        for b in blist:
            ordered.append((fam, b))

    dims = ConeDims(
        zero=sum(b.rep.n_rows for b in canon.zero_blocks),
        nonneg=sum(b.rep.n_rows for b in canon.nonneg_blocks),
        # an soc block's meta is one size (add_soc) or a tuple of sizes
        # for interleaved elementwise blocks (add_soc_elem)
        soc=tuple(
            s
            for b in canon.soc_blocks
            for s in (b.meta if isinstance(b.meta, tuple) else (b.meta,))
        ),
        exp=sum(b.meta for b in canon.exp_blocks),
        psd=tuple(b.meta for b in canon.psd_blocks),
        pow3=tuple(a for b in canon.pow_blocks for a in b.meta),
    )
    m = dims.total
    n = canon.n_var
    n_param = canon.n_param

    # ---- global rows + dual slices ---------------------------------------
    dual_info: Dict[int, DualInfo] = {}
    all_rows = []
    all_vars = []
    all_params = []
    all_vals = []
    offset = 0
    for fam, b in ordered:
        r = b.rep
        if b.constraint_id is not None:
            shape = ()
            cshape = getattr(
                _find_constraint(problem, b.constraint_id), "shape", None
            )
            if cshape is not None:
                shape = cshape
            dual_info[b.constraint_id] = DualInfo(
                offset=offset, length=r.n_rows, kind=fam, meta=b.meta,
                shape=shape,
            )
        all_rows.append(r.rows + offset)
        all_vars.append(r.var_cols)
        all_params.append(r.param_cols)
        all_vals.append(r.vals)
        offset += r.n_rows
    assert offset == m, (offset, m)

    if all_rows:
        rows = np.concatenate(all_rows)
        vcols = np.concatenate(all_vars)
        pcols = np.concatenate(all_params)
        vals = np.concatenate(all_vals)
    else:
        rows = np.zeros(0, dtype=np.int64)
        vcols = rows.copy()
        pcols = rows.copy()
        vals = np.zeros(0)

    # ---- A: var entries (negated), fixed sparsity in CSR order ------------
    is_var = vcols != CONST
    a_r, a_v, a_p, a_val = rows[is_var], vcols[is_var], pcols[is_var], -vals[is_var]
    if a_r.size:
        pattern = np.stack([a_r, a_v], axis=1)
        uniq, slot = np.unique(pattern, axis=0, return_inverse=True)
        # np.unique sorts lexicographically by (row, col) = CSR order
        A_rows = uniq[:, 0].astype(np.int64)
        A_cols = uniq[:, 1].astype(np.int64)
        nnz_A = uniq.shape[0]
        p_idx = np.where(a_p == CONST, n_param, a_p)
        reduced_A = sp.csr_matrix(
            (a_val, (slot, p_idx)), shape=(nnz_A, n_param + 1)
        )
    else:
        A_rows = np.zeros(0, dtype=np.int64)
        A_cols = np.zeros(0, dtype=np.int64)
        reduced_A = sp.csr_matrix((0, n_param + 1))

    # ---- b: constant-column entries ---------------------------------------
    is_b = ~is_var
    b_r, b_p, b_val = rows[is_b], pcols[is_b], vals[is_b]
    if b_r.size:
        b_rows, b_slot = np.unique(b_r, return_inverse=True)
        p_idx = np.where(b_p == CONST, n_param, b_p)
        reduced_b = sp.csr_matrix(
            (b_val, (b_slot, p_idx)), shape=(b_rows.size, n_param + 1)
        )
        b_rows = b_rows.astype(np.int64)
    else:
        b_rows = np.zeros(0, dtype=np.int64)
        reduced_b = sp.csr_matrix((0, n_param + 1))

    # ---- q: objective ------------------------------------------------------
    o_var = obj_rep.var_cols
    o_p = np.where(obj_rep.param_cols == CONST, n_param, obj_rep.param_cols)
    q_row = np.where(o_var == CONST, n, o_var)
    reduced_q = sp.csr_matrix(
        (obj_rep.vals, (q_row, o_p)), shape=(n + 1, n_param + 1)
    )

    # ---- P: quadratic objective pattern -----------------------------------
    qi, qj, qp, qv = acc.concat()
    if qi.size:
        # symmetrize the pattern (store both (i,j) and (j,i) halves so the
        # assembled dense P is symmetric: each entry contributes val/2 to
        # both positions)
        pi2 = np.concatenate([qi, qj])
        pj2 = np.concatenate([qj, qi])
        pp2 = np.concatenate([qp, qp])
        pv2 = np.concatenate([qv, qv]) * 0.5
        pattern = np.stack([pi2, pj2], axis=1)
        uniqP, slotP = np.unique(pattern, axis=0, return_inverse=True)
        P_rows = uniqP[:, 0].astype(np.int64)
        P_cols = uniqP[:, 1].astype(np.int64)
        p_idx = np.where(pp2 == CONST, n_param, pp2)
        reduced_P = sp.csr_matrix(
            (pv2, (slotP, p_idx)), shape=(uniqP.shape[0], n_param + 1)
        )
    else:
        P_rows = np.zeros(0, dtype=np.int64)
        P_cols = np.zeros(0, dtype=np.int64)
        reduced_P = sp.csr_matrix((0, n_param + 1))

    var_info = {
        vid: VarInfo(offset=off, shape=var.shape, symmetric=var.symmetric)
        for vid, (off, var) in canon.var_offsets.items()
    }

    return ConeProgram(
        dims=dims,
        n=n,
        m=m,
        n_param=n_param,
        params=list(params),
        param_offsets=dict(canon.param_offsets),
        A_rows=A_rows,
        A_cols=A_cols,
        reduced_A=reduced_A,
        b_rows=b_rows,
        reduced_b=reduced_b,
        reduced_q=reduced_q,
        P_rows=P_rows,
        P_cols=P_cols,
        reduced_P=reduced_P,
        objective_offset_exact=acc.offset_exact,
        var_info=var_info,
        dual_info=dual_info,
        maximize=maximize,
    )


def _find_constraint(problem: Problem, cid: int):
    for c in problem.constraints:
        if c.id == cid:
            return c
    return None


# --------------------------------------------------------------- numpy eval


def eval_data(prog: ConeProgram, param_values: List[np.ndarray]):
    """Reference (numpy) evaluation of the affine maps, for tests and eager
    use: returns dense (A, b, q, q_offset)."""
    p_ext = np.concatenate(
        [np.asarray(v, dtype=np.float64).reshape(-1) for v in param_values]
        + [np.ones(1)]
    )
    A_data = prog.reduced_A @ p_ext
    b_data = prog.reduced_b @ p_ext
    q_full = prog.reduced_q @ p_ext
    A = np.zeros((prog.m, prog.n))
    A[prog.A_rows, prog.A_cols] = A_data
    b = np.zeros(prog.m)
    b[prog.b_rows] = b_data
    P = np.zeros((prog.n, prog.n))
    if prog.P_rows.size:
        P_data = prog.reduced_P @ p_ext
        np.add.at(P, (prog.P_rows, prog.P_cols), P_data)
        P = 0.5 * (P + P.T)
    return A, b, q_full[:-1], q_full[-1], P
