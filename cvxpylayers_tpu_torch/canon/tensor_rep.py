"""Canonicalization-time tensor representation.

The core invariant of the whole framework (inherited from the reference's
architecture, cvxpylayers SURVEY section 0): a DPP-compliant expression is
*affine in the variables, with coefficients affine in the parameters*.

    expr_flat[row] = sum_k vals[k] * p_ext[param_cols[k]] * x_ext[var_cols[k]]

where x_ext = [x; 1] and p_ext = [p; 1] (the constant slots are encoded as
column index -1). `TensorRep` stores those (row, var, param, val) quadruples
in COO form over *global* variable/parameter columns, and supports the affine
operations canonicalization needs. Everything here is one-time numpy/scipy
work at layer construction (the role of CVXPY's cvxcore C++ backend,
reference parse_args.py:447-462); no JAX is involved.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

CONST = -1  # sentinel column index for the constant slot on either axis


def join_pairs(ka, kb):
    """All index pairs (ia, ib) with ka[ia] == kb[ib], grouped by ia.

    Returns (ia, ib) int64 arrays. Vectorized numpy (no Python-level
    per-entry loop).
    """
    ka = np.ascontiguousarray(ka, dtype=np.int64)
    kb = np.ascontiguousarray(kb, dtype=np.int64)
    if ka.size == 0 or kb.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    order = np.argsort(kb, kind="stable")
    kb_sorted = kb[order]
    starts = np.searchsorted(kb_sorted, ka, side="left")
    ends = np.searchsorted(kb_sorted, ka, side="right")
    counts = ends - starts
    total = int(counts.sum())
    ia = np.repeat(np.arange(ka.size, dtype=np.int64), counts)
    # positions within runs: global offset trick
    run_offsets = np.repeat(starts, counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    ib = order[run_offsets + within]
    return ia, ib


@dataclasses.dataclass
class TensorRep:
    """COO 3-axis tensor for one flattened (C-order) expression."""

    n_rows: int
    rows: np.ndarray
    var_cols: np.ndarray
    param_cols: np.ndarray
    vals: np.ndarray

    # ---------------------------------------------------------------- build

    @staticmethod
    def empty(n_rows: int) -> "TensorRep":
        z = np.zeros(0, dtype=np.int64)
        return TensorRep(n_rows, z, z.copy(), z.copy(), np.zeros(0))

    @staticmethod
    def constant(vec: np.ndarray) -> "TensorRep":
        vec = np.asarray(vec, dtype=np.float64).reshape(-1)
        nz = np.flatnonzero(vec)
        return TensorRep(
            vec.size,
            nz.astype(np.int64),
            np.full(nz.size, CONST, dtype=np.int64),
            np.full(nz.size, CONST, dtype=np.int64),
            vec[nz],
        )

    @staticmethod
    def variable(size: int, var_offset: int) -> "TensorRep":
        idx = np.arange(size, dtype=np.int64)
        return TensorRep(
            size,
            idx,
            idx + var_offset,
            np.full(size, CONST, dtype=np.int64),
            np.ones(size),
        )

    @staticmethod
    def parameter(size: int, param_offset: int) -> "TensorRep":
        idx = np.arange(size, dtype=np.int64)
        return TensorRep(
            size,
            idx,
            np.full(size, CONST, dtype=np.int64),
            idx + param_offset,
            np.ones(size),
        )

    # ------------------------------------------------------------ predicates

    @property
    def nnz(self) -> int:
        return self.vals.size

    def is_param_free(self) -> bool:
        return bool(np.all(self.param_cols == CONST))

    def is_var_free(self) -> bool:
        return bool(np.all(self.var_cols == CONST))

    # ------------------------------------------------------------ arithmetic

    def __add__(self, other: "TensorRep") -> "TensorRep":
        if self.n_rows != other.n_rows:
            raise ValueError(
                f"row mismatch in add: {self.n_rows} vs {other.n_rows}"
            )
        return TensorRep(
            self.n_rows,
            np.concatenate([self.rows, other.rows]),
            np.concatenate([self.var_cols, other.var_cols]),
            np.concatenate([self.param_cols, other.param_cols]),
            np.concatenate([self.vals, other.vals]),
        )

    def scale(self, c: float) -> "TensorRep":
        return TensorRep(
            self.n_rows, self.rows, self.var_cols, self.param_cols,
            self.vals * float(c),
        )

    def neg(self) -> "TensorRep":
        return self.scale(-1.0)

    # ------------------------------------------------------------ linear map

    def apply_linear(self, L: sp.spmatrix) -> "TensorRep":
        """Apply a constant linear map to the row axis: out = L @ expr.

        L has shape (n_out, self.n_rows). Implemented as one sparse matmul:
        build E (n_rows x nnz) with E[rows[k], k] = vals[k]; then
        (L @ E).tocoo() enumerates exactly the output entries.
        """
        if L.shape[1] != self.n_rows:
            raise ValueError(f"linear map shape {L.shape} vs rows {self.n_rows}")
        if self.nnz == 0:
            return TensorRep.empty(L.shape[0])
        L = sp.csr_matrix(L)
        E = sp.csc_matrix(
            (self.vals, (self.rows, np.arange(self.nnz))),
            shape=(self.n_rows, self.nnz),
        )
        P = (L @ E).tocoo()
        return TensorRep(
            L.shape[0],
            P.row.astype(np.int64),
            self.var_cols[P.col],
            self.param_cols[P.col],
            P.data,
        )

    # ------------------------------------------------- parameter-affine products

    def _join_product(
        self,
        self_keys: np.ndarray,
        other: "TensorRep",
        other_keys: np.ndarray,
        out_rows_fn,
        n_out: int,
        op_name: str,
    ) -> "TensorRep":
        """Generic contraction: for every pair (k_self, k_other) whose join
        keys match, emit an entry with value vals*vals, combined param col,
        var col taken from `other` (self must be var-free), and output row
        out_rows_fn(k_self_idx, k_other_idx).
        """
        if np.any(self.var_cols != CONST):
            raise ValueError(
                f"DPP violation in {op_name}: multiplier must not involve "
                "variables (product of two variable expressions is not affine)"
            )
        if self.nnz == 0 or other.nnz == 0:
            return TensorRep.empty(n_out)
        # sparse inner join on the contraction key
        sidx, oidx = join_pairs(self_keys, other_keys)

        p1 = self.param_cols[sidx]
        p2 = other.param_cols[oidx]
        both = (p1 != CONST) & (p2 != CONST)
        if np.any(both):
            raise ValueError(
                f"DPP violation in {op_name}: product of two parameter-"
                "dependent expressions (parameter expressions must enter "
                "affinely; see DPP rules)"
            )
        return TensorRep(
            n_out,
            out_rows_fn(sidx, oidx).astype(np.int64),
            other.var_cols[oidx],
            np.where(p1 != CONST, p1, p2),
            self.vals[sidx] * other.vals[oidx],
        )

    def param_matmul_left(
        self, self_shape, other: "TensorRep", other_shape
    ) -> "TensorRep":
        """self(p) @ other, self an (m, k) parameter-affine matrix expression
        (var-free), other a (k, n) variable-affine expression. Returns (m, n)
        flattened C-order."""
        m, k = self_shape
        k2, n = other_shape
        assert k == k2
        # self flat row = i*k + l ; other flat row = l*n + j
        self_l = self.rows % k
        self_i = self.rows // k
        other_l = other.rows // n
        other_j = other.rows % n

        def out_rows(sidx, oidx):
            return self_i[sidx] * n + other_j[oidx]

        # join on l
        return self._join_with_keys(
            self_l, self_i, other, other_l, other_j, out_rows, m * n,
            "matmul(param, expr)",
        )

    def param_matmul_right(
        self, self_shape, other: "TensorRep", other_shape
    ) -> "TensorRep":
        """other @ self(p): other (m, k) variable-affine, self (k, n)
        parameter-affine (var-free). Returns (m, n) C-order."""
        k, n = self_shape
        m, k2 = other_shape
        assert k == k2
        self_l = self.rows // n
        self_j = self.rows % n
        other_l = other.rows % k
        other_i = other.rows // k

        def out_rows(sidx, oidx):
            return other_i[oidx] * n + self_j[sidx]

        return self._join_with_keys(
            self_l, self_j, other, other_l, other_i, out_rows, m * n,
            "matmul(expr, param)",
        )

    def param_elemwise(self, other: "TensorRep") -> "TensorRep":
        """Elementwise multiply(self(p), other): self var-free, same rows."""
        if self.n_rows != other.n_rows:
            raise ValueError("elementwise multiply shape mismatch")

        def out_rows(sidx, oidx):
            return self.rows[sidx]

        return self._join_with_keys(
            self.rows, None, other, other.rows, None, out_rows, self.n_rows,
            "multiply(param, expr)",
        )

    def param_scalar_mul(self, other: "TensorRep") -> "TensorRep":
        """Multiply by a scalar parameter-affine expression (self, 1 row)."""
        if self.n_rows != 1:
            raise ValueError("param_scalar_mul needs scalar multiplier")

        def out_rows(sidx, oidx):
            return other.rows[oidx]

        return self._join_with_keys(
            np.zeros(self.nnz, dtype=np.int64), None,
            other, np.zeros(other.nnz, dtype=np.int64), None,
            out_rows, other.n_rows, "multiply(param_scalar, expr)",
        )

    def _join_with_keys(
        self, self_keys, _si, other, other_keys, _oj, out_rows_fn, n_out,
        op_name,
    ):
        return self._join_product(
            self_keys, other, other_keys, out_rows_fn, n_out, op_name
        )

    def mul_scalar_expr(self, s_rep: "TensorRep") -> "TensorRep":
        """self (var-free, n rows) times a SCALAR expression s_rep (1 row,
        possibly variable-affine): out[r] = self[r] * s. Used by the
        perspective transform to homogenize constants by the scale
        variable; the usual DPP single-parameter-factor rule applies."""
        if s_rep.n_rows != 1:
            raise ValueError("mul_scalar_expr needs a scalar multiplier")

        def out_rows(sidx, oidx):
            return self.rows[sidx]

        return self._join_product(
            np.zeros(self.nnz, dtype=np.int64),
            s_rep,
            np.zeros(s_rep.nnz, dtype=np.int64),
            out_rows,
            self.n_rows,
            "perspective homogenization",
        )

    def homogenize_const(self, s_rep: "TensorRep") -> "TensorRep":
        """Replace the affine constant part c(p) of this rep by c(p)*s:
        rows' = A(p) x + c(p) * s. This is the conic perspective transform
        (cones are invariant under positive row scaling)."""
        mask = self.var_cols == CONST
        if not mask.any():
            return self
        keep = ~mask
        var_part = TensorRep(
            self.n_rows, self.rows[keep], self.var_cols[keep],
            self.param_cols[keep], self.vals[keep],
        )
        const_part = TensorRep(
            self.n_rows, self.rows[mask], self.var_cols[mask],
            self.param_cols[mask], self.vals[mask],
        )
        return var_part + const_part.mul_scalar_expr(s_rep)

    # ------------------------------------------------------------- evaluation

    def eval(self, x_ext: np.ndarray, p_ext: np.ndarray) -> np.ndarray:
        """Reference (slow) evaluation for tests: x_ext/p_ext include the
        trailing constant-1 slot."""
        out = np.zeros(self.n_rows)
        v = np.where(self.var_cols == CONST, len(x_ext) - 1, self.var_cols)
        p = np.where(self.param_cols == CONST, len(p_ext) - 1, self.param_cols)
        np.add.at(out, self.rows, self.vals * p_ext[p] * x_ext[v])
        return out
