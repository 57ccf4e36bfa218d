"""Matrix-free (static-pattern sparse) large-instance solver route, batched.

Counterpart of cvxpylayers_tpu/solver/matfree.py. The dense route
(solver/admm.py + kkt.py) scatters each instance into dense (n, n) P and
(m, n) A and factors per epoch; at n ~ 10^3..10^5 the dense assembly alone
is O(mn) per instance. This route keeps the data in the stuffer's fixed-
sparsity form (the A_rows/A_cols and P_rows/P_cols patterns, with (B, nnz)
value tensors) and replaces every factorization with conjugate gradients:

  * SpMV and SpMV' as a gather, a product and a segmented sum over static
    index tensors: O(nnz) traffic, elementwise products (no TF32 trap);
  * the ADMM x-update solves (P + sigma I + A' diag(rho) A) x = rhs by a
    fixed number of CG steps warm-started at the previous solution;
  * PDHG (solver/pdhg.py's loop) through the same matvecs;
  * the semismooth-Newton polish and the implicit derivatives share the
    generic loop of solver/refine.py, their KKT solves by CG on the
    normal equations through operator matvecs, or, for structurally
    diagonal P and polyhedral cones, the exact Schur split (the inverse of
    P + sigma I is elementwise);
  * the adjoint gives gradients at the nnz positions only:
    dA_data[k] = y[r_k] u[c_k] + v[r_k] x[c_k], never an (m, n) product.

Reductions are deterministic. Every sum of the matvecs is a segmented sum
over entries sorted by their output index (`torch.segment_reduce` over CSR
offsets, as the reference's sorted segment sums): one thread adds a row's
entries in a fixed order, where `index_add_` on CUDA adds by atomics in
an order that changes from run to run, so f32 sums would move by an ulp
between calls and could flip a lane's epoch of convergence. The maxima of
the Ruiz scaling take `scatter_reduce(..., "amax")`, which does not depend
on the order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cones.dims import ConeDims
from ..cones.jacobians import make_cone_dproj_factored
from ..cones.projections import make_cone_projector, make_inner_projector
from .admm import SolveResult, _cone_row_groups
from .linsolve import _cg_normal, _cg_spd, _cg_spd_warm
from .pdhg import make_pdhg_core
from .refine import _ESCAPE_STEP, _newton_polish_loop
from .settings import MAX_ITERS, SolverSettings
from .stopping import (
    banjac,
    bdot,
    certified,
    epoch_status,
    kkt_scales,
    rho_ratio,
    rho_step,
    run_lanes,
    unfinished,
    within,
)

# dense per-instance assembly above this m*n footprint switches the layer
# to this route (~256^2; at bench sizes the dense route is faster)
_DENSE_ASSEMBLY_LIMIT = 1 << 16


def _offsets(idx: np.ndarray, size: int) -> np.ndarray:
    """CSR offsets (size + 1,) of sorted segment ids."""
    return np.concatenate([[0], np.cumsum(np.bincount(idx, minlength=size))])


def _seg_sum(vals: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive runs of the last axis, (..., nnz) -> (..., k),
    in entry order (deterministic); `offsets` (k + 1,) bounds the runs."""
    off = offsets.expand(vals.shape[:-1] + offsets.shape)
    return torch.segment_reduce(vals, "sum", offsets=off,
                                axis=vals.ndim - 1, unsafe=True)


def _seg_amax(vals: torch.Tensor, idx: torch.Tensor,
              size: int) -> torch.Tensor:
    """max(0, max of the entries of each segment), (..., nnz) -> (..., size)
    for entry segment ids idx (nnz,), any order."""
    out = vals.new_zeros(vals.shape[:-1] + (size,))
    return out.scatter_reduce(-1, idx.expand(vals.shape), vals, "amax")


def _like(data: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """data (B, nnz) broadcast against a vector v (B, ..., k)."""
    return data.reshape(data.shape[:1] + (1,) * (v.ndim - 2)
                        + data.shape[1:])


class SparseOps:
    """Static-pattern sparse matvec operators for A (m, n) and P (n, n),
    over batched value tensors (B, nnz) that share one pattern.

    The index tensors are built on the host once and moved to a device on
    first use there. A's forward SpMV sums its entries by row in the
    stuffer's CSR order; the transpose sums them by column through a
    stable argsort, so both sums are sorted. P is stored with both
    symmetric halves (the stuffer's convention), so P_mv is symmetric by
    construction. A vector may carry one more axis than the data
    ((B, k, n) against (B, nnz)): the polish evaluates k candidate points
    per lane at once."""

    def __init__(self, A_rows, A_cols, m: int, n: int, P_rows, P_cols):
        self.m = int(m)
        self.n = int(n)
        ar = np.asarray(A_rows, np.int64)
        ac = np.asarray(A_cols, np.int64)
        pr = np.asarray(P_rows, np.int64)
        pc = np.asarray(P_cols, np.int64)
        self.nnz_A = int(ar.size)
        self.nnz_P = int(pr.size)
        by_row = np.argsort(ar, kind="stable")
        by_col = np.argsort(ac, kind="stable")
        p_by_row = np.argsort(pr, kind="stable")
        diag = (pr == pc).astype(np.float64)
        self._host = dict(
            ar=ar, ac=ac, pr=pr, pc=pc,
            # forward SpMV: entries in row order
            r_perm=by_row, r_col=ac[by_row], r_off=_offsets(ar, self.m),
            # transpose: entries in column order
            c_perm=by_col, c_row=ar[by_col], c_off=_offsets(ac, self.n),
            # P: entries in row order
            p_perm=p_by_row, p_col=pc[p_by_row], p_off=_offsets(pr, self.n),
            p_diag=diag, p_diag_r=diag[p_by_row],
        )
        # the stuffer gives A in CSR order: no gather for the forward sum
        self._row_sorted = bool(np.array_equal(by_row, np.arange(ar.size)))
        self._p_sorted = bool(np.array_equal(p_by_row, np.arange(pr.size)))
        self._dev = {}

    def _idx(self, like: torch.Tensor) -> dict:
        """The index tensors on `like`'s device, the 0/1 diagonal masks in
        its dtype."""
        key = (like.device, like.dtype)
        if key not in self._dev:
            self._dev[key] = {
                k: torch.as_tensor(
                    v, device=like.device,
                    dtype=like.dtype if v.dtype == np.float64 else None)
                for k, v in self._host.items()
            }
        return self._dev[key]

    def _empty(self, v: torch.Tensor, size: int) -> torch.Tensor:
        return v.new_zeros(v.shape[:-1] + (size,))

    # ---------------------------------------------------------- A matvecs

    def A_mv(self, A_data, x):
        if self.m == 0 or self.nnz_A == 0:
            return self._empty(x, self.m)
        ix = self._idx(x)
        d = A_data if self._row_sorted else A_data[:, ix["r_perm"]]
        return _seg_sum(_like(d, x) * x[..., ix["r_col"]], ix["r_off"])

    def A_rmv(self, A_data, y):
        if self.nnz_A == 0:
            return self._empty(y, self.n)
        ix = self._idx(y)
        d = A_data[:, ix["c_perm"]]
        return _seg_sum(_like(d, y) * y[..., ix["c_row"]], ix["c_off"])

    # ---------------------------------------------------------- P matvecs

    def P_mv(self, P_data, x):
        if self.nnz_P == 0:
            return self._empty(x, self.n)
        ix = self._idx(x)
        d = P_data if self._p_sorted else P_data[:, ix["p_perm"]]
        return _seg_sum(_like(d, x) * x[..., ix["p_col"]], ix["p_off"])

    def P_diag(self, P_data):
        """Structural diagonal of P, (B, n) (zeros where the pattern has
        no diagonal entry)."""
        if self.nnz_P == 0:
            return P_data.new_zeros(P_data.shape[0], self.n)
        ix = self._idx(P_data)
        d = P_data if self._p_sorted else P_data[:, ix["p_perm"]]
        return _seg_sum(d * ix["p_diag_r"], ix["p_off"])

    def P_trace(self, P_data):
        if self.nnz_P == 0:
            return P_data.new_zeros(P_data.shape[0])
        return (P_data * self._idx(P_data)["p_diag"]).sum(dim=-1)

    # ----------------------------------------------------- Ruiz reductions

    def A_col_max(self, absdata):
        if self.nnz_A == 0:
            return absdata.new_zeros(absdata.shape[0], self.n)
        return _seg_amax(absdata, self._idx(absdata)["ac"], self.n)

    def A_row_max(self, absdata):
        if self.m == 0 or self.nnz_A == 0:
            return absdata.new_zeros(absdata.shape[0], self.m)
        return _seg_amax(absdata, self._idx(absdata)["ar"], self.m)

    def P_col_max(self, absdata):
        if self.nnz_P == 0:
            return absdata.new_zeros(absdata.shape[0], self.n)
        return _seg_amax(absdata, self._idx(absdata)["pc"], self.n)

    # ---------------------------------------------------------- scalings

    def scale_A(self, A_data, de, dx):
        if self.nnz_A == 0:
            return A_data
        ix = self._idx(A_data)
        return A_data * de[:, ix["ar"]] * dx[:, ix["ac"]]

    def scale_P(self, P_data, dx):
        if self.nnz_P == 0:
            return P_data
        ix = self._idx(P_data)
        return P_data * dx[:, ix["pr"]] * dx[:, ix["pc"]]

    # ------------------------------------------------------ derivatives

    def A_data_grad(self, y, u, v, x):
        """VJP into A_data of F1 = ... + A'y (cotangent u) and F2 = Ax
        (cotangent v): dA[i, j] = y_i u_j + v_i x_j at the nnz only."""
        if self.nnz_A == 0:
            return x.new_zeros(x.shape[0], 0)
        ix = self._idx(x)
        ar, ac = ix["ar"], ix["ac"]
        return y[:, ar] * u[:, ac] + v[:, ar] * x[:, ac]

    def P_data_grad(self, u, x):
        """VJP into P_data of F1 = Px (cotangent u): dP[i, j] = u_i x_j at
        the nnz only (the pattern stores both symmetric halves)."""
        if self.nnz_P == 0:
            return x.new_zeros(x.shape[0], 0)
        ix = self._idx(x)
        return u[:, ix["pr"]] * x[:, ix["pc"]]


# ------------------------------------------------------------------ Ruiz


def _ruiz_equilibrate_matfree(ops: SparseOps, P_data, A_data, q, b,
                              group_ids, n_groups, iters: int):
    """Modified Ruiz equilibration on the value tensors: the recurrence of
    admm._ruiz_equilibrate, its maxima by segment."""
    B, n = q.shape
    m = ops.m
    gid = torch.as_tensor(group_ids, device=q.device)
    Pd, Ad = P_data, A_data
    D = q.new_ones(B, n)
    E = q.new_ones(B, m)
    c = q.new_ones(B)
    for _ in range(iters):
        col = torch.maximum(ops.P_col_max(Pd.abs()), ops.A_col_max(Ad.abs()))
        dx = 1.0 / torch.sqrt(torch.where(col > 1e-12, col, 1.0))
        row = ops.A_row_max(Ad.abs())
        if m:
            # pooled per cone block (scaled slacks stay in K)
            pooled = row.new_full((B, n_groups), -torch.inf)
            pooled = pooled.scatter_reduce(1, gid.expand(B, m), row, "amax")
            row = torch.clamp_min(pooled[:, gid], 0.0)
        de = 1.0 / torch.sqrt(torch.where(row > 1e-12, row, 1.0))
        Pd = ops.scale_P(Pd, dx)
        Ad = ops.scale_A(Ad, de, dx)
        q = dx * q
        b = de * b
        pcol = ops.P_col_max(Pd.abs())
        gamma_den = torch.maximum(pcol.mean(dim=1), q.abs().amax(dim=1))
        gamma = 1.0 / torch.where(gamma_den > 1e-12, gamma_den, 1.0)
        Pd = Pd * gamma[:, None]
        q = q * gamma[:, None]
        D = D * dx
        E = E * de
        c = c * gamma
    return Pd, Ad, q, b, D, E, c


# ------------------------------------------------------------------- ADMM


def make_matfree_admm_solver(ops: SparseOps, dims: ConeDims, n: int,
                             settings: SolverSettings):
    """solve(P_data, q, A_data, b, x0, y0, s0) -> SolveResult, never
    forming an (m, n) or (n, n) matrix and never factoring: the x-update
    runs `linsys_iters` warm-started CG steps on
    M = P + sigma I + A' diag(rho) A through matvecs. Lanes are frozen
    once they finish, as in solver/admm.py (one host read per epoch)."""
    m = dims.total
    proj_K = make_cone_projector(dims)
    proj_K_fast = make_inner_projector(dims, settings.psd_proj)
    group_ids, n_groups = _cone_row_groups(dims)
    is_eq_row_np = np.arange(m) < dims.zero
    st = settings

    def solve(P_data, q, A_data, b, x0, y0, s0):
        dtype = q.dtype
        device = q.device
        B = q.shape[0]
        # f64 keeps the exact projector in the inner loop (solver/admm.py)
        pk_fast = proj_K if dtype == torch.float64 else proj_K_fast
        Pd0, Ad0, q0, b0 = P_data, A_data, q, b

        Pds, Ads, qs, bs, D, E, c = _ruiz_equilibrate_matfree(
            ops, P_data, A_data, q, b, group_ids, n_groups,
            st.scaling_iters,
        )

        x = x0 / D
        z = E * (b0 - s0)
        y = c[:, None] * y0 / E

        is_eq_row = torch.as_tensor(is_eq_row_np, device=device)
        rho = torch.where(
            is_eq_row,
            torch.tensor(st.rho * st.rho_eq_scale, dtype=dtype,
                         device=device),
            torch.tensor(st.rho, dtype=dtype, device=device),
        ).expand(B, m)

        def unscaled(xb, zb, yb):
            return D * xb, (bs - zb) / E, (E * yb) / c[:, None]

        def M_mv(v, rho_):
            Av = ops.A_mv(Ads, v)
            return (ops.P_mv(Pds, v) + st.sigma * v
                    + ops.A_rmv(Ads, rho_ * Av))

        def proj_C(u):
            return bs - pk_fast(bs - u)

        def epoch_body(x_, z_, y_, xt, rho_, it, _status):
            x_prev, y_prev = x_, y_
            for _ in range(st.epoch):
                rhs = st.sigma * x_ - qs + ops.A_rmv(Ads, rho_ * z_ - y_)
                x_t = _cg_spd_warm(lambda v: M_mv(v, rho_), rhs, xt,
                                   st.linsys_iters)
                z_t = ops.A_mv(Ads, x_t)
                x_ = st.alpha * x_t + (1 - st.alpha) * x_
                w = st.alpha * z_t + (1 - st.alpha) * z_ + y_ / rho_
                z_ = proj_C(w)
                y_ = rho_ * (w - z_)
                xt = x_t
            xu, s_u, y_u = unscaled(x_, z_, y_)
            sc = kkt_scales(ops.A_mv(Ad0, xu), s_u, b0, ops.P_mv(Pd0, xu),
                            ops.A_rmv(Ad0, y_u), q0, xu, y_u)
            converged = within(sc, st.admm_eps_abs, st.admm_eps_rel,
                               st.eps_gap_scale)
            # infeasibility certificates on the unscaled deltas
            dxu = D * (x_ - x_prev)
            dyu = (E * (y_ - y_prev)) / c[:, None]
            pinf, dinf = banjac(dxu, dyu, ops.A_rmv(Ad0, dyu),
                                ops.A_mv(Ad0, dxu), ops.P_mv(Pd0, dxu), b0,
                                q0, proj_K, st.eps_infeas)
            if st.adaptive_rho and m:
                rho_ = rho_step(rho_, rho_ratio(sc, st)[:, None], st)
            return (x_, z_, y_, xt, rho_, it + st.epoch,
                    epoch_status(converged, pinf, dinf))

        it = torch.zeros(B, dtype=torch.int32, device=device)
        status = torch.full((B,), MAX_ITERS, dtype=torch.int32,
                            device=device)
        x, z, y, _, _, it, status = run_lanes(
            epoch_body, (x, z, y, x, rho, it, status),
            unfinished(st.max_iters))

        xu, s_u, y_u = unscaled(x, z, y)
        pobj = 0.5 * bdot(xu, ops.P_mv(Pd0, xu)) + bdot(q0, xu)
        return SolveResult(x=xu, y=y_u, s=s_u, status=status, iters=it,
                           pobj=pobj)

    return solve


# ------------------------------------------------------------------- PDHG


def make_matfree_pdhg_solver(ops: SparseOps, dims: ConeDims, n: int,
                             settings: SolverSettings):
    """Matrix-free restarted-averaged PDHG: solver/pdhg.py's loop with
    every matvec an O(nnz) SpMV. P must be structurally zero (the
    derivative wrapper refuses a quadratic objective)."""
    group_ids, n_groups = _cone_row_groups(dims)

    def equilibrate(P_data, A_data, q, b):
        return _ruiz_equilibrate_matfree(ops, P_data, A_data, q, b,
                                         group_ids, n_groups,
                                         settings.scaling_iters)

    return make_pdhg_core(dims, n, settings, ops.A_mv, ops.A_rmv,
                          equilibrate)


# -------------------------------------------------------------------- KKT


def make_matfree_kkt(ops: SparseOps, dims: ConeDims, n: int):
    """The residual map F(x, w, P_data, q, A_data, b) of kkt.make_kkt
    through SpMVs, and split(w) -> (s, y). x (B, k, n) and w (B, k, m)
    evaluate k candidate points per lane at once."""
    m = dims.total
    proj = make_cone_projector(dims)

    def residual(x, w, P_data, q, A_data, b):
        if x.ndim == 3:
            B, k = x.shape[:2]
            Pi = proj(w.reshape(B * k, m)).reshape(B, k, m)
            q, b = q[:, None], b[:, None]
        else:
            Pi = proj(w)
        y = Pi - w
        F1 = ops.P_mv(P_data, x) + q + ops.A_rmv(A_data, y)
        F2 = ops.A_mv(A_data, x) + Pi - b
        return torch.cat([F1, F2], dim=-1)

    def split(w):
        Pi = proj(w)
        return Pi, Pi - w

    return residual, split


def make_matfree_kkt_solver(ops: SparseOps, dims: ConeDims, n: int,
                            cg_iters: int = 40, schur_iters=None,
                            p_diag_only: bool = False):
    """Solve J(x, w) delta = rhs (or J' delta = rhs) per lane without
    forming J.

    Structurally diagonal P and polyhedral cones: the exact range-space
    Schur split of kkt.solve_polyhedral, (P + sigma I)^{-1} elementwise
    and S matvecs two SpMVs. Every other program: CG on the normal
    equations with operator matvecs, at every precision (CG's early end
    is the regularization the f64 polish asks for)."""
    m = dims.total
    dfactor, dapply_f = make_cone_dproj_factored(dims)
    polyhedral = dims.is_polyhedral() and p_diag_only
    n_zero = dims.zero
    if not schur_iters:
        schur_iters = max(10, min(25, n // 4 + 8))

    def solve_polyhedral_diag(w, P_data, A_data, rhs, transpose):
        r1 = rhs[:, :n]
        r2 = rhs[:, n:]
        row = torch.arange(m, device=rhs.device)
        d = torch.where(row < n_zero, 0.0, (w > 0).to(rhs.dtype))
        inact = 1.0 - d
        sig = 1e-6 * (ops.P_trace(P_data) / n + 1.0)
        pd = 1.0 / (ops.P_diag(P_data) + sig[:, None])

        def S_mv(v):
            av = ops.A_rmv(A_data, inact * v)
            return inact * ops.A_mv(A_data, pd * av) + d * v

        if not transpose:
            rhs_u = inact * r2 - inact * ops.A_mv(A_data, pd * r1)
            u = _cg_spd(S_mv, rhs_u, schur_iters)
            v1 = pd * (r1 + ops.A_rmv(A_data, inact * u))
            v2 = d * (r2 - ops.A_mv(A_data, v1)) + inact * u
            return torch.cat([v1, v2], dim=-1)

        rhs1 = r1 - ops.A_rmv(A_data, d * r2)
        rhs_u = inact * ops.A_mv(A_data, pd * rhs1) + inact * r2
        u = _cg_spd(S_mv, rhs_u, schur_iters)
        v1 = pd * (rhs1 - ops.A_rmv(A_data, inact * u))
        v2 = d * r2 + inact * u
        return torch.cat([v1, v2], dim=-1)

    def solve(x, w, P_data, q, A_data, b, rhs, transpose=False,
              regularized=False, iter_refine=False):
        del regularized  # CG on the normal equations is regularized by
        # its early end already
        if m == 0:
            # unconstrained: J = P; CG on P plus a tiny ridge
            sig = 1e-10 * (ops.P_trace(P_data) / max(n, 1) + 1.0)
            return _cg_spd(lambda v: ops.P_mv(P_data, v) + sig[:, None] * v,
                           rhs, cg_iters)
        if polyhedral:
            return solve_polyhedral_diag(w, P_data, A_data, rhs, transpose)

        dstate = dfactor(w)

        def mv(v):
            v1, v2 = v[:, :n], v[:, n:]
            Dv2 = dapply_f(dstate, v2)
            return torch.cat([
                ops.P_mv(P_data, v1) + ops.A_rmv(A_data, Dv2 - v2),
                ops.A_mv(A_data, v1) + Dv2,
            ], dim=-1)

        def mvT(u):
            u1, u2 = u[:, :n], u[:, n:]
            Au1 = ops.A_mv(A_data, u1)
            return torch.cat([
                ops.P_mv(P_data, u1) + ops.A_rmv(A_data, u2),
                dapply_f(dstate, Au1 + u2) - Au1,
            ], dim=-1)

        a_op, aT_op = (mvT, mv) if transpose else (mv, mvT)
        sol = _cg_normal(a_op, aT_op, rhs, cg_iters)
        if iter_refine:
            sol = sol + _cg_normal(a_op, aT_op, rhs - a_op(sol), cg_iters)
        return sol

    return solve


# ------------------------------------------------------------------ polish


def make_matfree_polished_solver(ops: SparseOps, dims: ConeDims, n: int,
                                 settings: SolverSettings,
                                 p_diag_only: bool = False, base=None):
    """Matrix-free ADMM (or PDHG, as `base`) + semismooth-Newton polish,
    statuses decided by the post-polish unscaled KKT residual and duality
    gap (refine.make_polished_solver's contract)."""
    m = dims.total
    if base is None:
        base = make_matfree_admm_solver(ops, dims, n, settings)
    residual, split = make_matfree_kkt(ops, dims, n)
    kkt_solve = make_matfree_kkt_solver(
        ops, dims, n, cg_iters=settings.cg_iters,
        schur_iters=settings.schur_iters, p_diag_only=p_diag_only,
    )
    # one direction a step: the f64 regularized extra direction is the
    # dense LU's rescue for a singular J, and CG-normal is regularized
    refine_xw = _newton_polish_loop(
        residual, kkt_solve, n, settings.refine_steps,
        escape=_ESCAPE_STEP, stall_factor=1.0, f64_extra_reg_dir=False,
    )

    def solve(P_data, q, A_data, b, x0, y0, s0):
        res = base(P_data, q, A_data, b, x0, y0, s0)
        x, y, s = res.x, res.y, res.s
        if settings.refine_steps > 0 and m > 0:
            x, w = refine_xw(x, s - y, P_data, q, A_data, b)
            s, y = split(w)

        # the gap certifies too: at 10^3-10^5 variables the infinity-
        # norm residuals bound nothing (the gap scales with |x|_1, |y|_1)
        sc = kkt_scales(ops.A_mv(A_data, x), s, b, ops.P_mv(P_data, x),
                        ops.A_rmv(A_data, y), q, x, y,
                        F=residual(x, s - y, P_data, q, A_data, b))
        return SolveResult(x=x, y=y, s=s,
                           status=certified(res.status, sc, settings),
                           iters=res.iters, pobj=sc.pobj)

    return solve
