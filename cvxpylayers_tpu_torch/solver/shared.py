"""Shared-data batched ADMM: the constant-P/A setup/solve split.

Counterpart of cvxpylayers_tpu/solver/shared.py. When P and A do not
depend on any parameter, every lane of a batch would factor the same
(n, n) matrix each epoch. Here the factorization is hoisted out of the
batch:

  * the Ruiz equilibration of (P, A) runs once, on the host in numpy
    f64, when the solver is built;
  * ONE (n, n) explicit inverse per epoch feeds every lane, and each
    inner step is three (B, .) @ (., .) products against shared operands;
  * rho stays one (m,) vector for the whole batch, so the adaptive update
    pools the per-lane residual ratios (geometric mean over the active
    lanes) into one scalar step; the cost scale c is pooled the same way
    (the median of the per-lane scales), since a per-lane scale would
    scale P per lane and break the shared factor;
  * residuals, the duality gap, statuses and the Banjac certificates stay
    per lane, on the unscaled data, and a finished lane is frozen.

The layer composes this with the per-instance machinery: the shared solve
gives warm starts and certificates, then the per-instance polish and the
implicit adjoint (diff/derivative.py) run with `max_iters=0`.

There is no hand-written kernel on this route: the inner step is plain
large matrix products, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cones.dims import ConeDims
from ..cones.projections import make_cone_projector, make_inner_projector
from ..utils.precision import full_f32
from .admm import SolveResult, _cone_row_groups
from .settings import MAX_ITERS, SolverSettings
from .stopping import (
    amax_abs,
    banjac,
    bdot,
    epoch_status,
    freeze,
    kkt_scales,
    rho_ratio,
    rho_step,
    within,
)


def _ruiz_host(P, A, group_ids, n_groups, iters: int):
    """Host-side (numpy, f64) Ruiz equilibration of [[P, A'], [A, 0]]
    with per-cone-block row pooling: the recurrence of
    admm._ruiz_equilibrate without the cost scaling (pooled at run time).
    Runs once, when the solver is built."""
    P = np.asarray(P, np.float64).copy()
    A = np.asarray(A, np.float64).copy()
    n = P.shape[0]
    m = A.shape[0]
    D = np.ones(n)
    E = np.ones(m)
    for _ in range(max(iters, 0)):
        col = np.maximum(
            np.abs(P).max(axis=0) if n else np.zeros(0),
            np.abs(A).max(axis=0) if m else np.zeros(n),
        )
        dx = 1.0 / np.sqrt(np.where(col > 1e-12, col, 1.0))
        row = np.abs(A).max(axis=1) if n else np.zeros(m)
        if m:
            pooled = np.zeros(n_groups)
            np.maximum.at(pooled, group_ids, row)
            row = pooled[group_ids]
        de = 1.0 / np.sqrt(np.where(row > 1e-12, row, 1.0))
        P = dx[:, None] * P * dx[None, :]
        A = de[:, None] * A * dx[None, :]
        D *= dx
        E *= de
    return P, A, D, E


def _median(v: torch.Tensor) -> torch.Tensor:
    """The median of a 1-D tensor, the mean of the two middle values for
    an even length (`jnp.median`'s rule; `torch.median` returns the lower
    one)."""
    s = torch.sort(v).values
    k = v.shape[0]
    return (s[(k - 1) // 2] + s[k // 2]) * 0.5


def make_shared_admm_solver(dims: ConeDims, n: int,
                            settings: SolverSettings, P_const, A_const):
    """Build solve(q, b, x0, y0, s0) over a leading batch axis on
    q/b/x0/y0/s0, with P_const (n, n) and A_const (m, n) fixed. Returns
    a batched SolveResult. The epoch loop reads one `any()` from the
    device per epoch to know when every lane has stopped."""
    m = dims.total
    assert m > 0, "shared route requires constraints"
    proj_K = make_cone_projector(dims)
    proj_K_fast = make_inner_projector(dims, settings.psd_proj)
    group_ids, n_groups = _cone_row_groups(dims)
    st = settings

    Ps_np, As_np, D_np, E_np = _ruiz_host(
        P_const, A_const, group_ids, n_groups, st.scaling_iters
    )
    # mean column norm of the scaled P: the P part of the cost scaling
    # (constant; the q part pools at run time)
    pcol_mean = float(np.abs(Ps_np).max(axis=0).mean()) if n else 0.0
    is_eq_row = np.arange(m) < dims.zero
    host = {"P0": np.asarray(P_const, np.float64),
            "A0": np.asarray(A_const, np.float64),
            "Ps": Ps_np, "As": As_np, "D": D_np, "E": E_np}
    consts = {}

    def constants(dtype, device):
        """The fixed operands on (dtype, device), copied there once."""
        key = (dtype, device)
        if key not in consts:
            consts[key] = {k: torch.as_tensor(v, dtype=dtype, device=device)
                           for k, v in host.items()}
        return consts[key]

    def solve(q, b, x0, y0, s0):
        # always full-f32 products in here: the shared route's point is
        # batching the per-lane matvecs into (B, m) @ (m, n) products,
        # which TF32 would floor at ~1e-3 relative
        with full_f32():
            return _solve(q, b, x0, y0, s0)

    def _solve(q, b, x0, y0, s0):
        dtype = q.dtype
        device = q.device
        B = q.shape[0]
        cs = constants(dtype, device)
        # f64 keeps the exact projector in the inner loop (solver/admm.py)
        pk = proj_K if dtype == torch.float64 else proj_K_fast
        P0, A0, Ps, As, D, E = (cs[k] for k in ("P0", "A0", "Ps", "As",
                                                 "D", "E"))
        eye = torch.eye(n, dtype=dtype, device=device)

        qs_raw = q * D[None, :]
        bs = b * E[None, :]
        # pooled cost scaling: ONE scalar c for the whole batch, from the
        # median of the per-lane denominators of admm.py
        gden = _median(amax_abs(qs_raw))
        gden = torch.clamp_min(gden, pcol_mean)
        c = 1.0 / torch.where(gden > 1e-12, gden, 1.0)
        qs = c * qs_raw

        X = x0 / D[None, :]
        Z = E[None, :] * (b - s0)
        Y = c * y0 / E[None, :]

        rho = torch.where(
            torch.as_tensor(is_eq_row, device=device),
            torch.tensor(st.rho * st.rho_eq_scale, dtype=dtype,
                         device=device),
            torch.tensor(st.rho, dtype=dtype, device=device),
        )

        def factor(rho):
            """ONE (n, n) explicit inverse per epoch, shared by every
            lane: a Cholesky and two triangular solves. A failed factor
            flows on as NaN, as the reference's does."""
            M = c * Ps + st.sigma * eye + (As.T * rho) @ As
            L, info = torch.linalg.cholesky_ex(M)
            z_ = torch.linalg.solve_triangular(L, eye, upper=False)
            Minv = torch.linalg.solve_triangular(L.T, z_, upper=True)
            return torch.where(info == 0, Minv, torch.nan)

        def unscaled(Xb, Zb, Yb):
            Xu = Xb * D[None, :]
            Su = (bs - Zb) / E[None, :]
            Yu = (Yb * E[None, :]) / c
            return Xu, Su, Yu

        def inner(X_, Z_, Y_, Minv, rho):
            RHS = st.sigma * X_ - qs + (Z_ * rho[None, :] - Y_) @ As
            Xt = RHS @ Minv  # Minv symmetric
            Zt = Xt @ As.T
            Xn = st.alpha * Xt + (1 - st.alpha) * X_
            W = st.alpha * Zt + (1 - st.alpha) * Z_ + Y_ / rho[None, :]
            Zn = bs - pk(bs - W)
            Yn = rho[None, :] * (W - Zn)
            return Xn, Zn, Yn

        def epoch_body(X_, Z_, Y_, rho, it, status, active):
            Minv = factor(rho)
            Xp, Yp = X_, Y_
            Xn, Zn, Yn = X_, Z_, Y_
            for _ in range(st.epoch):
                Xn, Zn, Yn = inner(Xn, Zn, Yn, Minv, rho)
            # freeze finished lanes (the vmapped while_loop's contract)
            X_, Z_, Y_ = freeze(active, (Xn, Zn, Yn), (X_, Z_, Y_))
            it = it + torch.where(active, st.epoch, 0).to(torch.int32)

            # per-lane verdicts on the unscaled data (solver/stopping.py)
            Xu, Su, Yu = unscaled(X_, Z_, Y_)
            sc = kkt_scales(Xu @ A0.T, Su, b, Xu @ P0.T, Yu @ A0, q, Xu, Yu)
            converged = within(sc, st.admm_eps_abs, st.admm_eps_rel,
                               st.eps_gap_scale)
            dXu = (X_ - Xp) * D[None, :]
            dYu = ((Y_ - Yp) * E[None, :]) / c
            pinf, dinf = banjac(dXu, dYu, dYu @ A0, dXu @ A0.T, dXu @ P0.T,
                                b, q, proj_K, st.eps_infeas)
            status = freeze(active, epoch_status(converged, pinf, dinf),
                            status)
            active = status == MAX_ITERS

            # ---- pooled adaptive rho (one scalar step) -----------------
            if st.adaptive_rho:
                # geometric mean of the per-lane ratios over the still-
                # active lanes; inert (= 1) when none is active
                w_act = active.to(dtype)
                n_act = torch.clamp_min(w_act.sum(), 1.0)
                pooled = torch.exp(
                    (torch.log(rho_ratio(sc, st)) * w_act).sum() / n_act)
                rho = torch.where(active.any(), rho_step(rho, pooled, st),
                                  rho)
            return X_, Z_, Y_, rho, it, status, active

        it = torch.zeros(B, dtype=torch.int32, device=device)
        status = torch.full((B,), MAX_ITERS, dtype=torch.int32,
                            device=device)
        active = torch.ones(B, dtype=torch.bool, device=device)
        k = 0
        while k * st.epoch < st.max_iters and bool(active.any()):
            X, Z, Y, rho, it, status, active = epoch_body(
                X, Z, Y, rho, it, status, active
            )
            k += 1

        Xu, Su, Yu = unscaled(X, Z, Y)
        pobj = 0.5 * bdot(Xu, Xu @ P0.T) + bdot(q, Xu)
        return SolveResult(x=Xu, y=Yu, s=Su, status=status, iters=it,
                           pobj=pobj)

    return solve
