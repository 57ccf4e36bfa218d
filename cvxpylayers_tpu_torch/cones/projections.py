"""Euclidean projections onto the supported cones, on batched tensors.

Counterpart of cvxpylayers_tpu/cones/projections.py. The product-cone
projector takes and returns tensors with a leading lane axis, v (B, m);
the per-family functions work elementwise on tensors of any leading shape
(the exp and power cones take one tensor per coordinate of the triple).
Everything here is

  * branchless: each case is a `torch.where` with NaN-safe guards, and
    the root finds run a fixed number of steps, so nothing reads the
    device (the exact PSD projection's `torch.linalg.eigh` is the one
    exception: it checks convergence);
  * differentiable in forward mode: the exp and power roots are found
    without gradient and then refined by symbolic Newton steps from the
    detached root, so a JVP through the refinement gives the exact
    implicit-function derivative of the projection (cones/jacobians.py
    takes the 3x3 blocks that way; nothing differentiates through the
    bisection).

Layout convention for the product cone (matches ConeDims):
  [zero | nonneg | soc blocks | exp triples | psd svec blocks | pow triples]
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..utils.precision import full_f32
from .dims import ConeDims


def _root_iters(dtype):
    """(expand, bisect) steps of the exp-cone root find: the bracket caps
    bound its width by ~60 (f32) / ~600 (f64), so 30 / 60 halvings land
    inside the basin of the trailing symbolic Newton steps."""
    if dtype == torch.float32:
        return 8, 30
    return 12, 60


def _pow_root_iters(dtype):
    """Safeguarded-Newton steps of the power-cone root."""
    return 10 if dtype == torch.float32 else 18


def _newton_bisect(h_and_dh, lo, hi, iters):
    """Root of the increasing function h on [lo, hi] by safeguarded
    Newton: each step takes the Newton iterate when it stays strictly
    inside the current bracket, the bisection midpoint otherwise.
    h_and_dh(x) returns h and its derivative in closed form."""
    x = 0.5 * (lo + hi)
    for _ in range(iters):
        hx, dhx = h_and_dh(x)
        hx = torch.where(torch.isfinite(hx), hx, torch.inf)
        # h increasing: h(x) > 0 -> root left of x
        right = hx > 0
        lo_n = torch.where(right, lo, x)
        hi_n = torch.where(right, x, hi)
        newton = torch.where(dhx.abs() > 1e-300, x - hx / dhx, lo_n - 1.0)
        inside = (newton > lo_n) & (newton < hi_n) & torch.isfinite(newton)
        x = torch.where(inside, newton, 0.5 * (lo_n + hi_n))
        lo, hi = lo_n, hi_n
    return x


# ---------------------------------------------------------------------------
# Simple cones
# ---------------------------------------------------------------------------


def project_zero(v: torch.Tensor) -> torch.Tensor:
    """Projection onto {0}. (Dual variable of equalities is free.)"""
    return torch.zeros_like(v)


def project_nonneg(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(v, 0.0)


def project_soc(v: torch.Tensor) -> torch.Tensor:
    """Project (..., d) blocks (t, x) onto the second-order cone
    ||x|| <= t."""
    t = v[..., 0]
    x = v[..., 1:]
    nx = torch.linalg.vector_norm(x, dim=-1)
    safe_nx = torch.where(nx > 0, nx, 1.0)
    coef = (t + nx) / 2.0
    boundary = torch.cat([coef[..., None], (coef / safe_nx)[..., None] * x],
                         dim=-1)
    inside = (nx <= t)[..., None]
    polar = (nx <= -t)[..., None]
    return torch.where(inside, v, torch.where(polar, 0.0, boundary))


# ---------------------------------------------------------------------------
# Exponential cone
#   Kexp = cl{(x, y, z) : y > 0, y * exp(x / y) <= z}
# The boundary projection is p = y_a * (a, 1, e^a) with
#   y_a    = ((a - 1) r0 + s0) / (a^2 - a + 1)
#   h(a)   = ((a - 1) r0 + s0) e^a - (r0 - a s0) e^{-a} - (a^2 - a + 1) t0
# and a* the root of h.
# ---------------------------------------------------------------------------


def _exp_h(a, r0, s0, t0):
    quad = a * (a - 1.0) + 1.0
    return (((a - 1.0) * r0 + s0) * torch.exp(a)
            - (r0 - a * s0) * torch.exp(-a) - quad * t0)


def _exp_dh(a, r0, s0, t0):
    """dh/da in closed form, term by term as reverse-mode autodiff of
    _exp_h sums it."""
    ea = torch.exp(a)
    ema = torch.exp(-a)
    u = (a - 1.0) * r0 + s0
    w = r0 - a * s0
    return (r0 * ea + u * ea - ((-s0) * ema + w * (-ema))
            - ((a - 1.0) + a) * t0)


def _exp_boundary_point(a, r0, s0, t0):
    quad = a * (a - 1.0) + 1.0
    y = ((a - 1.0) * r0 + s0) / quad
    y = torch.clamp_min(y, 0.0)
    return a * y, y, y * torch.exp(a)


def _in_exp_cone(r, s, t):
    """Membership in cl(Kexp) (exact, no tolerance)."""
    s_pos = s > 0
    safe_s = torch.where(s_pos, s, 1.0)
    interior = s_pos & (s * torch.exp(r / safe_s) <= t)
    ray = (~s_pos) & (s >= 0) & (r <= 0) & (t >= 0)
    return interior | ray


def _in_exp_dual(u, v, w):
    """Membership in Kexp* = cl{(u,v,w): u<0, -u e^{v/u} <= e w} ∪ {0}xR+xR+."""
    u_neg = u < 0
    safe_u = torch.where(u_neg, u, -1.0)
    interior = u_neg & (w >= 0) & (-u * torch.exp(v / safe_u) <= math.e * w)
    ray = (~u_neg) & (u <= 0) & (v >= 0) & (w >= 0)
    return interior | ray


@torch.no_grad()
def _exp_solve_root(r0, s0, t0):
    """The root a* of h by bracket expansion + bisection, without
    gradient (the derivative comes from the symbolic Newton steps after).

    The bracket is capped by dtype (30 in f32, 300 in f64): e^|a| must
    stay finite, and roots beyond the cap are indistinguishable from the
    degenerate faces at that precision anyway."""
    big = 30.0 if r0.dtype == torch.float32 else 300.0
    r_pos = r0 > 0
    s_pos = s0 > 0
    lo = torch.where(r_pos, 1.0 - s0 / torch.where(r_pos, r0, 1.0), -big)
    hi = torch.where(s_pos, r0 / torch.where(s_pos, s0, 1.0), big)
    lo = torch.clamp(lo, -big, big)
    hi = torch.clamp(hi, -big, big)
    lo = torch.minimum(lo, hi)  # guard degenerate ordering
    # both ends are evaluated as one stacked tensor: elementwise, so each
    # end's h is the one the reference computes
    ends = torch.stack([lo, hi])
    coef = tuple(torch.stack([c, c]) for c in (r0, s0, t0))
    h_ends = _exp_h(ends, *coef)

    n_expand, n_bisect = _root_iters(r0.dtype)
    for _ in range(n_expand):
        lo, hi = ends[0], ends[1]
        pos = h_ends > 0
        # sign comparison, not a product: h values can be +-1e200 and
        # their product overflows
        no_bracket = pos[0] == pos[1]
        width = torch.clamp_min(hi - lo, 1.0)
        # both positive: extend lo downward; both negative: hi upward
        both_pos = no_bracket & pos[0]
        both_neg = no_bracket & ~pos[0]
        new_ends = torch.stack([
            torch.clamp_min(torch.where(both_pos, lo - width, lo), -big),
            torch.clamp_max(torch.where(both_neg, hi + width, hi), big),
        ])
        moved = torch.stack([both_pos, both_neg])
        h_ends = torch.where(moved, _exp_h(new_ends, *coef), h_ends)
        ends = new_ends

    # pure bisection: Newton on h crawls far from the root, halvings are
    # guaranteed. The sign of h at lo never changes (lo only moves to a
    # midpoint of the same sign), so it is read once.
    lo, hi = ends[0], ends[1]
    lo_pos = h_ends[0] > 0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        same = (_exp_h(mid, r0, s0, t0) > 0) == lo_pos
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
    return 0.5 * (lo + hi)


def _exp_from_root(r0, s0, t0, a0):
    """The exp-cone projection of (r0, s0, t0) given the detached root
    a0: three symbolic Newton steps (differentiable in (r0, s0, t0), so
    a JVP yields the implicit-function derivative of the root), the
    boundary point, the cliff/face safety net and the case selection.
    Pure: no in-place writes."""
    in_cone = _in_exp_cone(r0, s0, t0)
    # polar cone K° = -K*: v in K° iff -v in K*
    in_polar = _in_exp_dual(-r0, -s0, -t0)
    # degenerate quadrant: r0 <= 0, s0 <= 0 projects onto the ray face
    degenerate = (r0 <= 0) & (s0 <= 0)

    a = a0
    for _ in range(3):
        h = _exp_h(a, r0, s0, t0)
        dh = _exp_dh(a, r0, s0, t0)
        a = a - h / torch.where(dh.abs() > 1e-12, dh, 1.0)
    bx, by, bz = _exp_boundary_point(a, r0, s0, t0)

    # safety net for the exponential cliff: when the root is large,
    # y* ~ t0 e^{-a} is unrepresentable next to the cancellation error of
    # (a - 1) r0 + s0 and the boundary point explodes. The y = 0 face
    # point (min(r0, 0), 0, max(t0, 0)) is always in cl(Kexp) and is the
    # limit of the boundary there: take whichever is closer to v.
    fx = torch.clamp_max(r0, 0.0)
    fy = torch.zeros_like(s0)
    fz = torch.clamp_min(t0, 0.0)
    b_ok = torch.isfinite(bx) & torch.isfinite(by) & torch.isfinite(bz)
    d_b = torch.where(
        b_ok, (r0 - bx) ** 2 + (s0 - by) ** 2 + (t0 - bz) ** 2, torch.inf)
    d_f = (r0 - fx) ** 2 + (s0 - fy) ** 2 + (t0 - fz) ** 2
    pick_b = b_ok & (d_b <= d_f)
    bx = torch.where(pick_b, bx, fx)
    by = torch.where(pick_b, by, fy)
    bz = torch.where(pick_b, bz, fz)

    # degenerate quadrant: (r0, 0, max(t0, 0))
    dx, dy, dz = r0, torch.zeros_like(s0), torch.clamp_min(t0, 0.0)

    def pick(v0, d, b):
        return torch.where(in_cone, v0, torch.where(
            in_polar, 0.0, torch.where(degenerate, d, b)))

    return pick(r0, dx, bx), pick(s0, dy, by), pick(t0, dz, bz)


def project_exp(v: torch.Tensor) -> torch.Tensor:
    """Project (..., 3) triples onto the primal exponential cone."""
    r0, s0, t0 = v[..., 0], v[..., 1], v[..., 2]
    a0 = _exp_solve_root(r0, s0, t0)
    return torch.stack(_exp_from_root(r0, s0, t0, a0), dim=-1)


# ---------------------------------------------------------------------------
# 3-D power cone
#   Kpow(a) = {(x, y, z) : x^a y^(1-a) >= |z|, x >= 0, y >= 0}
# Projection via a 1-D root find on r in (0, |z0|): the boundary point is
#   x = 0.5 (x0 + sqrt(x0^2 + 4 a r (|z0| - r)))
#   y = 0.5 (y0 + sqrt(y0^2 + 4 (1-a) r (|z0| - r)))
#   z = sign(z0) r, with r the root of g(r) = x^a y^(1-a) - r.
# ---------------------------------------------------------------------------


def _pow_xy(r, x0, y0, az, alpha):
    """Candidate boundary (x, y) for the multiplier-parametrized
    projection."""
    xx = 0.5 * (x0 + torch.sqrt(x0 * x0 + 4.0 * alpha * r * (az - r)))
    yy = 0.5 * (y0 + torch.sqrt(y0 * y0 + 4.0 * (1.0 - alpha) * r
                                * (az - r)))
    return xx, yy


def _pow_g_dg(r, x0, y0, az, alpha):
    """g(r) and dg/dr in closed form (the derivative reverse-mode autodiff
    of the reference's g takes, with the 1e-300 floors passing no
    gradient below them)."""
    ux = x0 * x0 + 4.0 * alpha * r * (az - r)
    uy = y0 * y0 + 4.0 * (1.0 - alpha) * r * (az - r)
    sx = torch.sqrt(ux)
    sy = torch.sqrt(uy)
    xx = 0.5 * (x0 + sx)
    yy = 0.5 * (y0 + sy)
    dxx = 0.5 * (4.0 * alpha * ((az - r) - r)) * 0.5 / sx
    dyy = 0.5 * (4.0 * (1.0 - alpha) * ((az - r) - r)) * 0.5 / sy
    dxx = torch.where(xx > 1e-300, dxx, 0.0)
    dyy = torch.where(yy > 1e-300, dyy, 0.0)
    xx = torch.clamp_min(xx, 1e-300)
    yy = torch.clamp_min(yy, 1e-300)
    geo = torch.exp(alpha * torch.log(xx) + (1.0 - alpha) * torch.log(yy))
    dg = geo * (alpha * dxx / xx + (1.0 - alpha) * dyy / yy) - 1.0
    return geo - r, dg


def _in_pow_cone(x, y, z, alpha):
    ok = (x >= 0) & (y >= 0)
    sx = torch.clamp_min(x, 0.0)
    sy = torch.clamp_min(y, 0.0)
    # x^a y^(1-a) >= |z| with 0^anything handled by where
    val = torch.where(
        (sx > 0) & (sy > 0),
        torch.exp(alpha * torch.log(torch.where(sx > 0, sx, 1.0))
                  + (1.0 - alpha) * torch.log(torch.where(sy > 0, sy, 1.0))),
        0.0,
    )
    return ok & (val >= z.abs())


def _in_pow_polar(x, y, z, alpha):
    # v in K° iff -v in K*: (u, v, w) = (-x, -y, -z); need u, v >= 0 and
    # (u/a)^a (v/(1-a))^(1-a) >= |w|
    return _in_pow_cone(-x / alpha, -y / (1.0 - alpha), z, alpha)


@torch.no_grad()
def _pow_solve_root(x0, y0, z0, alpha):
    """The root r of g on (0, |z0|) by safeguarded Newton on the
    increasing -g, without gradient."""
    az_safe = torch.clamp_min(z0.abs(), 1e-30)

    def h_and_dh(rr):
        g, dg = _pow_g_dg(rr, x0, y0, az_safe, alpha)
        return -g, -dg

    return _newton_bisect(h_and_dh, torch.zeros_like(az_safe), az_safe,
                          _pow_root_iters(x0.dtype))


def _pow_from_root(x0, y0, z0, alpha, r0):
    """The power-cone projection given the detached root r0: two symbolic
    Newton steps, the boundary point and the case selection. Pure."""
    in_cone = _in_pow_cone(x0, y0, z0, alpha)
    in_polar = _in_pow_polar(x0, y0, z0, alpha)
    # the az == 0 limit degenerates to clamping x, y at 0, which the
    # closed form reproduces as r -> 0: a floor on the bracket instead of
    # a separate branch
    az_safe = torch.clamp_min(z0.abs(), 1e-30)
    r = r0
    for _ in range(2):
        g, dg = _pow_g_dg(r, x0, y0, az_safe, alpha)
        r = r - g / torch.where(dg.abs() > 1e-12, dg, 1.0)
    r = torch.minimum(torch.clamp_min(r, 0.0), az_safe)
    xx, yy = _pow_xy(r, x0, y0, az_safe, alpha)
    zz = torch.sign(z0) * r

    def pick(v0, b):
        return torch.where(in_cone, v0, torch.where(in_polar, 0.0, b))

    return pick(x0, xx), pick(y0, yy), pick(z0, zz)


def project_pow3(v: torch.Tensor, alpha) -> torch.Tensor:
    """Project (..., 3) triples onto the 3-D power cones with powers
    `alpha` (a number or a tensor broadcasting against v[..., 0])."""
    x0, y0, z0 = v[..., 0], v[..., 1], v[..., 2]
    alpha = torch.as_tensor(alpha, dtype=v.dtype, device=v.device)
    r0 = _pow_solve_root(x0, y0, z0, alpha)
    return torch.stack(_pow_from_root(x0, y0, z0, alpha, r0), dim=-1)


# ---------------------------------------------------------------------------
# PSD cone in svec coordinates
# ---------------------------------------------------------------------------


def svec_indices(s: int):
    """Row/col index lists for the scaled lower-triangular vectorization.

    svec ordering is column-major lower triangle: (0,0), (1,0), ..., (s-1,0),
    (1,1), ..."""
    rows = []
    cols = []
    for j in range(s):
        for i in range(j, s):
            rows.append(i)
            cols.append(j)
    return rows, cols


def _svec_scale(r, c, off_diag, like):
    """The svec scale per entry in `like`'s dtype: 1 on the diagonal,
    `off_diag` elsewhere. Built in that dtype (a torch.where of Python
    numbers would round the constant to float32 first)."""
    scale = torch.ones(r.shape, dtype=like.dtype, device=like.device)
    scale[r != c] = off_diag
    return scale


def svec_to_sym(v: torch.Tensor, s: int) -> torch.Tensor:
    """Unpack svec (..., s(s+1)/2), off-diag scaled by sqrt(2), to
    (..., s, s)."""
    rows, cols = svec_indices(s)
    r = torch.tensor(rows, device=v.device)
    c = torch.tensor(cols, device=v.device)
    scale = _svec_scale(r, c, 1.0 / math.sqrt(2.0), v)
    M = v.new_zeros(v.shape[:-1] + (s, s))
    M[..., r, c] = v * scale
    M[..., c, r] = v * scale
    return M


def sym_to_svec(M: torch.Tensor) -> torch.Tensor:
    """Pack symmetric (..., s, s) matrices into svec with sqrt(2)-scaled
    off-diagonals."""
    s = M.shape[-1]
    rows, cols = svec_indices(s)
    r = torch.tensor(rows, device=M.device)
    c = torch.tensor(cols, device=M.device)
    return M[..., r, c] * _svec_scale(r, c, math.sqrt(2.0), M)


def project_psd_svec(v: torch.Tensor, s: int) -> torch.Tensor:
    """Project svec-packed blocks (..., s(s+1)/2) onto the PSD cone
    (eigenvalue clamping; `torch.linalg.eigh` reads the device once to
    check convergence)."""
    M = svec_to_sym(v, s)
    w, U = torch.linalg.eigh(M)
    w = torch.clamp_min(w, 0.0)
    with full_f32():
        P = (U * w[..., None, :]) @ U.mT
    return sym_to_svec(P)


# rounds of the Newton-Schulz sign iteration: 12 drops the 16x16 SDP
# class's solved fraction to 0.89 in the reference's measurements
_NS_SIGN_ITERS = 18


def project_psd_svec_ns(v: torch.Tensor, s: int) -> torch.Tensor:
    """Matmul-only approximate PSD projection via the Newton-Schulz
    matrix-sign iteration: Pi(M) = (M + M sign(M)) / 2 with sign(M)
    approximated by 18 rounds of Y <- 1.5 Y - 0.5 Y^3 on the
    Frobenius-normalized block. A smoothed projection (eigenvalues within
    ~1e-3 of zero relative to ||M|| are soft-thresholded) that the ADMM
    iteration absorbs; statuses, certificates and the polish keep the
    exact projector. Full f32 products: TF32 would floor the sign
    iteration at ~1e-3."""
    M = svec_to_sym(v, s)
    with full_f32():
        c = torch.sqrt((M * M).sum(dim=(-2, -1))) + 1e-30
        Y = M / c[..., None, None]
        for _ in range(_NS_SIGN_ITERS):
            Y = 1.5 * Y - 0.5 * (Y @ (Y @ Y))
        P = 0.5 * (M + M @ Y)
        P = 0.5 * (P + P.mT)
    return sym_to_svec(P)


# ---------------------------------------------------------------------------
# Product cone
# ---------------------------------------------------------------------------


def _group_runs(sizes):
    """Group a sequence of block sizes into runs of equal size for
    batching."""
    runs = []
    for d in sizes:
        if runs and runs[-1][0] == d:
            runs[-1][1] += 1
        else:
            runs.append([d, 1])
    return runs


def make_cone_projector(
    dims: ConeDims, psd_mode: str = "exact"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build Pi_K for the product cone described by `dims`: a function
    v (B, m) -> Pi_K(v) (B, m).

    psd_mode: "exact" (batched eigh, required wherever the result feeds
    an accuracy decision) or "ns" (the matmul-only Newton-Schulz
    approximation, the first-order inner loop's fast path)."""
    n_zero = dims.zero
    if dims.is_polyhedral():

        def project_polyhedral(v: torch.Tensor) -> torch.Tensor:
            out = project_nonneg(v)
            if n_zero:
                out[..., :n_zero] = 0.0
            return out

        return project_polyhedral

    soc_runs = _group_runs(dims.soc)
    psd_runs = _group_runs(dims.psd)
    psd_proj = project_psd_svec_ns if psd_mode == "ns" else project_psd_svec
    pow_alphas = np.array(dims.pow3) if dims.pow3 else None

    def project(v: torch.Tensor) -> torch.Tensor:
        B = v.shape[0]
        parts = []
        off = 0
        if dims.zero:
            parts.append(torch.zeros_like(v[:, :dims.zero]))
            off += dims.zero
        if dims.nonneg:
            parts.append(torch.clamp_min(v[:, off:off + dims.nonneg], 0.0))
            off += dims.nonneg
        for d, nblk in soc_runs:
            seg = v[:, off:off + d * nblk].reshape(B, nblk, d)
            parts.append(project_soc(seg).reshape(B, -1))
            off += d * nblk
        if dims.exp:
            seg = v[:, off:off + 3 * dims.exp].reshape(B, dims.exp, 3)
            parts.append(project_exp(seg).reshape(B, -1))
            off += 3 * dims.exp
        for s, nblk in psd_runs:
            d = s * (s + 1) // 2
            seg = v[:, off:off + d * nblk].reshape(B, nblk, d)
            parts.append(psd_proj(seg, s).reshape(B, -1))
            off += d * nblk
        if dims.pow3:
            npw = len(dims.pow3)
            seg = v[:, off:off + 3 * npw].reshape(B, npw, 3)
            alphas = torch.as_tensor(pow_alphas, dtype=v.dtype,
                                     device=v.device)
            parts.append(project_pow3(seg, alphas).reshape(B, -1))
            off += 3 * npw
        if not parts:
            return v[:, :0]
        return torch.cat(parts, dim=1)

    return project


def make_inner_projector(dims: ConeDims, psd_proj: str):
    """Pi_K for a first-order inner loop (solver/admm.py, solver/shared.py)
    in f32: PSD blocks by the Newton-Schulz approximation under psd_proj
    "auto" or "ns", by exact eigh under "exact". Statuses, certificates,
    the polish and every f64 inner loop keep the exact projector."""
    ns = psd_proj in ("auto", "ns") and dims.psd
    return make_cone_projector(dims, psd_mode="ns" if ns else "exact")


def make_dual_cone_projector(dims: ConeDims):
    """Pi_{K*} via the Moreau decomposition: Pi_{K*}(v) = v + Pi_K(-v)."""
    proj = make_cone_projector(dims)

    def project_dual(v: torch.Tensor) -> torch.Tensor:
        return v + proj(-v)

    return project_dual
