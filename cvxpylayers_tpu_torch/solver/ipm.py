"""Primal-dual interior-point solver for the full cone family, batched:
Zero, NonNeg, SOC, PSD (symmetric: Nesterov-Todd scalings) and Exp, Pow3
(nonsymmetric: primal barrier-Hessian scalings).

Counterpart of cvxpylayers_tpu/solver/ipm.py::make_ipm_solver, in its
primal-dual form and its homogeneous self-dual embedding (HSDE).
`solve_method="ipm"` in solver_args selects it; `ipm_mode` picks the form
(diff/derivative.py: "auto" takes the embedding when P is structurally
zero and every cone is symmetric).

Problem form:  min (1/2)x'Px + q'x  s.t.  A x + s = b, s in K.

Algorithm (Mehrotra predictor-corrector): every Newton system uses a
block-diagonal scaling matrix T with T z ~= s on the central path:

  * NonNeg:  T = diag(s/z)                      (NT, closed form)
  * SOC:     T = W^2, W the NT Householder form (closed form)
  * PSD:     T = W (x)_s W with W Z W = S       (NT via two eigh)
  * Exp/Pow: T = (1/mu) H_f(s)^{-1}             (primal barrier Hessian,
             3x3; barriers in cones/barriers.py)

and eliminates ds, giving the quasidefinite KKT system
[[P, Aeq', Ain'], [Aeq, 0, 0], [Ain, 0, -T]]. T, its inverse and the
factor B with B'B = T^{-1} are kept per block: the nonneg diagonal as a
(B, l) vector and one (B, k, d, d) tile for each group of k equal blocks
(`_block_groups`), applied block by block (`bd_mv`, `bd_mm`).

  * f64: exact dense LU of the KKT matrix, factored once per iteration
    and solved for the predictor and the corrector;
  * f32: exact condensation. dz is eliminated through T^{-1}, and the
    n x n SPD S = P + sigma I + Ain' T^{-1} Ain is factored through the
    QR of the stacked M = [Lp'; B Ain] (S = M'M): the R factor comes from
    kernel K2 (solver/cuda_linalg.py::qr_r) on a CUDA tensor, whose
    error scales with eps sqrt(cond(S)) where a Cholesky of S would give
    eps cond(S). One refinement pass against the cached factors follows.
    Above batched_linalg.MASKED_MAX_DIM, ipm_kkt "auto"/"chol" takes the
    Jacobi-scaled Cholesky of M'M with a non-finite guard; "qr" keeps K2.
  * step lengths: the exact ratio test for NonNeg and SOC, the eigenvalue
    bound for PSD, and for Exp/Pow the largest point of a fixed geometric
    grid whose endpoint is strictly interior (one (B, k, 192) membership
    test per family). A step is accepted at the largest of four
    candidates whose endpoint is finite and strictly interior; the
    lowest-merit iterate is returned;
  * infeasibility: almost-certificate checks on normalized iterates.

Every array carries the batch axis first. Lanes are frozen as the
reference's vmapped while_loop freezes them: a lane stops once its
status leaves MAX_ITERS, its count reaches ipm_max_iters or it stalls
three times in a row, and from then on its iterate, count, stall
counter and best iterate no longer change. The loop
(`stopping.run_lanes`) reads one `any()` per iteration from the device
to know when every lane has stopped; on a program with PSD blocks each
`torch.linalg.eigh` / `eigvalsh` call reads it once more (it checks
convergence).

The embedding (`hsde=True`, P = 0) adds the homogenizing pair (tau,
kappa), one (B,) vector each: infeasibility becomes an intrinsic verdict
(tau -> 0 with kappa > 0 and the certificate in the iterate), and each
iteration solves against its one factorization three times (the tau
column, the predictor and the corrector), so in f32 at n <= 160 it is a
second path through K2.

Every product runs in full f32 (`full_f32`), whatever the caller's TF32
setting: the reference pins the condensation and its refinement to the
"highest" precision, and the residuals here are cancellations too.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..cones.barriers import (
    EXP_DUAL_INTERIOR,
    EXP_PRIMAL_INTERIOR,
    POW_INTERIOR,
    exp_grad,
    exp_hess,
    pow_grad,
    pow_hess,
)
from ..cones.dims import ConeDims
from ..cones.projections import (
    _group_runs,
    eigh,
    make_cone_projector,
    svec_indices,
    svec_to_sym,
    sym_to_svec,
)
from ..utils.precision import full_f32
from ..utils.profiling import count, spanned
from .admm import SolveResult, bmv, bmv_t
from .batched_linalg import use_masked
from .cuda_linalg import qr_r
from .settings import (
    DUAL_INFEASIBLE,
    MAX_ITERS,
    PRIMAL_INFEASIBLE,
    SOLVED,
    SolverSettings,
)
from .stopping import amax_abs, bdot, run_lanes

_TINY = 1e-30

# the step acceptance's candidates, as fractions of the ratio-test step
_CANDIDATES = (0.125, 0.25, 0.5, 1.0)


def _trip(body):
    """body as one trip of the IPM loop: counted (`ipm_trips`) and
    inside the span `ipm.iteration`."""
    traced = spanned("ipm.iteration")(body)

    def trip(*state):
        count("ipm_trips")
        return traced(*state)
    return trip


def _nan_unless(info: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """L where cholesky_ex reports success (info == 0), NaN elsewhere: a
    failed factor must flow on as NaN into the step-acceptance guards
    instead of raising."""
    return torch.where((info == 0)[:, None, None], L, torch.nan)


def _finite_rows(v: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(v).all(dim=-1)


def _block_layout(dims: ConeDims):
    """Static (family, offset-within-inequality-segment, meta) blocks, in
    the order nonneg, SOC, exp, PSD, pow; meta is the SOC size, the PSD
    side or the power."""
    blocks = []
    off = dims.nonneg
    for d in dims.soc:
        blocks.append(("soc", off, d))
        off += d
    for _ in range(dims.exp):
        blocks.append(("exp", off, None))
        off += 3
    for s in dims.psd:
        blocks.append(("psd", off, s))
        off += s * (s + 1) // 2
    for a in dims.pow3:
        blocks.append(("pow", off, float(a)))
        off += 3
    return blocks, off  # off == total inequality rows


class _Group(NamedTuple):
    """k consecutive blocks of one family and one width d, from row `off`
    of the inequality segment; meta is the PSD side, or the powers of a
    power-cone group (one per block)."""
    fam: str
    off: int
    k: int
    d: int
    meta: object


def _block_groups(dims: ConeDims) -> List[_Group]:
    """The blocks of _block_layout batched by family, and by equal size
    for SOC and PSD (`_group_runs`): every exp triple is one group, and so
    is every power triple."""
    groups = []
    off = dims.nonneg
    for d, k in _group_runs(dims.soc):
        groups.append(_Group("soc", off, k, d, None))
        off += k * d
    if dims.exp:
        groups.append(_Group("exp", off, dims.exp, 3, None))
        off += 3 * dims.exp
    for side, k in _group_runs(dims.psd):
        D = side * (side + 1) // 2
        groups.append(_Group("psd", off, k, D, side))
        off += k * D
    if dims.pow3:
        groups.append(_Group("pow", off, len(dims.pow3), 3, dims.pow3))
    return groups


# geometric step-length grid for the nonsymmetric ratio test: 192 points
# from 1.0 down to ~1e-6 (ratio ~0.93: at most ~7% step loss an
# iteration; the deep tail matters near convergence, where an exp/pow
# block hugging its boundary otherwise reports no feasible step)
_GRID = 0.930572 ** np.arange(192)


def _grid_max_step(member, v, dv):
    """Largest grid alpha whose endpoint v + alpha dv stays strictly
    interior, for stacks of triples v, dv (..., 3) -> (...).

    member maps candidate triples (..., 192, 3) to booleans (..., 192):
    the whole grid is tested at once and the passing points' maximum
    taken. Convexity makes the feasible alphas an interval, so endpoint
    checks suffice. The grid is built in float64 and cast to the iterate's
    dtype, as the reference casts it."""
    grid = torch.as_tensor(_GRID, dtype=v.dtype, device=v.device)
    ok = member(v[..., None, :] + grid[:, None] * dv[..., None, :])
    return torch.where(ok, grid, 0.0).amax(dim=-1)


def _exp_interior(v):
    """Strict interior of the exp cone, for triples (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    ypos = y > _TINY
    zpos = z > _TINY
    psi = torch.where(ypos & zpos, y * torch.log(
        torch.where(zpos, z, 1.0) / torch.where(ypos, y, 1.0)) - x, -1.0)
    return ypos & zpos & (psi > _TINY)


def _exp_dual_interior(v):
    """Strict interior of K* = cl{(u,v,w): u < 0, -u e^{v/u} <= e w}, in
    the log form log(-u) + v/u < 1 + log(w)."""
    u, vv, w = v[..., 0], v[..., 1], v[..., 2]
    uneg = u < -_TINY
    wpos = w > _TINY
    val = torch.where(
        uneg & wpos,
        torch.log(torch.where(uneg, -u, 1.0)) + vv / torch.where(uneg, u, -1.0)
        - 1.0 - torch.log(torch.where(wpos, w, 1.0)),
        1.0,
    )
    return uneg & wpos & (val < 0.0)


def _pow_interior(v, alpha):
    """Strict interior of the power cone with power alpha (broadcasting
    against v[..., 0])."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    xpos = x > _TINY
    ypos = y > _TINY
    val = torch.where(
        xpos & ypos,
        torch.exp(2 * alpha * torch.log(torch.where(xpos, x, 1.0))
                  + 2 * (1 - alpha) * torch.log(torch.where(ypos, y, 1.0)))
        - z * z,
        -1.0,
    )
    return xpos & ypos & (val > _TINY)


def _pow_dual_interior(v, alpha):
    """K*(a) = {(u,v,w): (u/a)^a (v/(1-a))^(1-a) >= |w|, u,v >= 0}."""
    scaled = torch.stack([v[..., 0] / alpha, v[..., 1] / (1.0 - alpha),
                          v[..., 2]], dim=-1)
    return _pow_interior(scaled, alpha)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _soc_j(d, like):
    """The SOC's reflection J = diag(1, -1, ..., -1) as a vector."""
    jm = -torch.ones(d, dtype=like.dtype, device=like.device)
    jm[0] = 1.0
    return jm


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _soc_nt_w_wi(sb, zb):
    """(W, W^{-1}) of the NT scaling of SOC blocks (..., d), both in
    closed form: with H = 2vv' - J and v'Jv = 1, H J H = J, so W = eta H
    has W^{-1} = (1/eta) (2 (Jv)(Jv)' - J), no LU."""
    d = sb.shape[-1]
    Jm = _soc_j(d, sb)
    dets = torch.clamp_min(sb[..., 0] ** 2 - _dot(sb[..., 1:], sb[..., 1:]),
                           _TINY)
    detz = torch.clamp_min(zb[..., 0] ** 2 - _dot(zb[..., 1:], zb[..., 1:]),
                           _TINY)
    sbar = sb / torch.sqrt(dets)[..., None]
    zbar = zb / torch.sqrt(detz)[..., None]
    gamma = torch.sqrt(torch.clamp_min((1 + _dot(sbar, zbar)) / 2, _TINY))
    wb = (sbar + Jm * zbar) / (2 * gamma)[..., None]
    e0 = torch.zeros_like(Jm)
    e0[0] = 1.0
    vvec = (wb + e0) / torch.sqrt(
        torch.clamp_min(2.0 * (wb[..., 0] + 1.0), _TINY))[..., None]
    eta = ((dets / detz) ** 0.25)[..., None, None]
    W = eta * (2.0 * _outer(vvec, vvec) - torch.diag(Jm))
    jv = Jm * vvec
    Wi = (2.0 * _outer(jv, jv) - torch.diag(Jm)) / eta
    return W, Wi


def _mm(a, b):
    return torch.matmul(a, b)


def _mv(M, v):
    """Blocks (..., d, d) times vectors (..., d)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _eigh(M, vectors=True):
    """torch.linalg.eigh (or eigvalsh) that returns NaN for a non-finite
    matrix, as the reference's eigh does, where torch raises: such a
    matrix is replaced by the identity for the call and its results by
    NaN. A NaN direction (a failed KKT solve) then flows on into the
    step-acceptance guards, which refuse it."""
    bad = ~torch.isfinite(M).all(dim=-1).all(dim=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    M = torch.where(bad[..., None, None], eye, M)
    if not vectors:
        return eigh(M, vectors=False).masked_fill(bad[..., None], torch.nan)
    w, U = eigh(M)
    return (w.masked_fill(bad[..., None], torch.nan),
            U.masked_fill(bad[..., None, None], torch.nan))


def _psd_nt_w_eig(S, Z):
    """NT scaling W (W Z W = S) of symmetric blocks (..., s, s), via two
    eigh, and Z's eigendecomposition (which the combined step reuses)."""
    lz, Uz = _eigh(Z)
    sq = torch.sqrt(torch.clamp_min(lz, _TINY))[..., None, :]
    Zh = _mm(Uz * sq, Uz.mT)
    Zih = _mm(Uz / sq, Uz.mT)
    Bm = _mm(_mm(Zh, S), Zh)
    lb, Ub = _eigh(Bm)
    Bh = _mm(Ub * torch.sqrt(torch.clamp_min(lb, _TINY))[..., None, :],
             Ub.mT)
    return _mm(_mm(Zih, Bh), Zih), lz, Uz


def _psd_nt_w(sb, zb, side):
    """NT scaling matrix W of svec blocks (..., D)."""
    return _psd_nt_w_eig(svec_to_sym(sb, side), svec_to_sym(zb, side))[0]


def _psd_step_len(sb, dsb, side):
    """max alpha in [0, 1] with S + alpha dS psd, for svec blocks (..., D)
    (eigenvalue ratio bound)."""
    S = svec_to_sym(sb, side)
    dS = svec_to_sym(dsb, side)
    ls, Us = _eigh(S)
    Sih = _mm(Us / torch.sqrt(torch.clamp_min(ls, _TINY))[..., None, :],
              Us.mT)
    lm = _eigh(_mm(_mm(Sih, dS), Sih), vectors=False).amin(dim=-1)
    return torch.where(lm < 0, torch.clamp_max(-1.0 / lm, 1.0), 1.0)


def _nonneg_step_len(v, dv):
    """max alpha in [0, 1] with v + alpha dv >= 0, over the last axis."""
    neg = dv < 0
    cand = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(cand.amin(dim=-1), 0.0, 1.0)


def _soc_step_len(s, ds):
    """max alpha in [0, 1] with s + alpha ds in the SOC, for blocks
    (..., d)."""
    a_ = ds[..., 0] ** 2 - _dot(ds[..., 1:], ds[..., 1:])
    b_ = 2 * (s[..., 0] * ds[..., 0] - _dot(s[..., 1:], ds[..., 1:]))
    c_ = s[..., 0] ** 2 - _dot(s[..., 1:], s[..., 1:])
    disc = b_ * b_ - 4 * a_ * c_
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    big_a = a_.abs() > _TINY
    safe_a = torch.where(big_a, a_, 1.0)
    safe_b = torch.where(b_.abs() > _TINY, b_, _TINY)
    r1 = torch.where(big_a, (-b_ - sq) / (2 * safe_a), -c_ / safe_b)
    r2 = torch.where(big_a, (-b_ + sq) / (2 * safe_a), r1)
    roots = torch.stack([r1, r2], dim=-1)
    pos = torch.where(roots > 1e-12, roots, torch.inf)
    amax = torch.where(disc < 0, torch.inf, pos.amin(dim=-1))
    neg = ds[..., 0] < 0
    head = torch.where(neg, -s[..., 0] / torch.where(neg, ds[..., 0], -1.0),
                       torch.inf)
    return torch.clamp(torch.minimum(amax, head), 0.0, 1.0)


def _soc_jinv(zb):
    det = zb[..., 0] ** 2 - _dot(zb[..., 1:], zb[..., 1:])
    det = torch.where(det.abs() > _TINY, det, _TINY)
    return torch.cat([zb[..., :1], -zb[..., 1:]], dim=-1) / det[..., None]


def _soc_jprod(a, b):
    return torch.cat([_dot(a, b)[..., None],
                      a[..., :1] * b[..., 1:] + b[..., :1] * a[..., 1:]],
                     dim=-1)


def _soc_jprod_inv(u, v):
    """Solve u o w = v (arrow solve)."""
    u0, u1 = u[..., 0], u[..., 1:]
    det = u0 * u0 - _dot(u1, u1)
    det = torch.where(det.abs() > _TINY, det, _TINY)
    w0 = (u0 * v[..., 0] - _dot(u1, v[..., 1:])) / det
    w1 = (v[..., 1:] - w0[..., None] * u1) / torch.where(
        u0.abs() > _TINY, u0, _TINY)[..., None]
    return torch.cat([w0[..., None], w1], dim=-1)


@functools.lru_cache(maxsize=None)
def _skron_index(side: int, dtype: torch.dtype, device: torch.device):
    """Row indices (i_p, j_p) of the svec basis and the coefficients
    c_p c_q / 2 (c = sqrt(2) off the diagonal, 1 on it) of the symmetric
    Kronecker product in that basis."""
    rows, cols = svec_indices(side)
    I = np.asarray(rows)
    J = np.asarray(cols)
    off = I != J
    C = np.where(off[:, None] & off[None, :], 1.0,
                 np.where(off[:, None] | off[None, :], 1.0 / math.sqrt(2.0),
                          0.5))
    return (torch.as_tensor(I, device=device),
            torch.as_tensor(J, device=device),
            torch.as_tensor(C, dtype=dtype, device=device))


def _skron(W, side):
    """The symmetric Kronecker product W (x)_s W of symmetric blocks
    (..., s, s) in the svec basis, (..., D, D): the matrix of
    E -> svec(W smat(E) W), whose entry (p, q) with p = (i, j) and
    q = (k, l) is c_p c_q (W_ik W_jl + W_il W_jk) / 2. Built by gathers,
    one (..., D, D) tensor at a time, where a product per basis matrix
    would hold D of them."""
    I, J, C = _skron_index(side, W.dtype, W.device)
    WI = W[..., I, :]
    WJ = W[..., J, :]
    return (WI[..., I] * WJ[..., J] + WI[..., J] * WJ[..., I]) * C


class _Scaling(NamedTuple):
    """A block-diagonal (mi, mi) matrix per lane: the nonneg diagonal
    (B, l), one (B, k, d, d) tile per block group, and the whole matrix
    (B, mi, mi) where the dense product applies it (see bd_mv)."""
    diag: torch.Tensor
    tiles: Tuple[torch.Tensor, ...]
    dense: Optional[torch.Tensor]


def make_ipm_solver(dims: ConeDims, n: int, settings: SolverSettings,
                    hsde: bool = False):
    """Build solve(P, q, A, b, x0, y0, s0) -> SolveResult for a fixed
    (dims, n) structure, over batched tensors.

    hsde=True (requires a structurally zero P): solve the homogeneous
    self-dual embedding instead of the primal-dual form."""
    p_eq = dims.zero
    l = dims.nonneg
    blocks, mi = _block_layout(dims)
    groups = _block_groups(dims)
    m = dims.total
    st = settings
    max_it = st.ipm_max_iters
    # internal convergence target; may be tighter than the final eps so
    # that the polish starts inside its basin
    ipm_eps = st.ipm_eps_abs if st.ipm_eps_abs > 0 else st.eps_abs
    # cone degree (barrier parameter normalization; CVXOPT convention:
    # 1 per nonneg row, 1 per SOC block, the side of each PSD block, 3
    # per exp/pow block)
    degree = max(
        l + len(dims.soc) + sum(dims.psd) + 3 * (dims.exp + len(dims.pow3)),
        1,
    )
    dim = n + p_eq + mi
    # projector onto the inequality cone (certificate distance checks)
    proj_ineq = make_cone_projector(ConeDims(
        zero=0, nonneg=dims.nonneg, soc=dims.soc, exp=dims.exp,
        psd=dims.psd, pow3=dims.pow3))

    # identity / interior-point templates: svec(I) puts the diagonal
    # first in each column
    _e_np = np.zeros(mi)
    _e_np[:l] = 1.0
    _zint_np = np.zeros(mi)
    _zint_np[:l] = 1.0
    for fam, off, meta in blocks:
        if fam == "soc":
            _e_np[off] = 1.0
            _zint_np[off] = 1.0
        elif fam == "exp":
            _e_np[off:off + 3] = EXP_PRIMAL_INTERIOR
            _zint_np[off:off + 3] = EXP_DUAL_INTERIOR
        elif fam == "pow":
            _e_np[off:off + 3] = POW_INTERIOR
            _zint_np[off:off + 3] = POW_INTERIOR
        elif fam == "psd":
            k = off
            for j in range(meta):
                _e_np[k] = 1.0
                _zint_np[k] = 1.0
                k += meta - j

    # the structural-apply gate of the reference: there the scaling is a
    # dense (mi, mi) matrix, applied block by block only when that product
    # is large and the blocks few (the n=500 class: one SOC block and a
    # big nonneg diagonal), and by the dense product otherwise. The port
    # mirrors it: below the gate a program with cone blocks applies the
    # dense block-diagonal matrix, above it the tiles. (A dense product
    # spreads one non-finite entry over the lane's whole product, the
    # tiles keep it in its block; either way that lane's direction is
    # non-finite and every step candidate is refused, so the outcome is
    # the same.) The nonneg diagonal is always applied as a vector: its
    # dense product gives the same numbers.
    dense_apply = bool(groups) and not (mi >= 512 and len(blocks) <= 8)

    _const_cache = {}

    def consts(dtype, device):
        """The templates and the powers as tensors on the iterate's dtype
        and device (built once)."""
        key = (dtype, device)
        if key not in _const_cache:
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)
            c = dict(e=t(_e_np), zint=t(_zint_np))
            if dims.pow3:
                c["pow"] = t(np.asarray(dims.pow3))
            _const_cache[key] = c
        return _const_cache[key]

    def seg(v, g):
        """Group g's rows of v (..., mi) as blocks (..., k, d)."""
        return v[..., g.off:g.off + g.k * g.d].unflatten(-1, (g.k, g.d))

    def assemble(nn, parts):
        """(..., mi) from the nonneg rows and one (..., k, d) per group."""
        return torch.cat([nn] + [p.flatten(-2) for p in parts], dim=-1)

    def block_diag(tile):
        """(B, k, d, d) tiles -> the (B, k d, k d) block-diagonal matrix."""
        nb, k, d = tile.shape[:3]
        eye = torch.eye(k, dtype=torch.bool, device=tile.device)
        return torch.where(eye[:, None, :, None], tile.unsqueeze(3), 0.0
                           ).reshape(nb, k * d, k * d)

    def bd_dense(S: _Scaling):
        if S.dense is not None:
            return S.dense
        D = S.diag.new_zeros(S.diag.shape[0], mi, mi)
        if l:
            D[:, :l, :l] = torch.diag_embed(S.diag)
        for g, tile in zip(groups, S.tiles):
            r = slice(g.off, g.off + g.k * g.d)
            D[:, r, r] = block_diag(tile)
        return D

    def scaling(diag, tiles, want_dense):
        S = _Scaling(diag, tuple(tiles), None)
        return S._replace(dense=bd_dense(S)) if want_dense else S

    def bd_mv(S: _Scaling, v):
        """The block-diagonal scaling times v (B, mi)."""
        if S.dense is not None:
            return bmv(S.dense, v)
        return assemble(S.diag * v[:, :l], [
            _mv(tile, seg(v, g)) for g, tile in zip(groups, S.tiles)])

    def bd_mm(S: _Scaling, X):
        """The block-diagonal scaling times X (B, mi, c)."""
        if S.dense is not None:
            return torch.bmm(S.dense, X)
        parts = [S.diag[:, :, None] * X[:, :l]]
        for g, tile in zip(groups, S.tiles):
            Xg = X[:, g.off:g.off + g.k * g.d].unflatten(1, (g.k, g.d))
            parts.append(torch.matmul(tile, Xg).flatten(1, 2))
        return torch.cat(parts, dim=1)

    def identity(nb, dtype, device):
        """The identity scaling (T = T^{-1} = B = I) of the initial
        least-squares solve."""
        tiles = [torch.eye(g.d, dtype=dtype, device=device).expand(
            nb, g.k, g.d, g.d) for g in groups]
        I_ = scaling(torch.ones(nb, l, dtype=dtype, device=device), tiles,
                     dense_apply and dtype != torch.float64)
        return I_, I_, I_

    @spanned("ipm.scaling")
    def build_T(s, z, mu):
        """Block-diagonal scaling T with T z ~= s on the path, its
        blockwise inverse, and a blockwise factor B with B'B = T^{-1}
        (the f32 KKT path QR-factorizes [Lp'; B A] instead of
        Cholesky-factorizing P + A' T^{-1} A, halving the exponent on
        cond(T) in the direction error). Also returns what the combined
        step reuses: each SOC group's W and each PSD group's eigh of Z."""
        dtype = s.dtype
        ratio = s[:, :l] / torch.clamp_min(z[:, :l], _TINY)
        inv = 1.0 / torch.clamp_min(ratio, _TINY)
        Ts, Tis, Bs, aux = [], [], [], []
        mu_s = torch.clamp_min(mu, _TINY)[:, None, None, None]
        for g in groups:
            sb, zb = seg(s, g), seg(z, g)
            if g.fam == "soc":
                W, Wi = _soc_nt_w_wi(sb, zb)
                Ts.append(_mm(W, W))
                Tis.append(_mm(Wi, Wi))
                # W is SPD, so Wi' Wi = Wi^2 = T^{-1}: the B tile is Wi
                Bs.append(Wi)
                aux.append(W)
            elif g.fam == "psd":
                W, lz, Uz = _psd_nt_w_eig(svec_to_sym(sb, g.meta),
                                          svec_to_sym(zb, g.meta))
                lw, Uw = _eigh(W)
                lw = torch.clamp_min(lw, _TINY)[..., None, :]
                Wi = _mm(Uw / lw, Uw.mT)
                Wih = _mm(Uw / torch.sqrt(lw), Uw.mT)
                Ts.append(_skron(W, g.meta))
                Tis.append(_skron(Wi, g.meta))
                # the symmetric Kronecker product of the SPD Wi^{1/2}:
                # B'B = Wi (x)_s Wi
                Bs.append(_skron(Wih, g.meta))
                aux.append((lz, Uz))
            else:
                H = (exp_hess(sb) if g.fam == "exp"
                     else pow_hess(sb, consts(dtype, s.device)["pow"]))
                # eigh with a relative eigenvalue floor instead of an
                # inverse: near convergence the barrier Hessian's
                # condition passes 1/eps and a plain inverse returns
                # Inf/NaN; the floor caps cond(H) at ~1/floor with a
                # mildly damped scaling (the IPM tolerates inexact T,
                # not non-finite T)
                floor = 1e-14 if dtype == torch.float64 else 1e-6
                lh, Uh = _eigh(H)
                lh = torch.maximum(
                    lh, lh.abs().amax(dim=-1, keepdim=True) * floor + _TINY)
                Ts.append(_mm(Uh / lh[..., None, :], Uh.mT) / mu_s)
                Tis.append(_mm(mu_s * (Uh * lh[..., None, :]), Uh.mT))
                # T^{-1} = B'B with B = sqrt(mu) diag(sqrt(lh)) Uh'
                Bs.append(torch.sqrt(mu_s)
                          * (torch.sqrt(lh)[..., :, None] * Uh.mT))
                aux.append(None)
        want_dense = dense_apply and dtype != torch.float64
        return (scaling(ratio, Ts, dense_apply), scaling(inv, Tis, want_dense),
                scaling(torch.sqrt(inv), Bs, want_dense), aux)

    def rc_affine(s, z, T: _Scaling):
        """Affine-step complementarity RHS: s (sym) / T z (nonsym)."""
        if not any(g.fam in ("exp", "pow") for g in groups):
            return s
        parts = []
        for g, tile in zip(groups, T.tiles):
            if g.fam in ("exp", "pow"):
                parts.append(_mv(tile, seg(z, g)))
            else:
                parts.append(seg(s, g))
        return assemble(s[:, :l], parts)

    def rc_combined(s, z, T: _Scaling, aux, mu, sigma, ds_a, dz_a):
        """Combined-step RHS: centering + Mehrotra correction (the exact
        scaled-space term for NonNeg and SOC, none for PSD)."""
        smu = sigma * mu
        zs = torch.clamp_min(z[:, :l], _TINY)
        sm1 = smu[:, None]
        nn = s[:, :l] - sm1 / zs + ds_a[:, :l] * dz_a[:, :l] / zs
        parts = []
        sm2 = smu[:, None, None]
        for g, tile, ax in zip(groups, T.tiles, aux):
            sb, zb = seg(s, g), seg(z, g)
            if g.fam == "soc":
                # with W the NT matrix, W^{-1} ds_a = -(lam + W dz_a) in
                # closed form, so corr = W [lam^{-1} o ((W^{-1}ds_a) o
                # (W dz_a))]
                W = ax
                lam = _mv(W, zb)
                Wdz = _mv(W, seg(dz_a, g))
                eta = _soc_jprod(-(lam + Wdz), Wdz)
                corr = _mv(W, _soc_jprod_inv(lam, eta))
                parts.append(sb - sm2 * _soc_jinv(zb) + corr)
            elif g.fam == "psd":
                lz, Uz = ax
                Zinv = _mm(Uz / torch.clamp_min(lz, _TINY)[..., None, :],
                           Uz.mT)
                parts.append(sb - sm2 * sym_to_svec(Zinv))
            else:
                grad = (exp_grad(sb) if g.fam == "exp" else pow_grad(
                    sb, consts(s.dtype, s.device)["pow"]))
                parts.append(_mv(tile, zb + sm2 * grad))
        return assemble(nn, parts)

    def both(s, z):
        """s (primal) and z (dual) stacked on a new leading axis, so that
        each family's test runs once for both."""
        return torch.stack([s, z])

    def strict_interior_pair(s_c, z_c):
        """All-blocks strict membership of s_c in K and of z_c in K*
        (the step acceptance's check), for stacks (..., B, mi) ->
        (..., B). The ratio tests are computed in the iterate's dtype and
        in f32 their roots can overshoot the boundary, after which s'z
        goes negative and the NT scalings are garbage; candidate steps
        are therefore verified directly."""
        v = both(s_c, z_c)
        oks = [torch.ones(v.shape[:-1], dtype=torch.bool, device=v.device)]
        if l:
            oks.append(v[..., :l].amin(dim=-1) > 0)
        for g in groups:
            vb = seg(v, g)
            if g.fam == "soc":
                ok = vb[..., 0] - torch.linalg.vector_norm(
                    vb[..., 1:], dim=-1) > 0
            elif g.fam == "psd":
                ok = _eigh(svec_to_sym(vb, g.meta),
                           vectors=False).amin(dim=-1) > 0
            elif g.fam == "exp":
                ok = torch.stack([_exp_interior(vb[0]),
                                  _exp_dual_interior(vb[1])])
            else:
                a = consts(v.dtype, v.device)["pow"]
                ok = torch.stack([_pow_interior(vb[0], a),
                                  _pow_dual_interior(vb[1], a)])
            oks.append(ok.all(dim=-1))
        return torch.stack(oks).all(dim=0).all(dim=0)

    @spanned("ipm.step_length")
    def step_len_pair(s, ds, z, dz):
        """min of the max alpha in [0, 1] keeping s + alpha ds in K and
        of the one keeping z + alpha dz in K*, per lane (zero for the
        nonsymmetric grid when already infeasible)."""
        v, dv = both(s, z), both(ds, dz)
        alphas = [v.new_ones(v.shape[:-1])]
        if l:
            alphas.append(_nonneg_step_len(v[..., :l], dv[..., :l]))
        for g in groups:
            vb, db = seg(v, g), seg(dv, g)
            if g.fam == "soc":
                a = _soc_step_len(vb, db)
            elif g.fam == "psd":
                a = _psd_step_len(vb, db, g.meta)
            elif g.fam == "exp":
                a = torch.stack([
                    _grid_max_step(_exp_interior, vb[0], db[0]),
                    _grid_max_step(_exp_dual_interior, vb[1], db[1])])
            else:
                al = consts(v.dtype, v.device)["pow"][:, None]
                a = torch.stack([
                    _grid_max_step(lambda c: _pow_interior(c, al),
                                   vb[0], db[0]),
                    _grid_max_step(lambda c: _pow_dual_interior(c, al),
                                   vb[1], db[1])])
            alphas.append(a.amin(dim=-1))
        return torch.stack(alphas).amin(dim=0).amin(dim=0)

    def shift_into_cone(v, interior):
        """Per-block shift into the cone interior (initial point and warm
        start): nonneg and SOC by a multiple of the identity when within
        1e-3 of the boundary or outside it, PSD by a multiple of svec(I),
        exp/pow reset to the canonical interior point at the vector's
        magnitude."""
        nn = v[:, :l]
        if l:
            a = (-nn).amax(dim=-1, keepdim=True)
            nn = torch.where(a >= -1e-3, nn + (1.0 + a), nn)
        parts = []
        for g in groups:
            vb, eb = seg(v, g), seg(interior, g)
            if g.fam == "soc":
                a = (torch.linalg.vector_norm(vb[..., 1:], dim=-1)
                     - vb[..., 0])[..., None]
                e0 = torch.zeros_like(eb)
                e0[..., 0] = 1.0
                parts.append(torch.where(a >= -1e-3, vb + (1.0 + a) * e0, vb))
            elif g.fam == "psd":
                lmin = _eigh(svec_to_sym(vb, g.meta),
                             vectors=False).amin(dim=-1)[..., None]
                parts.append(torch.where(-lmin >= -1e-3,
                                         vb + (1.0 - lmin) * eb, vb))
            else:
                scale = torch.clamp_min(vb.abs().amax(dim=-1), 1.0)
                parts.append(scale[..., None] * eb)
        return assemble(nn, parts)

    def shift_hsde(v, interior, mix):
        """The HSDE warm start's interior shift: a convex mix toward the
        canonical interior point, then per family: nonneg at least 1e-3,
        SOC shifted as in shift_into_cone, exp/pow/PSD reset to the
        interior point."""
        vv = (1 - mix) * v + mix * interior
        parts = []
        for g in groups:
            vb, eb = seg(vv, g), seg(interior, g)
            if g.fam == "soc":
                a = (torch.linalg.vector_norm(vb[..., 1:], dim=-1)
                     - vb[..., 0])[..., None]
                e0 = torch.zeros_like(eb)
                e0[..., 0] = 1.0
                parts.append(torch.where(a >= -1e-3, vb + (1.0 + a) * e0, vb))
            else:
                parts.append(eb.expand_as(vb))
        return assemble(torch.clamp_min(vv[:, :l], 1e-3), parts)

    @spanned("ipm.step_length")
    def accept(alpha, x, dx, y, dy, s, ds, z, dz, extra=None):
        """The step acceptance with backtracking: the largest alpha in
        {alpha, alpha/2, alpha/4, alpha/8, 0} whose endpoint is finite
        and strictly interior on both sides with a positive gap, every
        candidate tested at once. extra(cands, gap) takes the candidates
        (4, B) and s'z at them and returns the embedding's own conditions
        (4, B), which replace the gap test."""
        ks = torch.as_tensor(_CANDIDATES, dtype=alpha.dtype,
                             device=alpha.device)
        cands = alpha * ks[:, None]
        c1 = cands[..., None]
        s_c = s + c1 * ds
        z_c = z + c1 * dz
        gap = bdot(s_c, z_c)
        ok = (_finite_rows(x + c1 * dx) & _finite_rows(y + c1 * dy)
              & _finite_rows(s_c) & _finite_rows(z_c)
              & strict_interior_pair(s_c, z_c))
        if extra is not None:
            ok = ok & extra(cands, gap)
        elif mi:
            ok = ok & (gap > 0)
        alpha_eff = torch.zeros_like(alpha)
        for i in range(len(_CANDIDATES)):
            alpha_eff = torch.where(ok[i], cands[i], alpha_eff)
        return alpha_eff

    def make_kkt_factor(P, A_eq, A_in):
        """kkt_factor(T, Tinv, Bf) factors the scaled KKT matrix ONCE and
        returns solve(rx, ry, rz) for K d = [-rx, -ry, -rz]."""
        dtype = P.dtype
        device = P.device
        nb = P.shape[0]
        eye_n = torch.eye(n, dtype=dtype, device=device)
        eye_p = torch.eye(p_eq, dtype=dtype, device=device)
        P_sig = P + st.sigma * eye_n

        def factor_f64(T):
            K = P.new_zeros(nb, dim, dim)
            K[:, :n, :n] = P_sig
            if p_eq:
                K[:, n:n + p_eq, :n] = A_eq
                K[:, :n, n:n + p_eq] = A_eq.mT
                K[:, n:n + p_eq, n:n + p_eq] = -st.sigma * eye_p
            if mi:
                K[:, n + p_eq:, :n] = A_in
                K[:, :n, n + p_eq:] = A_in.mT
                K[:, n + p_eq:, n + p_eq:] = -bd_dense(T)
            LU, piv, _ = torch.linalg.lu_factor_ex(K)

            @spanned("ipm.kkt_solve")
            def solve_f64(rx, ry, rz_mod):
                rhs = torch.cat([-rx, -ry, -rz_mod], dim=-1)
                sol = torch.linalg.lu_solve(LU, piv,
                                            rhs.unsqueeze(-1)).squeeze(-1)
                return sol[:, :n], sol[:, n:n + p_eq], sol[:, n + p_eq:]

            return solve_f64

        def factor_f32(T, Tinv, Bf):
            Lp, info = torch.linalg.cholesky_ex(P_sig)
            Lp = _nan_unless(info, Lp)
            if mi:
                M = torch.cat([Lp.mT, bd_mm(Bf, A_in)], dim=1)
                if use_masked(n) or st.ipm_kkt == "qr":
                    Rm = qr_r(M.contiguous())
                else:
                    # R'R = M'M = S, so chol(M'M)' is the same factor for
                    # one matmul and an (n, n) Cholesky; Jacobi scaling
                    # removes the row/column scale that dominates cond(S)
                    # near convergence. A non-finite factor selects the
                    # identity: that iteration's direction degrades to a
                    # scaled residual step, which the step acceptance and
                    # the stall counter handle.
                    S_ = torch.bmm(M.mT, M)
                    dj = torch.rsqrt(torch.clamp_min(
                        torch.diagonal(S_, dim1=1, dim2=2), _TINY))
                    Ss = S_ * dj[:, :, None] * dj[:, None, :]
                    Lc, info = torch.linalg.cholesky_ex(Ss)
                    ok = (info == 0) & torch.isfinite(Lc).all(
                        dim=-1).all(dim=-1)
                    Lc = torch.where(ok[:, None, None], Lc, eye_n)
                    Rm = (Lc / dj[:, :, None]).mT
            else:
                Rm = Lp.mT
            Rmi = torch.linalg.solve_triangular(
                Rm, eye_n.expand(nb, n, n), upper=True
            )
            Sinv = torch.bmm(Rmi, Rmi.mT)
            if p_eq:
                E = (torch.bmm(A_eq, torch.bmm(Sinv, A_eq.mT))
                     + st.sigma * eye_p)
                Le, info = torch.linalg.cholesky_ex(E)
                Le = _nan_unless(info, Le)

            def solve_cond(rx_, ry_, rz_):
                """One condensed solve of K d = [-rx_, -ry_, -rz_]."""
                g = -rx_
                if mi:
                    g = g - bmv_t(A_in, bd_mv(Tinv, rz_))
                if p_eq:
                    rhs_y = bmv(A_eq, bmv(Sinv, g)) + ry_
                    z1 = torch.linalg.solve_triangular(
                        Le, rhs_y.unsqueeze(-1), upper=False
                    )
                    dy_ = torch.linalg.solve_triangular(
                        Le.mT, z1, upper=True
                    ).squeeze(-1)
                    dx_ = bmv(Sinv, g - bmv_t(A_eq, dy_))
                else:
                    dy_ = ry_
                    dx_ = bmv(Sinv, g)
                dz_ = bd_mv(Tinv, bmv(A_in, dx_) + rz_) if mi else rz_
                return dx_, dy_, dz_

            @spanned("ipm.kkt_solve")
            def solve_f32(rx, ry, rz_mod):
                dx, dy, dz = solve_cond(rx, ry, rz_mod)
                # one refinement pass with the cached factors: near an
                # active SOC boundary T spans mu..1/mu and a single f32
                # condensation stalls ~1e-5 short; the correction
                # squares the effective precision
                res_x = rx + bmv(P_sig, dx)
                res_y = ry
                res_z = rz_mod
                if p_eq:
                    res_x = res_x + bmv_t(A_eq, dy)
                    res_y = ry + bmv(A_eq, dx) - st.sigma * dy
                if mi:
                    res_x = res_x + bmv_t(A_in, dz)
                    res_z = rz_mod + bmv(A_in, dx) - bd_mv(T, dz)
                cx, cy, cz = solve_cond(res_x, res_y, res_z)
                return dx + cx, dy + cy, dz + cz

            return solve_f32

        @spanned("ipm.kkt_factor")
        def kkt_factor(T, Tinv, Bf):
            if dtype == torch.float64:
                return factor_f64(T)
            return factor_f32(T, Tinv, Bf)

        return kkt_factor

    def warm_norm(x0, y0, s0):
        return amax_abs(x0) + amax_abs(s0) + amax_abs(y0)

    def active_of(state):
        """The lanes still iterating; state is a tuple (..., it, status,
        stall, best) of per-lane tensors."""
        it, status, stall = state[-4:-1]
        return (status == MAX_ITERS) & (it < max_it) & (stall < 3)

    def solve(P, q, A, b, x0, y0, s0):
        dtype = q.dtype
        device = q.device
        nb = q.shape[0]
        c = consts(dtype, device)
        e, zint = c["e"], c["zint"]
        A_eq = A[:, :p_eq]
        b_eq = b[:, :p_eq]
        A_in = A[:, p_eq:]
        b_in = b[:, p_eq:]
        kkt_factor = make_kkt_factor(P, A_eq, A_in)
        # below f64 a trip also stalls when it leaves the lane's merit
        # within 1 % of its best: near an exp block's boundary the f32
        # directions can jam a lane at mu just above ipm_eps (or at ~1e-2,
        # its dual block pressed against the boundary by the primal-
        # barrier scaling) with steps of 1e-6..1e-2 that move nothing.
        # Under the reference's rule alone (three steps under 1e-6) such
        # a lane holds the whole batch's loop to ipm_max_iters; now its
        # best iterate goes to the polish three trips later. f64 keeps
        # the reference's rule, and its counts.
        by_merit = dtype != torch.float64

        def residuals(x, y, z, s):
            rx = bmv(P, x) + q
            if p_eq:
                rx = rx + bmv_t(A_eq, y)
            if mi:
                rx = rx + bmv_t(A_in, z)
            ry = bmv(A_eq, x) - b_eq
            rz = bmv(A_in, x) + s - b_in
            return rx, ry, rz

        # ---- initial point: least-squares KKT solve with identity
        # scaling, then a per-block shift into the cone interior
        x, y, z_hat = kkt_factor(*identity(nb, dtype, device))(
            q, -b_eq, -b_in)
        s = shift_into_cone(-z_hat, e)
        z = shift_into_cone(z_hat, zint)
        # warm start (per-lane select): a nonzero (x0, y0, s0) replaces
        # the least-squares point, mixed toward the canonical interior
        # point and pushed back into the strict interior by the same
        # shift, because an IPM warm-starts poorly from ON the boundary
        have_ws = (warm_norm(x0, y0, s0) > 0)[:, None]
        mix = 0.1
        s_ws = shift_into_cone((1 - mix) * s0[:, p_eq:] + mix * e, e)
        z_ws = shift_into_cone((1 - mix) * y0[:, p_eq:] + mix * zint, zint)
        x = torch.where(have_ws, x0, x)
        y = torch.where(have_ws, y0[:, :p_eq], y)
        s = torch.where(have_ws, s_ws, s)
        z = torch.where(have_ws, z_ws, z)

        b_norm = amax_abs(b)
        q_norm = amax_abs(q)

        def certificates(x, y, z):
            """Almost-certificate detection on normalized iterates."""
            u = torch.cat([y, z], dim=-1)
            nu_ = amax_abs(u)
            uh = u / torch.clamp_min(nu_, _TINY)[:, None]
            pinf = (
                (nu_ > 1e3)
                & (amax_abs(bmv_t(A, uh)) <= 1e-7 * (1.0 + q_norm))
                & (bdot(b, uh) < -1e-5)
            )
            nx = amax_abs(x)
            xh = x / torch.clamp_min(nx, _TINY)[:, None]
            Axh = bmv(A_in, xh)
            # distance of A_in xh from the recession cone -K
            rec_dist = amax_abs(-proj_ineq(-Axh) - Axh)
            eq_dist = amax_abs(bmv(A_eq, xh))
            dinf = (
                (nx > 1e3)
                & (amax_abs(bmv(P, xh)) <= 1e-7)
                & (eq_dist <= 1e-7 * (1.0 + b_norm))
                & (rec_dist <= 1e-7 * (1.0 + b_norm))
                & (bdot(q, xh) < -1e-5)
            )
            return pinf, dinf

        def body(x, y, z, s, it, status, stall, best):
            mu = torch.clamp_min(bdot(s, z) / degree, _TINY)
            T, Tinv, Bf, aux = build_T(s, z, mu)
            # ONE factorization per iteration, shared by predictor and
            # corrector
            ksolve = kkt_factor(T, Tinv, Bf)
            rx, ry, rz = residuals(x, y, z, s)

            # ---- affine (predictor) step
            dx_a, dy_a, dz_a = ksolve(rx, ry, rz - rc_affine(s, z, T))
            # ds from the third-row residual identity, not -(rc + T dz):
            # keeps A dx + ds = -rz exact to well-scaled rounding
            ds_a = -(rz + bmv(A_in, dx_a))
            alpha_aff = step_len_pair(s, ds_a, z, dz_a)
            a1 = alpha_aff[:, None]
            mu_aff = bdot(s + a1 * ds_a, z + a1 * dz_a) / degree
            sigma_c = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)

            # ---- corrector (centering + Mehrotra second order)
            rc_c = rc_combined(s, z, T, aux, mu, sigma_c, ds_a, dz_a)
            dx, dy, dz = ksolve(rx, ry, rz - rc_c)
            ds = -(rz + bmv(A_in, dx))
            alpha = 0.99 * step_len_pair(s, ds, z, dz)
            alpha_eff = accept(alpha, x, dx, y, dy, s, ds, z, dz)

            # a zero step means every candidate was rejected, typically a
            # NaN/Inf direction: select, because 0 * NaN would still
            # poison the iterate
            take = (alpha_eff > 0)[:, None]
            ae = alpha_eff[:, None]
            x = torch.where(take, x + ae * dx, x)
            y = torch.where(take, y + ae * dy, y)
            z = torch.where(take, z + ae * dz, z)
            s = torch.where(take, s + ae * ds, s)
            it = it + 1

            rx2, ry2, rz2 = residuals(x, y, z, s)
            mu2 = bdot(s, z) / degree
            p_res = torch.maximum(amax_abs(ry2), amax_abs(rz2))
            d_res = amax_abs(rx2)
            scale = 1.0 + torch.maximum(q_norm, b_norm)
            done = (
                (p_res <= ipm_eps * scale)
                & (d_res <= ipm_eps * scale)
                & (mu2 <= ipm_eps * scale)
            )
            # best-iterate tracking: return the lowest-merit iterate
            bx, by, bz, bs, bm = best
            merit = torch.maximum(torch.maximum(p_res, d_res), mu2.abs())
            better = merit < bm
            # consecutive rejected or zero steps mean the dtype's
            # KKT-direction precision floor is reached
            moved = alpha_eff > 1e-6
            if by_merit:
                moved = moved & (merit < 0.99 * bm)
            stall = torch.where(moved, 0, stall + 1)
            b1 = better[:, None]
            best = (
                torch.where(b1, x, bx), torch.where(b1, y, by),
                torch.where(b1, z, bz), torch.where(b1, s, bs),
                torch.where(better, merit, bm),
            )
            pinf, dinf = certificates(x, y, z)
            status = torch.where(dinf, DUAL_INFEASIBLE, status)
            status = torch.where(pinf, PRIMAL_INFEASIBLE, status)
            status = torch.where(done, SOLVED, status).to(torch.int32)
            return x, y, z, s, it, status, stall, best

        it = torch.zeros(nb, dtype=torch.int32, device=device)
        status = torch.full((nb,), MAX_ITERS, dtype=torch.int32,
                            device=device)
        stall = torch.zeros(nb, dtype=torch.int32, device=device)
        best = (x, y, z, s, q.new_full((nb,), torch.inf))
        *_, it, status, _, best = run_lanes(
            _trip(body), (x, y, z, s, it, status, stall, best), active_of)
        x, y, z, s, _ = best

        y_full = torch.cat([y, z], dim=-1)
        s_full = torch.cat([q.new_zeros(nb, p_eq), s], dim=-1)
        pobj = 0.5 * bdot(x, bmv(P, x)) + bdot(q, x)
        return SolveResult(
            x=x, y=y_full, s=s_full, status=status, iters=it, pobj=pobj
        )

    # ------------------------------------------------------------- HSDE
    def solve_hsde(P, q, A, b, x0, y0, s0):
        """Mehrotra IPM on the homogeneous self-dual embedding (P = 0):

            rx = Aeq'y + Ain'z + q*tau        -> 0
            ry = Aeq x - beq*tau              -> 0
            rz = Ain x + s - bin*tau          -> 0
            rt = kappa + q'x + beq'y + bin'z  -> 0
            s in K, z in K*, tau, kappa >= 0; s'z = 0, tau*kappa = 0.

        tau and kappa are (B,) vectors. Each iteration factors the scaled
        KKT matrix once and solves against it three times: the tau
        column d2, then the predictor and the corrector, with dtau
        recovered from the gap row after eliminating dkappa."""
        dtype = q.dtype
        device = q.device
        nb = q.shape[0]
        c = consts(dtype, device)
        e, zint = c["e"], c["zint"]
        A_eq = A[:, :p_eq]
        b_eq = b[:, :p_eq]
        A_in = A[:, p_eq:]
        b_in = b[:, p_eq:]
        kkt_factor = make_kkt_factor(P, A_eq, A_in)
        deg1 = degree + 1

        def g_of(dx, dy, dz):
            return bdot(q, dx) + bdot(b_eq, dy) + bdot(b_in, dz)

        def embed_residuals(x, y, z, s, tau):
            rx = q * tau + bmv_t(A_eq, y) + bmv_t(A_in, z)
            ry = bmv(A_eq, x) - b_eq * tau
            rz = bmv(A_in, x) + s - b_in * tau
            return rx, ry, rz

        def ratio(v, dv):
            """max step in [0, 1] keeping v + a dv >= 0, per lane."""
            return torch.where(dv < 0, torch.clamp_max(-v / dv, 1.0), 1.0)

        # initial embedding point: canonical interior, tau = kappa = 1;
        # a nonzero warm start (per-lane select) replaces x, y, s, z
        x = q.new_zeros(nb, n)
        y = q.new_zeros(nb, p_eq)
        s = e.expand(nb, mi)
        z = zint.expand(nb, mi)
        tau = q.new_ones(nb)
        kap = q.new_ones(nb)
        have_ws = (warm_norm(x0, y0, s0) > 0)[:, None]
        mix = 0.1
        x = torch.where(have_ws, x0, x)
        y = torch.where(have_ws, y0[:, :p_eq], y)
        s = torch.where(have_ws, shift_hsde(s0[:, p_eq:], e, mix), s)
        z = torch.where(have_ws, shift_hsde(y0[:, p_eq:], zint, mix), z)

        b_norm = amax_abs(b)
        q_norm = amax_abs(q)
        scale = 1.0 + torch.maximum(q_norm, b_norm)

        def body(x, y, z, s, tau, kap, it, status, stall, best):
            mu = torch.clamp_min((bdot(s, z) + tau * kap) / deg1, _TINY)
            T, Tinv, Bf, aux = build_T(s, z, mu)
            # ONE factorization per iteration, shared by the tau-column,
            # predictor and corrector solves
            ksolve = kkt_factor(T, Tinv, Bf)
            rx, ry, rz = embed_residuals(x, y, z, s, tau[:, None])
            rt = kap + g_of(x, y, z)
            safe_tau = torch.clamp_min(tau, _TINY)

            # shared tau-column solve: K d2 = [-q; beq; bin]
            dx2, dy2, dz2 = ksolve(q, -b_eq, -b_in)
            denom = g_of(dx2, dy2, dz2) - kap / safe_tau
            denom = torch.where(denom.abs() > _TINY, denom, -_TINY)

            def directions(rc, rct):
                dx1, dy1, dz1 = ksolve(rx, ry, rz - rc)
                dtau = (-rt - g_of(dx1, dy1, dz1) + rct / safe_tau) / denom
                t1 = dtau[:, None]
                dx = dx1 + t1 * dx2
                dy = dy1 + t1 * dy2
                dz = dz1 + t1 * dz2
                ds = -(rz + bmv(A_in, dx) - b_in * t1)
                dkap = -(rct + kap * dtau) / safe_tau
                return dx, dy, dz, ds, dtau, dkap

            # ---- predictor
            dxa, dya, dza, dsa, dta, dka = directions(
                rc_affine(s, z, T), tau * kap)
            alpha_aff = torch.minimum(
                step_len_pair(s, dsa, z, dza),
                torch.minimum(ratio(tau, dta), ratio(kap, dka)),
            )
            a1 = alpha_aff[:, None]
            mu_aff = (
                bdot(s + a1 * dsa, z + a1 * dza)
                + (tau + alpha_aff * dta) * (kap + alpha_aff * dka)
            ) / deg1
            sigma_c = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)

            # ---- corrector
            rc_c = rc_combined(s, z, T, aux, mu, sigma_c, dsa, dza)
            rct_c = tau * kap - sigma_c * mu + dta * dka
            dx, dy, dz, ds, dtau, dkap = directions(rc_c, rct_c)

            alpha = 0.99 * torch.minimum(
                step_len_pair(s, ds, z, dz),
                torch.minimum(ratio(tau, dtau), ratio(kap, dkap)),
            )

            def extra(cands, gap):
                t_c = tau + cands * dtau
                k_c = kap + cands * dkap
                return (torch.isfinite(t_c) & torch.isfinite(k_c)
                        & (t_c > 0) & (k_c > 0) & (gap + t_c * k_c > 0))

            alpha_eff = accept(alpha, x, dx, y, dy, s, ds, z, dz, extra)

            take = alpha_eff > 0
            t1 = take[:, None]
            ae = alpha_eff[:, None]
            x = torch.where(t1, x + ae * dx, x)
            y = torch.where(t1, y + ae * dy, y)
            z = torch.where(t1, z + ae * dz, z)
            s = torch.where(t1, s + ae * ds, s)
            tau = torch.where(take, tau + alpha_eff * dtau, tau)
            kap = torch.where(take, kap + alpha_eff * dkap, kap)
            it = it + 1
            stall = torch.where(alpha_eff > 1e-6, 0, stall + 1)

            # ---- normalized convergence / intrinsic certificates
            st_ = torch.clamp_min(tau, _TINY)[:, None]
            xh, yh, zh, sh = x / st_, y / st_, z / st_, s / st_
            rxh, ryh, rzh = embed_residuals(xh, yh, zh, sh, 1.0)
            p_res = torch.maximum(amax_abs(ryh), amax_abs(rzh))
            d_res = amax_abs(rxh)
            gap = bdot(sh, zh) / degree
            done = (
                (p_res <= ipm_eps * scale)
                & (d_res <= ipm_eps * scale)
                & (gap <= ipm_eps * scale)
            )
            # tau -> 0: the iterate IS the certificate (exact, not an
            # almost-certificate heuristic)
            bty = bdot(b_eq, y) + bdot(b_in, z)
            qtx = bdot(q, x)
            Atu = bmv_t(A, torch.cat([y, z], dim=-1))
            inf_regime = kap > 1e3 * tau
            pinf = (
                inf_regime & (bty < -_TINY)
                & (amax_abs(Atu) <= 1e-6 * scale * (-bty))
            )
            dinf = (
                inf_regime & (qtx < -_TINY)
                & (amax_abs(bmv(A_eq, x)) <= 1e-6 * scale * (-qtx))
                & (amax_abs(bmv(A_in, x) + s) <= 1e-6 * scale * (-qtx))
            )
            status = torch.where(dinf, DUAL_INFEASIBLE, status)
            status = torch.where(pinf, PRIMAL_INFEASIBLE, status)
            status = torch.where(done, SOLVED, status).to(torch.int32)

            bx, by, bz, bs, btau, bm = best
            merit = torch.maximum(torch.maximum(p_res, d_res), gap.abs())
            better = merit < bm
            b1 = better[:, None]
            best = (
                torch.where(b1, x, bx), torch.where(b1, y, by),
                torch.where(b1, z, bz), torch.where(b1, s, bs),
                torch.where(better, tau, btau),
                torch.where(better, merit, bm),
            )
            return x, y, z, s, tau, kap, it, status, stall, best

        it = torch.zeros(nb, dtype=torch.int32, device=device)
        status = torch.full((nb,), MAX_ITERS, dtype=torch.int32,
                            device=device)
        stall = torch.zeros(nb, dtype=torch.int32, device=device)
        best = (x, y, z, s, tau, q.new_full((nb,), torch.inf))
        x, y, z, s, tau, kap, it, status, stall, best = run_lanes(
            _trip(body), (x, y, z, s, tau, kap, it, status, stall, best),
            active_of)
        bx, by, bz, bs, btau, _ = best
        # solved path: the tau-normalized best iterate; on an
        # infeasibility verdict the LAST iterate unscaled, which is the
        # certificate itself
        infeasible = ((status == PRIMAL_INFEASIBLE)
                      | (status == DUAL_INFEASIBLE))[:, None]
        st_ = torch.clamp_min(btau, _TINY)[:, None]
        xr = torch.where(infeasible, x, bx / st_)
        yr = torch.where(infeasible, y, by / st_)
        zr = torch.where(infeasible, z, bz / st_)
        sr = torch.where(infeasible, s, bs / st_)
        y_full = torch.cat([yr, zr], dim=-1)
        s_full = torch.cat([q.new_zeros(nb, p_eq), sr], dim=-1)
        return SolveResult(x=xr, y=y_full, s=s_full, status=status,
                           iters=it, pobj=bdot(q, xr))

    form = solve_hsde if hsde else solve

    def solve_full_f32(P, q, A, b, x0, y0, s0):
        with full_f32():
            return form(P, q, A, b, x0, y0, s0)

    return solve_full_f32
