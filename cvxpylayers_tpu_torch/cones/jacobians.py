"""Generalized Jacobians D Pi_K(v) of the cone projections, batched.

Counterpart of cvxpylayers_tpu/cones/jacobians.py. These feed the
semismooth-Newton polish and the implicit adjoint (solver/kkt.py). Every
function takes a leading lane axis (v is (B, m)).

Blocks:
  zero:   0
  nonneg: diag(v > 0)
  soc:    0.5 * [[1, xhat'], [xhat, (1 + t/r) I - (t/r) xhat xhat']]
          on the projection region (identity inside, 0 in the polar)
  exp/pow: 3x3, forward-mode tangents of the triple projection taken
          from its detached root (cones/projections.py: the symbolic
          Newton steps make this the exact implicit derivative; nothing
          differentiates through the root find)
  psd:    Loewner operator U (B ∘ (U' H U)) U' in svec coordinates,
          B_ij = (li+ - lj+)/(li - lj) with the diagonal limit 1[li > 0]
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.precision import full_f32
from .dims import ConeDims
from .projections import (
    _exp_from_root,
    _exp_solve_root,
    _group_runs,
    _pow_from_root,
    _pow_solve_root,
    device_constant,
    eigh,
    svec_indices,
    svec_to_sym,
    sym_to_svec,
)


def _triple_jacobian(from_root, v, root, *extra):
    """(..., 3, 3) Jacobians of a triple projection at v (..., 3): the
    forward-mode tangents of from_root(x, y, z, *extra, root) along the
    three unit vectors, with the root held fixed, in ONE jvp over a
    leading axis of the three directions. Entry (i, j) is d out_i / d v_j.
    (torch.func.jvp, not torch.autograd.forward_ad: the adjoint calls
    this inside an autograd.Function's forward, where plain forward-mode
    AD is switched off.)"""
    lead = v.shape[:-1]
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    eye = eye.reshape((3, 3) + (1,) * len(lead))
    comps = tuple(v[..., i].expand((3,) + lead).contiguous()
                  for i in range(3))
    tangents = tuple(eye[:, i].expand((3,) + lead).contiguous()
                     for i in range(3))

    def f(a, b, c):
        return from_root(a, b, c, *extra, root)

    _, tans = torch.func.jvp(f, comps, tangents)
    return torch.stack([t.movedim(0, -1) for t in tans], dim=-2)


def dproj_exp(v: torch.Tensor) -> torch.Tensor:
    """3x3 Jacobians of the exp-cone projection at (..., 3) triples."""
    v = v.detach()
    root = _exp_solve_root(v[..., 0], v[..., 1], v[..., 2])
    return _triple_jacobian(_exp_from_root, v, root)


def dproj_pow3(v: torch.Tensor, alpha) -> torch.Tensor:
    """3x3 Jacobians of the power-cone projection at (..., 3) triples."""
    v = v.detach()
    alpha = torch.as_tensor(alpha, dtype=v.dtype, device=v.device)
    root = _pow_solve_root(v[..., 0], v[..., 1], v[..., 2], alpha)
    return _triple_jacobian(_pow_from_root, v, root, alpha)


def _soc_parts(wb):
    """(t, x, r, safe_r, xh) of (..., d) SOC blocks."""
    t = wb[..., 0]
    x = wb[..., 1:]
    r = torch.linalg.vector_norm(x, dim=-1)
    safe_r = torch.where(r > 0, r, 1.0)
    return t, x, r, safe_r, x / safe_r[..., None]


def dproj_soc(v: torch.Tensor) -> torch.Tensor:
    """Dense (..., d, d) Jacobians of (..., d) SOC blocks."""
    d = v.shape[-1]
    t, _, r, safe_r, xh = _soc_parts(v)
    eye = torch.eye(d, dtype=v.dtype, device=v.device)
    J = torch.zeros(v.shape + (d,), dtype=v.dtype, device=v.device)
    J[..., 0, 0].fill_(0.5)
    J[..., 0, 1:] = 0.5 * xh
    J[..., 1:, 0] = 0.5 * xh
    tr = (t / safe_r)[..., None, None]
    J[..., 1:, 1:] = 0.5 * ((1.0 + tr) * eye[1:, 1:]
                            - tr * xh[..., :, None] * xh[..., None, :])
    inside = (r <= t)[..., None, None]
    polar = (r <= -t)[..., None, None]
    return torch.where(inside, eye, torch.where(polar, 0.0, J))


def _soc_dapply(wb: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """D Pi_soc(wb) @ vb for (..., d) blocks, O(d) (no d x d matrix)."""
    t, _, r, safe_r, xh = _soc_parts(wb)
    vt = vb[..., 0]
    vx = vb[..., 1:]
    xv = (xh * vx).sum(dim=-1)
    top = 0.5 * (vt + xv)
    tr = t / safe_r
    bottom = 0.5 * (vt[..., None] * xh + (1.0 + tr)[..., None] * vx
                    - (tr * xv)[..., None] * xh)
    out = torch.cat([top[..., None], bottom], dim=-1)
    inside = (r <= t)[..., None]
    polar = (r <= -t)[..., None]
    return torch.where(inside, vb, torch.where(polar, 0.0, out))


def _psd_factor(wb: torch.Tensor, s: int):
    """(U, B) of (..., d) svec blocks: the eigenvectors of the unpacked
    matrix and the Loewner divided differences, with the reference's
    eigenvalue-gap rule (gaps within 1e-12 of the spectrum's scale take
    the diagonal limit 1[l > 0])."""
    M = svec_to_sym(wb, s)
    lam, U = eigh(M)
    lp = torch.clamp_min(lam, 0.0)
    dl = lam[..., :, None] - lam[..., None, :]
    num = lp[..., :, None] - lp[..., None, :]
    scale = 1e-12 * (1 + lam.abs().amax(dim=-1))
    B = torch.where(
        dl.abs() > scale[..., None, None],
        num / torch.where(dl.abs() > 0, dl, 1.0),
        (lam[..., :, None] > 0).to(wb.dtype).expand_as(dl),
    )
    return U, B, lam


def _psd_apply(U, B, vb, s):
    """sym_to_svec(U (B ∘ (U' H U)) U') with H = svec_to_sym(vb)."""
    H = svec_to_sym(vb, s)
    with full_f32():
        return sym_to_svec(U @ (B * (U.mT @ H @ U)) @ U.mT)


def dproj_psd_svec(v: torch.Tensor, s: int) -> torch.Tensor:
    """Dense (..., d, d) Jacobians of the svec PSD projection (svec is an
    isometry, so the Loewner form carries over to svec coordinates)."""
    d = s * (s + 1) // 2
    U, B, _ = _psd_factor(v, s)
    basis = torch.eye(d, dtype=v.dtype, device=v.device)
    lead = v.shape[:-1]
    # one apply per basis vector, batched: column j = D e_j
    cols = _psd_apply(U[..., None, :, :], B[..., None, :, :],
                      basis.expand(lead + (d, d)), s)
    return cols.mT


@functools.lru_cache(maxsize=256)
def _block_scatter_idx(off, d, nblk, device):
    """Index tensors on `device` placing (nblk, d, d) blocks on the
    diagonal of an (m, m) matrix in one scatter; made once per argument
    set, so the polish's CUDA graph capture (solver/refine.py) copies
    nothing from the host."""
    base = off + np.arange(nblk)[:, None, None] * d
    ri = (base + np.arange(d)[None, :, None]
          + np.zeros((1, 1, d), np.int64)).reshape(-1)
    ci = (base + np.zeros((1, d, 1), np.int64)
          + np.arange(d)[None, None, :]).reshape(-1)
    return (torch.as_tensor(ri, device=device),
            torch.as_tensor(ci, device=device))


def make_cone_dproj_factored(dims: ConeDims):
    """(factor, apply) pair for repeated D Pi_K(w) matvecs at FIXED w.

    factor(w) does all the w-dependent work once (the exp/pow 3x3
    Jacobians, each behind a root find, and the PSD eigendecompositions)
    and returns a state; apply(state, v) is then masks and small products
    only. For polyhedral cones the state is the 0/1 diagonal."""
    n_zero = dims.zero
    if dims.is_polyhedral():

        def factor_polyhedral(w: torch.Tensor) -> torch.Tensor:
            d = (w > 0).to(w.dtype)
            if n_zero:
                d[..., :n_zero].zero_()
            return d

        def apply_polyhedral(state, v):
            return state * v

        return factor_polyhedral, apply_polyhedral

    soc_runs = _group_runs(dims.soc)
    psd_runs = _group_runs(dims.psd)

    def factor(w: torch.Tensor):
        B = w.shape[0]
        st = []
        off = dims.zero
        if dims.nonneg:
            st.append(w[:, off:off + dims.nonneg] > 0)
            off += dims.nonneg
        for d, nblk in soc_runs:
            # SOC applies are O(d) from the raw w: nothing to precompute
            st.append(w[:, off:off + d * nblk].reshape(B, nblk, d))
            off += d * nblk
        if dims.exp:
            ws = w[:, off:off + 3 * dims.exp].reshape(B, dims.exp, 3)
            st.append(dproj_exp(ws))
            off += 3 * dims.exp
        for s, nblk in psd_runs:
            d = s * (s + 1) // 2
            ws = w[:, off:off + d * nblk].reshape(B, nblk, d)
            U, Bm, _ = _psd_factor(ws, s)
            st.append((U, Bm))
            off += d * nblk
        if dims.pow3:
            npw = len(dims.pow3)
            ws = w[:, off:off + 3 * npw].reshape(B, npw, 3)
            alphas = device_constant(dims.pow3, w.dtype, w.device)
            st.append(dproj_pow3(ws, alphas))
            off += 3 * npw
        return st

    def apply(state, v: torch.Tensor) -> torch.Tensor:
        """D Pi_K(w) v for v (B, m), or for a stack of vectors per lane
        (B, k, m) (the state broadcasts over the middle axes)."""
        lead = v.shape[:-1]
        mid = (1,) * (v.ndim - 2)

        def ex(t):
            return t.reshape(t.shape[:1] + mid + t.shape[1:])

        parts = []
        it = iter(state)
        off = 0
        if dims.zero:
            parts.append(torch.zeros_like(v[..., :dims.zero]))
            off += dims.zero
        if dims.nonneg:
            mask = ex(next(it))
            parts.append(mask.to(v.dtype) * v[..., off:off + dims.nonneg])
            off += dims.nonneg
        for d, nblk in soc_runs:
            ws = ex(next(it))
            vs = v[..., off:off + d * nblk].reshape(lead + (nblk, d))
            parts.append(_soc_dapply(ws, vs).reshape(lead + (-1,)))
            off += d * nblk
        if dims.exp:
            blocks = ex(next(it))
            vs = v[..., off:off + 3 * dims.exp].reshape(lead + (dims.exp, 3))
            parts.append((blocks * vs[..., None, :]).sum(-1)
                         .reshape(lead + (-1,)))
            off += 3 * dims.exp
        for s, nblk in psd_runs:
            d = s * (s + 1) // 2
            U, Bm = (ex(t) for t in next(it))
            vs = v[..., off:off + d * nblk].reshape(lead + (nblk, d))
            parts.append(_psd_apply(U, Bm, vs, s).reshape(lead + (-1,)))
            off += d * nblk
        if dims.pow3:
            blocks = ex(next(it))
            npw = len(dims.pow3)
            vs = v[..., off:off + 3 * npw].reshape(lead + (npw, 3))
            parts.append((blocks * vs[..., None, :]).sum(-1)
                         .reshape(lead + (-1,)))
            off += 3 * npw
        if not parts:
            return v[..., :0]
        return torch.cat(parts, dim=-1)

    return factor, apply


def make_cone_dproj_apply(dims: ConeDims):
    """fn(w, v) -> D Pi_K(w) @ v without materializing the (m, m) matrix.
    One-shot convenience over make_cone_dproj_factored."""
    factor, apply = make_cone_dproj_factored(dims)

    def apply_once(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return apply(factor(w), v)

    return apply_once


def make_cone_dproj_dense(dims: ConeDims):
    """fn(v) -> dense (B, m, m) generalized Jacobian of Pi_K at v."""
    m = dims.total
    n_zero = dims.zero
    soc_runs = _group_runs(dims.soc)
    psd_runs = _group_runs(dims.psd)

    def dproj(v: torch.Tensor) -> torch.Tensor:
        B = v.shape[0]
        J = v.new_zeros(B, m, m)
        off = n_zero  # zero-cone block stays 0
        if dims.nonneg:
            idx = torch.arange(off, off + dims.nonneg, device=v.device)
            J[:, idx, idx] = (v[:, off:off + dims.nonneg] > 0).to(v.dtype)
            off += dims.nonneg

        def place(blocks, d, nblk):
            ri, ci = _block_scatter_idx(off, d, nblk, v.device)
            J[:, ri, ci] = blocks.reshape(B, -1)

        for d, nblk in soc_runs:
            seg = v[:, off:off + d * nblk].reshape(B, nblk, d)
            place(dproj_soc(seg), d, nblk)
            off += d * nblk
        if dims.exp:
            seg = v[:, off:off + 3 * dims.exp].reshape(B, dims.exp, 3)
            place(dproj_exp(seg), 3, dims.exp)
            off += 3 * dims.exp
        for s, nblk in psd_runs:
            d = s * (s + 1) // 2
            seg = v[:, off:off + d * nblk].reshape(B, nblk, d)
            place(dproj_psd_svec(seg, s), d, nblk)
            off += d * nblk
        if dims.pow3:
            npw = len(dims.pow3)
            seg = v[:, off:off + 3 * npw].reshape(B, npw, 3)
            alphas = device_constant(dims.pow3, v.dtype, v.device)
            place(dproj_pow3(seg, alphas), 3, npw)
            off += 3 * npw
        return J

    return dproj


def _soc_spectral(wb: torch.Tensor):
    """Closed-form eigendecomposition (Q, lam) of the SOC projection
    Jacobian at (..., d) blocks (Q orthogonal (..., d, d), lam in [0, 1]).

    On the projection region: eigenvalue 1 on (1, xhat)/sqrt2, 0 on
    (1, -xhat)/sqrt2, and (1 + t/r)/2 on the tangent space (0, u), u
    orthogonal to xhat, whose basis comes from the sign-robust Householder
    reflection mapping e1 to xhat. Inside / polar: Q = I, lam = 1 / 0."""
    d = wb.shape[-1]
    dtype = wb.dtype
    lead = wb.shape[:-1]
    t = wb[..., 0]
    x = wb[..., 1:]
    r = torch.linalg.vector_norm(x, dim=-1)
    safe_r = torch.where(r > 0, r, 1.0)
    e1 = torch.eye(d - 1, dtype=dtype, device=wb.device)[0]
    xh = torch.where((r > 0)[..., None], x / safe_r[..., None], e1)
    # Householder v = xh + sign(xh_0) e1 (never degenerate); H = I - 2vv'
    # has first column -sign(xh_0) xh and remaining columns an
    # orthonormal basis of xh's orthogonal complement
    sgn = torch.where(xh[..., 0] >= 0, 1.0, -1.0).to(dtype)
    hv = torch.cat([(xh[..., 0] + sgn)[..., None], xh[..., 1:]], dim=-1)
    hv = hv / torch.linalg.vector_norm(hv, dim=-1, keepdim=True)
    eye_t = torch.eye(d - 1, dtype=dtype, device=wb.device)
    H = eye_t - 2.0 * hv[..., :, None] * hv[..., None, :]
    inv_sqrt2 = 0.5 ** 0.5
    ones = torch.ones(lead + (1,), dtype=dtype, device=wb.device)
    q1 = torch.cat([ones, xh], dim=-1) * inv_sqrt2
    q2 = torch.cat([ones, -xh], dim=-1) * inv_sqrt2
    T = torch.cat([torch.zeros(lead + (1, d - 1), dtype=dtype,
                               device=wb.device), H], dim=-2)
    # columns: [q1 | q2 | tangent basis (drop H's first column = +-xh)]
    Qb = torch.cat([q1[..., :, None], q2[..., :, None], T[..., :, 1:]],
                   dim=-1)
    lam_t = torch.clamp(0.5 * (1.0 + t / safe_r), 0.0, 1.0)
    lamb = torch.cat([ones, torch.zeros_like(ones),
                      lam_t[..., None].expand(lead + (d - 2,))], dim=-1)
    inside = r <= t
    polar = r <= -t
    eye = torch.eye(d, dtype=dtype, device=wb.device)
    Qb = torch.where((inside | polar)[..., None, None], eye, Qb)
    lamb = torch.where(inside[..., None], 1.0,
                       torch.where(polar[..., None], 0.0, lamb))
    return Qb, lamb


def _sym_eig3(Db: torch.Tensor):
    """Closed-form eigendecomposition of symmetric (..., 3, 3) blocks:
    the trigonometric (Smith) eigenvalue formula plus cross-product
    eigenvectors with degeneracy-safe fallbacks. Q is exactly orthogonal
    by construction (v2 = v3 x v1 after Gram-Schmidt). Returns
    (lam (..., 3), Q (..., 3, 3)), eigenvalues in descending order."""
    A = 0.5 * (Db + Db.mT)
    dtype = A.dtype
    dev = A.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    Aq = A - q[..., None, None] * eye3
    p2 = (Aq * Aq).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    Bm = Aq / p[..., None, None]
    detB = (
        Bm[..., 0, 0] * (Bm[..., 1, 1] * Bm[..., 2, 2]
                         - Bm[..., 1, 2] * Bm[..., 2, 1])
        - Bm[..., 0, 1] * (Bm[..., 1, 0] * Bm[..., 2, 2]
                           - Bm[..., 1, 2] * Bm[..., 2, 0])
        + Bm[..., 0, 2] * (Bm[..., 1, 0] * Bm[..., 2, 1]
                           - Bm[..., 1, 1] * Bm[..., 2, 0])
    )
    rr = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(rr) / 3.0
    two_pi_3 = 2.0943951023931953
    e1 = q + 2.0 * p * torch.cos(phi)               # largest
    e3 = q + 2.0 * p * torch.cos(phi + two_pi_3)    # smallest
    e2 = 3.0 * q - e1 - e3
    iso = p2 <= 1e-14 * (1.0 + q * q)  # A ~ q I: any basis works

    ex = eye3[0].expand(A.shape[:-1])
    ey = eye3[1].expand(A.shape[:-1])

    def eigvec(lam_val, fallback):
        M = A - lam_val[..., None, None] * eye3
        c0 = torch.linalg.cross(M[..., 0, :], M[..., 1, :])
        c1 = torch.linalg.cross(M[..., 0, :], M[..., 2, :])
        c2 = torch.linalg.cross(M[..., 1, :], M[..., 2, :])
        cands = torch.stack([c0, c1, c2], dim=-2)
        ns = (cands * cands).sum(dim=-1)
        best = ns.argmax(dim=-1)
        v = torch.gather(cands, -2, best[..., None, None].expand(
            best.shape + (1, 3))).squeeze(-2)
        nmax = ns.amax(dim=-1)
        nv = torch.sqrt(torch.clamp_min(nmax, 1e-30))
        ok = nmax > 1e-24 * (1.0 + lam_val * lam_val) ** 2
        return torch.where(ok[..., None], v / nv[..., None], fallback)

    def dot(a, b):
        return (a * b).sum(dim=-1, keepdim=True)

    v1 = eigvec(e1, ex)
    v3 = eigvec(e3, ey)
    # Gram-Schmidt v3 against v1, with an axis fallback if parallel
    v3 = v3 - dot(v1, v3) * v1
    n3 = torch.linalg.vector_norm(v3, dim=-1, keepdim=True)
    alt = ey - dot(v1, ey) * v1
    alt2 = ex - dot(v1, ex) * v1
    alt = torch.where(torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
                      > 0.1, alt, alt2)
    v3 = torch.where(n3 > 1e-6, v3 / torch.clamp_min(n3, 1e-30),
                     alt / torch.linalg.vector_norm(alt, dim=-1,
                                                    keepdim=True))
    v2 = torch.linalg.cross(v3, v1)
    Qb = torch.stack([v1, v2, v3], dim=-1)
    Qb = torch.where(iso[..., None, None], eye3, Qb)
    lam = torch.where(iso[..., None], q[..., None],
                      torch.stack([e1, e2, e3], dim=-1))
    return lam, Qb


def make_cone_dproj_spectral(dims: ConeDims):
    """fn(w) -> (Q, lam): the (B, m, m) orthogonal eigenbasis and the
    (B, m) eigenvalues of the generalized projection Jacobian D Pi_K(w),
    D = Q diag(lam) Q' with lam in [0, 1]. It powers the exact
    spectral-Schur KKT solve (solver/kkt.py). Closed forms everywhere
    but exp/pow (the closed-form 3x3 eigh of their implicit Jacobian):

      zero:   Q = I, lam = 0
      nonneg: Q = I, lam = 1[w > 0]
      soc:    exact eigenstructure of the projection Jacobian
      psd:    the Loewner operator diagonalizes in the svec rotation by
              its eigenvector matrix: Q-block = symkron(U), lam = B_ij
      exp/pow: eigendecomposition of the 3x3 implicit Jacobian
    """
    m = dims.total
    soc_runs = _group_runs(dims.soc)
    psd_runs = _group_runs(dims.psd)

    def spectral(w: torch.Tensor):
        B = w.shape[0]
        dtype = w.dtype
        dev = w.device
        Q = torch.eye(m, dtype=dtype, device=dev).repeat(B, 1, 1)
        lam = w.new_zeros(B, m)
        off = dims.zero  # zero rows keep Q = I, lam = 0

        def place(Qb, lamb, d, nblk):
            ri, ci = _block_scatter_idx(off, d, nblk, dev)
            Q[:, ri, ci] = Qb.reshape(B, -1)
            lam[:, off:off + d * nblk] = lamb.reshape(B, -1)

        if dims.nonneg:
            lam[:, off:off + dims.nonneg] = (
                w[:, off:off + dims.nonneg] > 0).to(dtype)
            off += dims.nonneg
        for d, nblk in soc_runs:
            seg = w[:, off:off + d * nblk].reshape(B, nblk, d)
            place(*_soc_spectral(seg), d, nblk)
            off += d * nblk
        if dims.exp:
            seg = w[:, off:off + 3 * dims.exp].reshape(B, dims.exp, 3)
            lamb, Qb = _sym_eig3(dproj_exp(seg))
            place(Qb, torch.clamp(lamb, 0.0, 1.0), 3, dims.exp)
            off += 3 * dims.exp
        for s, nblk in psd_runs:
            d = s * (s + 1) // 2
            seg = w[:, off:off + d * nblk].reshape(B, nblk, d)
            rows, cols = svec_indices(s)
            U, Bm, _ = _psd_factor(seg, s)
            basis = torch.eye(d, dtype=dtype, device=dev)
            # svec rotation by U: column j = svec(U sym(e_j) U')
            with full_f32():
                Qb = sym_to_svec(U[..., None, :, :]
                                 @ svec_to_sym(basis, s)
                                 @ U[..., None, :, :].mT).mT
            lamb = Bm[..., torch.as_tensor(rows, device=dev),
                      torch.as_tensor(cols, device=dev)]
            place(Qb, torch.clamp(lamb, 0.0, 1.0), d, nblk)
            off += d * nblk
        if dims.pow3:
            npw = len(dims.pow3)
            seg = w[:, off:off + 3 * npw].reshape(B, npw, 3)
            alphas = device_constant(dims.pow3, dtype, dev)
            lamb, Qb = _sym_eig3(dproj_pow3(seg, alphas))
            place(Qb, torch.clamp(lamb, 0.0, 1.0), 3, npw)
            off += 3 * npw
        return Q, lam

    return spectral
