"""Kernel K1 (the fused polyhedral ADMM epoch), version 2, on the CPU.

The CUDA kernel (cvxpylayers_tpu_torch/csrc/admm_epoch.cu) runs only on
the card, where chip_smoke.py holds it against its plain version. Here:

(a) the wrapper's launch plan (register tile, threads per instance,
    instances per block, shared bytes; else version 1's shared or
    device-memory layout) as a pure function of the shape, the word size
    and the shared memory a block may opt into;
(b) the register branch's tile map: every element of A and M^{-1} is held
    by exactly one thread, and every row's state by one writing lane;
(c) a numpy model of the register branch, lane by lane over whole blocks
    of packed instances: the tiles, the shuffles of the in-warp A't
    reduction and of the reduce-scatter (with its selects and its order),
    the per-warp partials, sigma x - q double-buffered, and y times
    1 / rho, held at f64 against the port's plain version (1e-12) and
    against the reference's own kernel, pallas_admm.polyhedral_inner_epoch
    in interpret mode (as tests/test_torch_port_kernels.py runs it; it
    sums its matvecs in f32 whatever the input type, so at the f32 bound);
(d) a NaN lane stays in its lane; without a CUDA toolkit the wrapper's
    CUDA route raises instead of falling back.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cvxpylayers_tpu.solver.pallas_admm import (
    polyhedral_inner_epoch as jax_epoch,
)
from cvxpylayers_tpu_torch import cuda_build
from cvxpylayers_tpu_torch.solver import cuda_admm

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_OPTIN_H100 = 232448  # shared memory one block may opt into on an H100
_ORDER = ("minv", "A", "q", "b", "rho", "x", "z", "y")
_SIGMA, _ALPHA = 1e-6, 1.6
# the Pallas kernel accumulates its matvecs in f32 (preferred_element_type)
_ATOL_PALLAS = 1e-5


def _inputs(B, n, m, seed):
    r = np.random.default_rng(seed)
    return dict(
        minv=r.standard_normal((B, n, n)) * 0.05,
        A=r.standard_normal((B, m, n)) * 0.1,
        q=r.standard_normal((B, n)),
        b=r.standard_normal((B, m)),
        rho=0.1 * (1 + r.random((B, m))),
        x=r.standard_normal((B, n)) * 0.1,
        z=r.standard_normal((B, m)) * 0.1,
        y=r.standard_normal((B, m)) * 0.1,
    )


# --------------------------------------------------------------- the model


def _lanes(tile):
    """Lane indices of one block: instance slot, row group, column lane."""
    ipb = cuda_admm.instances_per_block(tile.threads)
    lane = np.arange(tile.threads * ipb)
    local = lane % tile.threads
    return lane, lane // tile.threads, local >> 3, local & 7


def _owned_rows(tile, rows, tc):
    """For each lane, the rows (of a row group's `rows`) whose sums land
    in it after the reduce-scatter, and whether it writes them."""
    per_lane = max(1, rows // 8)
    dup = max(1, 8 // rows)
    slot = (tc[:, None] * per_lane + np.arange(per_lane)[None, :]
            if rows >= 8 else (tc // dup)[:, None])
    return slot, (tc % dup == 0)


def _reduce_scatter8(v, lane, tc):
    """The kernel's reduce_scatter8 over the lane axis of v (lanes, CNT):
    offsets 4, 2, 1; while a lane carries several values it keeps the
    upper half when its offset bit is set, else the lower, and adds the
    partner's other half (keep + shuffled)."""
    cnt = v.shape[1]
    for off in (4, 2, 1):
        if cnt > 1:
            h = cnt // 2
            up = ((tc & off) != 0)[:, None]
            send = np.where(up, v[:, :h], v[:, h:])
            keep = np.where(up, v[:, h:], v[:, :h])
            v = keep + send[lane ^ off]
            cnt = h
        else:
            v = v + v[lane ^ off]
    return v[:, :max(1, cnt)]


def _k1_model(arrs, tile, *, n_zero, iters):
    """The register branch of K1, block by block, all lanes of a block at
    once (numpy; every shuffle is an index by lane ^ offset)."""
    minv, A, q, b, rho, x0, z0, y0 = (arrs[k] for k in _ORDER)
    B, n = q.shape
    m = b.shape[1]
    V, VM, CA = tile.rows_a, tile.rows_m, tile.cols
    TR = tile.threads // 8
    GW = min(TR, 4)
    NP = TR // GW
    ipb = cuda_admm.instances_per_block(tile.threads)
    lane, slot, tr, tc = _lanes(tile)
    nl = lane.size
    g, npart = tr % GW, tr // GW
    out = [np.empty_like(x0), np.empty_like(z0), np.empty_like(y0)]
    for block in range((B + ipb - 1) // ipb):
        inst = block * ipb + slot
        live = inst < B
        ii = np.where(live, inst, 0)
        cols = tc[:, None] + 8 * np.arange(CA)[None, :]           # (nl, CA)
        rows_a = tr[:, None] * V + np.arange(V)[None, :]           # (nl, V)
        rows_m = tr[:, None] * VM + np.arange(VM)[None, :]
        a = np.zeros((nl, V, CA))
        mi = np.zeros((nl, VM, CA))
        for s in range(V):
            for c in range(CA):
                ok = live & (rows_a[:, s] < m) & (cols[:, c] < n)
                a[ok, s, c] = A[ii[ok], rows_a[ok, s], cols[ok, c]]
        for s in range(VM):
            for c in range(CA):
                ok = live & (rows_m[:, s] < n) & (cols[:, c] < n)
                mi[ok, s, c] = minv[ii[ok], rows_m[ok, s], cols[ok, c]]
        # the rows whose sums land in each lane, and their state
        sa, own_a = _owned_rows(tile, V, tc)
        row = tr[:, None] * V + sa
        ok_r = live[:, None] & (row < m)
        own_r = ok_r & own_a[:, None]
        rr = np.where(ok_r, row, 0)
        z = np.where(ok_r, z0[ii[:, None], rr], 0.0)
        y = np.where(ok_r, y0[ii[:, None], rr], 0.0)
        bb = np.where(ok_r, b[ii[:, None], rr], 0.0)
        rh = np.where(ok_r, rho[ii[:, None], rr], 1.0)
        inv_rho = 1.0 / rh
        eq = row < n_zero
        sm, own_m = _owned_rows(tile, VM, tc)
        col = tr[:, None] * VM + sm
        ok_c = live[:, None] & (col < n)
        own_c = ok_c & own_m[:, None]
        cc = np.where(ok_c, col, 0)
        x = np.where(ok_c, x0[ii[:, None], cc], 0.0)
        qq = np.where(ok_c, q[ii[:, None], cc], 0.0)
        # shared memory of the block's instances, by logical index
        t_s = np.zeros((ipb, TR * V))
        xt_s = np.zeros((ipb, 8 * CA))
        c_s = np.zeros((2, ipb, 8 * CA))
        p_s = np.zeros((ipb, NP, 8 * CA))
        slot_r = np.broadcast_to(slot[:, None], row.shape)[own_r]
        slot_c = np.broadcast_to(slot[:, None], col.shape)[own_c]
        t_s[slot_r, row[own_r]] = (rh * z - y)[own_r]
        c_s[0, slot_c, col[own_c]] = (_SIGMA * x - qq)[own_c]
        for it in range(iters):
            cur = it & 1
            tv = t_s[slot[:, None], rows_a]                          # (nl, V)
            acc = np.zeros((nl, CA))
            for s in range(V):
                acc = acc + a[:, s, :] * tv[:, s:s + 1]
            off = 8
            while off < 8 * GW:
                acc = acc + acc[lane ^ off]
                off <<= 1
            for c in range(CA):
                w = g == c % GW
                p_s[slot[w], npart[w], cols[w, c]] = acc[w, c]
            rhs = c_s[cur, slot[:, None], cols]
            for p in range(NP):
                rhs = rhs + p_s[slot[:, None], p, cols]
            accm = np.zeros((nl, VM))
            for c in range(CA):
                accm = accm + mi[:, :, c] * rhs[:, c:c + 1]
            xt = _reduce_scatter8(accm, lane, tc)
            x = _ALPHA * xt + (1 - _ALPHA) * x
            xt_s[slot_c, col[own_c]] = xt[own_c]
            c_s[1 - cur, slot_c, col[own_c]] = (_SIGMA * x - qq)[own_c]
            xv = xt_s[slot[:, None], cols]
            accz = np.zeros((nl, V))
            for c in range(CA):
                accz = accz + a[:, :, c] * xv[:, c:c + 1]
            zt = _reduce_scatter8(accz, lane, tc)
            w = _ALPHA * zt + (1 - _ALPHA) * z + y * inv_rho
            with np.errstate(invalid="ignore"):
                d = bb - w
                relu = np.where((d > 0) | np.isnan(d), d, 0.0)
            zn = np.where(eq, bb, bb - relu)
            y = rh * (w - zn)
            z = zn
            t_s[slot_r, row[own_r]] = (rh * zn - y)[own_r]
        for k, (val, own, idx) in enumerate(((x, own_c, col), (z, own_r, row),
                                             (y, own_r, row))):
            out[k][np.broadcast_to(inst[:, None], idx.shape)[own],
                   idx[own]] = val[own]
    return out


def _plain(arrs, **kw):
    out = cuda_admm.polyhedral_inner_epoch(
        *(torch.as_tensor(arrs[k]) for k in _ORDER), sigma=_SIGMA,
        alpha=_ALPHA, **kw)
    return [o.numpy() for o in out]


def _pallas_interpret(arrs, **kw):
    """The reference's Pallas kernel in interpret mode, one grid step."""
    orig_call = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig_call(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp_call):
        out = jax_epoch(*(jnp.asarray(arrs[k]) for k in _ORDER),
                        tile=arrs["q"].shape[0], sigma=_SIGMA, alpha=_ALPHA,
                        **kw)
    return [np.asarray(o) for o in out]


# ------------------------------------------------------------ launch plan


@pytest.mark.parametrize("n,m,elem,want", [
    (50, 120, 4, ("register", 64, 2, 0)),     # box-QP f32, B = 1024 or 792
    (50, 120, 8, ("register", 128, 1, 1)),    # box-QP f64
    (120, 400, 4, ("device", 256, 1, -1)),    # beyond shared memory
    (120, 400, 8, ("device", 256, 1, -1)),
    (20, 21, 4, ("register", 32, 4, 2)),      # simplex layer
    (5, 8, 4, ("register", 8, 16, 3)),        # LAD layer
], ids=["box-qp-f32", "box-qp-f64", "beyond-f32", "beyond-f64", "simplex",
        "lad"])
def test_launch_plan_at_chip_smoke_shapes(n, m, elem, want):
    plan = cuda_admm.launch_plan(n, m, elem, _OPTIN_H100)
    assert (plan.branch, plan.threads, plan.instances, plan.tile) == want
    if plan.branch == "register":
        tile = cuda_admm.TILES[plan.tile]
        assert cuda_admm.tile_fits(tile, n, m)
        assert cuda_admm.tile_registers(tile, elem) <= (
            cuda_admm.REGISTER_BUDGET)
        assert plan.threads * plan.instances == max(
            tile.threads, cuda_admm.BLOCK_THREADS)
        assert plan.smem_bytes == cuda_admm.register_shared_bytes(tile, elem)
    else:
        assert plan.smem_bytes == 0
    assert plan == cuda_admm.launch_plan(n, m, elem, _OPTIN_H100)


def test_launch_plan_at_the_register_and_shared_edges():
    plan = cuda_admm.launch_plan
    # the box-QP tiles cover n <= 56 and m <= 128; one more goes to shared
    assert plan(56, 128, 4, _OPTIN_H100).branch == "register"
    assert plan(57, 120, 4, _OPTIN_H100).branch == "shared"
    assert plan(50, 129, 4, _OPTIN_H100).branch == "shared"
    # version 1's shared layout up to the opt-in bytes, then device memory
    need = cuda_admm.shared_bytes(57, 120, 4)
    assert need == 4 * (4 * 57 + 5 * 120 + (120 + 57) * 57)
    assert plan(57, 120, 4, need) == cuda_admm.EpochPlan(
        "shared", 128, 1, -1, need)
    assert plan(57, 120, 4, need - 1).branch == "device"
    assert plan(57, 120, 4, need - 1).smem_bytes == 0
    # chip_smoke.py's shared-branch cases: n = 80, m = 200 fits no tile
    for elem in (4, 8):
        assert plan(80, 200, elem, _OPTIN_H100) == cuda_admm.EpochPlan(
            "shared", 256, 1, -1, cuda_admm.shared_bytes(80, 200, elem))
    # f64 box-QP: tile 0 fits the shape but not the register budget
    assert cuda_admm.tile_registers(cuda_admm.TILES[0], 8) > (
        cuda_admm.REGISTER_BUDGET)
    assert [p.tile for p in cuda_admm.plan_candidates(
        50, 120, 8, _OPTIN_H100) if p.branch == "register"] == [0, 1]
    # shared bytes of the register branch: t, xt, sigma x - q twice and a
    # partial per warp, each padded to 16 bytes, per packed instance
    box = cuda_admm.TILES[0]
    assert cuda_admm.register_shared_bytes(box, 4) == 2 * 4 * (
        128 + 3 * 64 + 2 * 64)
    lad = cuda_admm.TILES[3]
    assert cuda_admm.register_shared_bytes(lad, 8) == 16 * 8 * (8 + 4 * 16)
    # every compiled tile is a multiple of 8 lanes with power-of-two rows
    for tile in cuda_admm.TILES:
        assert tile.threads % 8 == 0
        assert tile.rows_a & (tile.rows_a - 1) == 0
        assert tile.rows_m & (tile.rows_m - 1) == 0


@pytest.mark.parametrize("tile_index,n,m", [
    (0, 50, 120), (1, 37, 99), (2, 20, 21), (3, 3, 7),
], ids=["box-f32", "box-f64-ragged", "simplex", "lad-ragged"])
def test_every_element_and_row_has_one_owner(tile_index, n, m):
    tile = cuda_admm.TILES[tile_index]
    lane, slot, tr, tc = _lanes(tile)
    mine = slot == 0
    tr, tc = tr[mine], tc[mine]
    count_a = np.zeros((m, n), int)
    count_m = np.zeros((n, n), int)
    for t, c in zip(tr, tc):
        for s in range(tile.rows_a):
            for k in range(tile.cols):
                i, j = t * tile.rows_a + s, c + 8 * k
                if i < m and j < n:
                    count_a[i, j] += 1
        for s in range(tile.rows_m):
            for k in range(tile.cols):
                i, j = t * tile.rows_m + s, c + 8 * k
                if i < n and j < n:
                    count_m[i, j] += 1
    assert (count_a == 1).all() and (count_m == 1).all()
    # each row's sum lands in lanes of its own row group, written by one
    for rows, size in ((tile.rows_a, m), (tile.rows_m, n)):
        slots, own = _owned_rows(tile, rows, tc)
        held = tr[:, None] * rows + slots
        writers = np.bincount(held[own[:, None].repeat(slots.shape[1], 1)]
                              .ravel(), minlength=size)
        assert (writers[:size] == 1).all()
        holders = np.bincount(held.ravel(), minlength=size)[:size]
        assert (holders == max(1, 8 // rows)).all()


# --------------------------------------------------------- the numpy model


@pytest.mark.parametrize("tile_index,B,n,m,n_zero,iters", [
    (0, 3, 10, 14, 3, 12),   # box-QP tile, 2 packed, the last block ragged
    (2, 5, 20, 21, 1, 10),   # simplex tile and shape, 4 packed
    (3, 21, 5, 8, 2, 30),    # LAD tile, 16 packed, 4 to a warp
], ids=["box-qp-tile", "simplex", "lad"])
def test_tile_model_matches_plain_and_reference_f64(tile_index, B, n, m,
                                                    n_zero, iters):
    arrs = _inputs(B, n, m, seed=B + n)
    tile = cuda_admm.TILES[tile_index]
    assert cuda_admm.tile_fits(tile, n, m)
    kw = dict(n_zero=n_zero, iters=iters)
    model = _k1_model(arrs, tile, **kw)
    for got, plain, ref in zip(model, _plain(arrs, **kw),
                               _pallas_interpret(arrs, **kw)):
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got, ref, rtol=0, atol=_ATOL_PALLAS)


def test_tile_model_keeps_a_nan_lane_in_its_lane():
    # the LAD tile packs four instances to a warp: a NaN M^{-1} lane must
    # not reach its neighbours through the shuffles or shared memory
    arrs = _inputs(20, 5, 8, seed=7)
    arrs["minv"][9] = np.nan
    kw = dict(n_zero=0, iters=20)  # an equality row would keep z = b
    model = _k1_model(arrs, cuda_admm.TILES[3], **kw)
    plain = _plain(arrs, **kw)
    others = np.arange(20) != 9
    for got, want in zip(model, plain):
        assert np.isnan(got[9]).all() and np.isnan(want[9]).all()
        assert np.isfinite(got[others]).all()
        np.testing.assert_allclose(got[others], want[others], rtol=0,
                                   atol=1e-12)


def test_cuda_route_raises_without_toolkit_and_never_falls_back(
        tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_admm, "_LIB", None)
    cuda_admm._device_plan.cache_clear()
    before = cuda_admm.LAUNCHES
    # the CUDA route plans first, and the plan needs the built kernel
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_admm.epoch_plan(50, 120, torch.float32, "cuda:0")
    # a tensor on neither device raises; only the CPU runs the plain version
    meta = [torch.empty_like(torch.as_tensor(v), device="meta")
            for v in _inputs(2, 3, 4, seed=0).values()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_admm.polyhedral_inner_epoch(*meta, n_zero=0, iters=1,
                                         sigma=_SIGMA, alpha=_ALPHA)
    assert cuda_admm.LAUNCHES == before
    cuda_admm._device_plan.cache_clear()
