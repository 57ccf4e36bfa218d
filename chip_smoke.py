#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port, cvxpylayers_tpu_torch.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. build   compile every CUDA kernel of the port from csrc/, all at once
  2. kernels hold each kernel against its plain PyTorch version on the
             card, at the main paths' shapes and at the edge shapes
             (ragged batch, equality rows, a zero column, beyond shared
             memory, f64, the small layers' shapes packed several to a
             block, a NaN lane among finite ones), each K1 case on the
             launch plan it expects (every branch: register tiles, shared
             and device memory), the plan's geometry held against the
             one the source derives; time the kernel (K1 also in a CUDA
             graph), the plain version, the one PyTorch call that
             computes the same function where there is one, and the
             card's bound
  3. main    each layer path of PATHS at full width (B=1024, f32)
             through CvxpyLayer(...).solve_with_info(*params), its kernel
             launches counted from 0 just before it and read just after:
             the OptNet box-QP projection layer (n=50, G 20x50) with
             solve_method="admm" (kernel K1) and "ipm" (kernel K2); the
             simplex projection at n=50 on the shared constant-P/A route
             (no kernel: K1 must stay at 0) and, for the record, on the
             dense route; a box-constrained LP through the self-dual
             embedding (K2 once per iteration). Solved fraction, route,
             iterations, ms per call with fresh inputs, agreement of the
             first lanes with the port's own f64 CPU run; a device
             profile of one call of each but the dense simplex
  4. grad    the same paths with requires_grad on the parameters and a
             backward pass: finite gradients, agreement of the first 8
             instances with the port's f64 CPU gradients, ms per
             forward+backward
  5. small   the simplex-projection and LAD layers at B=256 by every
             route: shared and dense ADMM, the IPM's primal-dual form and
             its self-dual embedding

Imports nothing of JAX or of cvxpylayers_tpu. The second-to-last lines
are the card's name and power limit and the per-kernel JSON record; the
last line is {"ok": true, "device": {...}}.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peak rates (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12   # float32 on the CUDA cores (no tensor cores)
PEAK_F64_FLOPS = 34e12   # float64 on the CUDA cores
PEAK_BYTES = 3.35e12     # HBM3

# every tensor of every phase lies here; a rehearsal without a card sets it
# to "cpu" and calls the phase functions at small sizes
DEV = "cuda"

BOX_QP_ARGS = {
    "eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-3,
    "admm_eps_rel": 1e-3, "max_iters": 50, "epoch": 50,
    "refine_steps": 5, "schur_iters": 5,
}
SIMPLEX_ARGS = {
    "eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-3,
    "admm_eps_rel": 1e-3, "max_iters": 500,
}
LAD_ARGS = {
    "eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-4,
    "admm_eps_rel": 1e-4, "max_iters": 600, "epoch": 100,
    "refine_steps": 4, "matmul_precision": "highest",
}


def ipm_args(args, **extra):
    """The same settings with the interior-point base solver."""
    return dict(args, solve_method="ipm", **extra)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------- kernels


def epoch_inputs(B, n, m, n_zero, dtype, seed):
    """Inputs shaped as the ADMM epoch gets them: an equilibrated A, rho
    0.1 on inequality rows and 100 on equality rows, M^{-1} of
    P + sigma I + A' diag(rho) A with P = I, and a warm state."""
    r = np.random.default_rng(seed)
    dev = DEV
    A = torch.as_tensor(r.standard_normal((B, m, n)) / np.sqrt(n),
                        device=dev)
    rho = torch.full((B, m), 0.1, dtype=torch.float64, device=dev)
    rho[:, :n_zero] = 100.0
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    M = (1.0 + 1e-6) * eye + A.mT @ (A * rho[:, :, None])
    minv = torch.cholesky_inverse(torch.linalg.cholesky(M))
    arrs = dict(
        minv=minv, A=A,
        q=torch.as_tensor(r.standard_normal((B, n)), device=dev),
        b=torch.as_tensor(r.standard_normal((B, m)), device=dev),
        rho=rho,
        x=torch.as_tensor(0.1 * r.standard_normal((B, n)), device=dev),
        z=torch.as_tensor(0.1 * r.standard_normal((B, m)), device=dev),
        y=torch.as_tensor(0.1 * r.standard_normal((B, m)), device=dev),
    )
    return {k: v.to(dtype).contiguous() for k, v in arrs.items()}


_ORDER = ("minv", "A", "q", "b", "rho", "x", "z", "y")


def time_cuda(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def epoch_bound_ms(B, n, m, iters, elem_bytes):
    """Least time for `iters` epoch steps on B instances: the larger of
    the operations over the CUDA-core peak and the bytes (each input read
    once, each output written once) over the memory rate."""
    ops = B * iters * (4 * m * n + 2 * n * n + 11 * m + 6 * n)
    nbytes = elem_bytes * B * (n * n + m * n + 2 * n + 4 * m + n + 2 * m)
    peak = PEAK_F32_FLOPS if elem_bytes == 4 else PEAK_F64_FLOPS
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def epoch_error(cuda_admm, a, kw, out, lanes=None):
    """(max abs error, tolerance, plain f64 noise) of a kernel's (x, z, y)
    against the plain version on the same inputs `a`. The tolerance is
    four times the plain version's own rounding error at its dtype (its
    distance from the same loop in f64 on the same inputs), and at least
    1e-5 (f32) / 1e-12 (f64) of the output's scale, since the two sum the
    matvecs in another order. `lanes` (a boolean mask over the batch)
    limits the comparison to those instances."""
    ref = cuda_admm.polyhedral_inner_epoch_plain(
        *(a[k] for k in _ORDER), **kw)
    ref64 = cuda_admm.polyhedral_inner_epoch_plain(
        *(a[k].double() for k in _ORDER), **kw)
    sync()
    if lanes is not None:
        out, ref, ref64 = ([o[lanes] for o in v] for v in (out, ref, ref64))
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    noise = max(float((r.double() - r64).abs().max())
                for r, r64 in zip(ref, ref64))
    scale = max(float(r.abs().max()) for r in ref)
    floor = (1e-5 if out[0].dtype == torch.float32 else 1e-12) * scale
    return err, max(4.0 * noise, floor), noise


MS_GRAPH = "CUDA events around 20 launches captured in one CUDA graph"
MS_EVENTS = "CUDA events around 20 plain launches after 3"


def time_graph(fn, reps=20, warmup=3):
    """Device ms of one launch: `reps` launches captured in one CUDA graph,
    so no host time falls between them (a small kernel timed by plain
    back-to-back launches would time the host), replayed three times
    after `warmup` plain launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


# K1's cases: (label, B, n, m, n_zero, dtype, iters, the plan expected on
# an H100 as (branch, threads per instance, instances per block)); every
# branch of the plan is run: the register tiles, version 1's shared
# layout (n = 80, m = 200 fits no tile) and its device-memory layout
K1_CASES = [
    ("main path box-QP f32", 1024, 50, 120, 0, torch.float32, 50,
     ("register", 64, 2)),
    ("main path box-QP f64", 1024, 50, 120, 0, torch.float64, 50,
     ("register", 128, 1)),
    ("ragged B, equality rows f32", 1000, 50, 120, 7, torch.float32, 50,
     ("register", 64, 2)),
    ("beyond shared memory f32", 256, 120, 400, 5, torch.float32, 50,
     ("device", 256, 1)),
    ("beyond shared memory f64", 256, 120, 400, 5, torch.float64, 50,
     ("device", 256, 1)),
    ("beyond the register tiles f32", 256, 80, 200, 5, torch.float32, 50,
     ("shared", 256, 1)),
    ("beyond the register tiles f64", 256, 80, 200, 5, torch.float64, 50,
     ("shared", 256, 1)),
    ("box-QP f32, one wave of version 1", 792, 50, 120, 0, torch.float32,
     50, ("register", 64, 2)),
    ("simplex layer f32", 256, 20, 21, 1, torch.float32, 25,
     ("register", 32, 4)),
    ("LAD layer f32, ragged last block", 250, 5, 8, 0, torch.float32, 100,
     ("register", 8, 16)),
]
# the batch with one NaN M^{-1} lane: the LAD shape, whose tile packs four
# instances to a warp and sixteen to a block
K1_NAN_CASE = ("one NaN lane among packed lanes f32", 64, 5, 8, 0,
               torch.float32, 100, ("register", 8, 16))
K1_NAN_LANE = 9


def check_geometry(cuda_admm, plan, label, n, m, dtype):
    """The plan's threads, instances and shared bytes against those the
    source derives from its branch and tile (admm_epoch_geometry)."""
    out = (ctypes.c_longlong * 3)()
    elem = torch.empty((), dtype=dtype).element_size()
    err = cuda_admm._library().admm_epoch_geometry(
        cuda_admm._BRANCH_CODE[plan.branch], plan.tile, n, m, elem, out)
    if err:
        fail(f"{label}: admm_epoch_geometry refused {plan}: cudaError {err}")
    if tuple(out) != (plan.threads, plan.instances, plan.smem_bytes):
        fail(f"{label}: the source launches {tuple(out)} (threads, "
             f"instances, shared bytes), the plan says {plan}")


def kernel_phase(cuda_admm):
    """K1 against its plain version, each case on the plan it expects.
    Tolerance (epoch_error): the kernel may differ from the plain version
    by at most four times the plain version's own rounding error at its
    dtype, and by at least 1e-5 (f32) / 1e-12 (f64) of the output's
    scale, since the two sum the matvecs in another order. In the NaN
    case the NaN lane's outputs must all be NaN and every other lane must
    hold to that tolerance."""
    shapes = []
    on_card = DEV == "cuda"
    for case in K1_CASES + [K1_NAN_CASE]:
        label, B, n, m, n_zero, dtype, iters, want = case
        a = epoch_inputs(B, n, m, n_zero, dtype, seed=B + n_zero)
        lanes = None
        if case is K1_NAN_CASE:
            a["minv"][K1_NAN_LANE] = float("nan")
            lanes = torch.arange(B, device=DEV) != K1_NAN_LANE
        kw = dict(n_zero=n_zero, iters=iters, sigma=1e-6, alpha=1.6)
        plan = (cuda_admm.epoch_plan(n, m, dtype, a["q"].device)
                if on_card else None)
        got = plan and (plan.branch, plan.threads, plan.instances)
        if on_card and got != want:
            fail(f"{label}: plan {got}, expected {want}")
        if on_card:
            check_geometry(cuda_admm, plan, label, n, m, dtype)
        before = cuda_admm.LAUNCHES
        out = cuda_admm.polyhedral_inner_epoch(*(a[k] for k in _ORDER), **kw)
        sync()
        if on_card and cuda_admm.LAUNCHES != before + 1:
            fail(f"{label}: polyhedral_inner_epoch did not launch K1")
        for o in out:
            if tuple(o.shape[:1]) != (B,) or o.dtype != dtype:
                fail(f"{label}: bad output {tuple(o.shape)} {o.dtype}")
            if not bool(torch.isfinite(o if lanes is None else o[lanes])
                        .all()):
                fail(f"{label}: non-finite kernel output")
            if lanes is not None and not bool(
                    torch.isnan(o[K1_NAN_LANE]).all()):
                fail(f"{label}: the NaN lane's outputs are not all NaN")
        err, tol, noise = epoch_error(cuda_admm, a, kw, out, lanes)
        def k1():
            return cuda_admm.polyhedral_inner_epoch(*(a[k] for k in _ORDER),
                                                    **kw)
        ms = time_graph(k1) if on_card else 0.0
        ms_plain_launch = time_cuda(k1, reps=20, warmup=3) if on_card else 0.0
        plain_ms = time_cuda(lambda: cuda_admm.polyhedral_inner_epoch_plain(
            *(a[k] for k in _ORDER), **kw), reps=3)
        elem = torch.empty((), dtype=dtype).element_size()
        bound, bound_by = epoch_bound_ms(B, n, m, iters, elem)
        rec = dict(shape=label, B=B, n=n, m=m, n_zero=n_zero, iters=iters,
                   dtype=str(dtype).replace("torch.", ""),
                   plan=plan and plan._asdict(), max_abs_err=err, tol=tol,
                   plain_f64_noise=noise, ms=ms, ms_method=MS_GRAPH,
                   ms_plain_launch=ms_plain_launch, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by)
        say("kernel", json.dumps(rec))
        if not err <= tol:
            fail(f"{label}: kernel vs plain max abs err {err:.3e} > "
                 f"tol {tol:.3e}")
        shapes.append(rec)
    return shapes[0], shapes


def qr_inputs(B, m, n, dtype, seed, zero_col=False):
    """Matrices shaped as the interior-point solver stacks them,
    M = [Lp'; Bd A_in]: an upper-triangular Cholesky factor on top and
    m - n rows below whose scales spread over four decades, as
    sqrt(z/s) does along the central path."""
    r = np.random.default_rng(seed)
    L = r.standard_normal((B, n, n)) * 0.3
    top = np.linalg.cholesky(L @ L.transpose(0, 2, 1) + np.eye(n))
    rows = r.standard_normal((B, m - n, n)) * 0.3
    rows *= 10.0 ** r.uniform(-2.0, 2.0, size=(B, m - n, 1))
    M = np.concatenate([top.transpose(0, 2, 1), rows], axis=1)
    if zero_col:
        M[::2, :, 0] = 0.0        # degenerate at the first step
        M[1::2, :, n // 2] = 0.0  # stays exactly zero until its own step
    return torch.as_tensor(M, device=DEV).to(dtype).contiguous()


def qr_bound_ms(B, m, n, elem_bytes):
    """Least time for the R factors of B (m, n) matrices: Householder
    costs 2mn^2 - (2/3)n^3 operations per instance; M is read once and R
    written once."""
    ops = B * (2.0 * m * n * n - 2.0 * n ** 3 / 3.0)
    nbytes = elem_bytes * B * (m * n + n * n)
    peak = PEAK_F32_FLOPS if elem_bytes == 4 else PEAK_F64_FLOPS
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def qr_kernel_phase(cuda_linalg):
    """K2 against its plain version. Row signs of R are a convention and
    every caller uses R through R'R = M'M, so the error is measured there:
    max |Rk'Rk - Rp'Rp| between the kernel and the plain version, both
    products formed in f64. Tolerance: four times the plain version's own
    rounding error at its dtype (max |Rp'Rp - M'M| against the f64
    product), and at least 1e-5 (f32) / 1e-12 (f64) of max |M'M|, since
    the two sum the column norms and the reflector products in another
    order."""
    cases = [
        ("main path box-QP f32", 1024, 170, 50, torch.float32, False),
        ("main path box-QP f64", 1024, 170, 50, torch.float64, False),
        ("ragged B, simplex tile f32", 1000, 40, 20, torch.float32, False),
        ("zero columns f32", 1000, 40, 20, torch.float32, True),
        ("beyond shared memory f32", 64, 560, 160, torch.float32, False),
    ]
    shapes = []
    for label, B, m, n, dtype, zero_col in cases:
        M = qr_inputs(B, m, n, dtype, seed=B + m, zero_col=zero_col)
        on_card = M.device.type == "cuda"
        plan = (cuda_linalg.qr_plan(m, n, dtype, M.device) if on_card
                else cuda_linalg.QrPlan(None, None, None))
        if on_card and label.startswith("beyond") == plan.in_shared:
            fail(f"{label}: unexpected branch (in_shared={plan.in_shared})")
        before = cuda_linalg.LAUNCHES
        Rk = cuda_linalg.qr_r(M)
        if on_card:
            torch.cuda.synchronize()
            if cuda_linalg.LAUNCHES != before + 1:
                fail(f"{label}: qr_r did not launch K2")
        Rp = cuda_linalg.house_qr_r_plain(M)
        if tuple(Rk.shape) != (B, n, n) or Rk.dtype != dtype:
            fail(f"{label}: bad output {tuple(Rk.shape)} {Rk.dtype}")
        if not bool(torch.isfinite(Rk).all()):
            fail(f"{label}: non-finite kernel output")
        if bool((Rk.tril(-1) != 0).any()):
            fail(f"{label}: R is not upper triangular")
        M64 = M.double()
        G = M64.mT @ M64
        Gk = Rk.double().mT @ Rk.double()
        Gp = Rp.double().mT @ Rp.double()
        scale = float(G.abs().max())
        err = float((Gk - Gp).abs().max())
        noise = float((Gp - G).abs().max())
        floor = (1e-5 if dtype == torch.float32 else 1e-12) * scale
        tol = max(4.0 * noise, floor)
        if zero_col:
            # the degenerate rule: tau = 0 and the diagonal keeps x_j = 0
            if bool((Rk[::2, 0, 0] != 0).any()) or bool(
                    (Rk[1::2, n // 2, n // 2] != 0).any()):
                fail(f"{label}: a zero column must keep a zero diagonal")
        ms = time_cuda(lambda: cuda_linalg.qr_r(M), reps=20, warmup=3)
        plain_ms = time_cuda(lambda: cuda_linalg.house_qr_r_plain(M), reps=2)
        library_ms = time_cuda(lambda: torch.linalg.qr(M, mode="r"), reps=2)
        elem = M.element_size()
        bound, bound_by = qr_bound_ms(B, m, n, elem)
        rec = dict(kernel="K2", shape=label, B=B, m=m, n=n,
                   dtype=str(dtype).replace("torch.", ""),
                   branch=("shared" if plan.in_shared else "device-memory"),
                   threads=plan.threads, smem_bytes=plan.smem_bytes,
                   max_abs_err=err, tol=tol,
                   gram_scale=scale, rel_err=err / scale,
                   plain_f64_noise=noise, kernel_vs_f64=float(
                       (Gk - G).abs().max()),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound, bound_by=bound_by)
        say("kernel", json.dumps(rec))
        if err > tol:
            fail(f"{label}: K2 vs plain max abs err on R'R {err:.3e} > "
                 f"tol {tol:.3e}")
        shapes.append(rec)
    qr_wave_records(cuda_linalg)
    return shapes[0], shapes


def qr_wave_records(cuda_linalg, m=170, n=50):
    """Timing only: K2 at the main (m, n) in f32 with B = 792 (six blocks
    on each of the 132 SMs, the wave that the tile's shared memory alone
    allows) and B = 1024, timed in turns (792, 1024, 1024, 792)."""
    M = {B: qr_inputs(B, m, n, torch.float32, seed=B + m)
         for B in (792, 1024)}
    times = {792: [], 1024: []}
    for B in (792, 1024, 1024, 792):
        times[B].append(time_cuda(lambda: cuda_linalg.qr_r(M[B]), reps=20,
                                  warmup=3))
    on_card = DEV == "cuda"
    for B, ts in times.items():
        plan = (cuda_linalg.qr_plan(m, n, torch.float32, M[B].device)
                if on_card else cuda_linalg.QrPlan(None, None, None))
        say("kernel_wave", json.dumps(dict(
            kernel="K2", B=B, m=m, n=n, dtype="float32",
            threads=plan.threads, smem_bytes=plan.smem_bytes,
            ms=statistics.mean(ts), ms_turns=ts)))


# ------------------------------------------------------------------ layers


def box_qp_layer(ct, device, n=50, m_ineq=20):
    x = ct.Variable(n)
    v = ct.Parameter(n)
    G = ct.Parameter((m_ineq, n))
    h = ct.Parameter(m_ineq)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x - v)),
                      [G @ x <= h, x >= 0, x <= 1])
    return ct.CvxpyLayer(prob, parameters=[v, G, h], variables=[x],
                         device=device)


def box_qp_params(r, B, n=50, m_ineq=20):
    return [r.standard_normal((B, n)),
            r.standard_normal((B, m_ineq, n)) * 0.3,
            np.abs(r.standard_normal((B, m_ineq))) + 1.0]


def box_lp_layer(ct, device, n=50, m_ineq=20):
    """The box-QP's constraints under a linear cost v'x: an LP layer of
    the prediction-and-optimisation kind, whose interior-point route is
    the self-dual embedding."""
    x = ct.Variable(n)
    v = ct.Parameter(n)
    G = ct.Parameter((m_ineq, n))
    h = ct.Parameter(m_ineq)
    prob = ct.Problem(ct.Minimize(v @ x), [G @ x <= h, x >= 0, x <= 1])
    return ct.CvxpyLayer(prob, parameters=[v, G, h], variables=[x],
                         device=device)


def simplex_layer(ct, device, n=20):
    x = ct.Variable(n)
    v = ct.Parameter(n)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x - v)),
                      [ct.sum(x) == 1, x >= 0])
    return ct.CvxpyLayer(prob, parameters=[v], variables=[x], device=device)


def simplex_params(r, B, n=50):
    return [r.standard_normal((B, n))]


def lad_layer(ct, device, n=2, m=3):
    x = ct.Variable(n, nonneg=True)
    A = ct.Parameter((m, n))
    b = ct.Parameter(m)
    prob = ct.Problem(ct.Minimize(0.5 * ct.pnorm(A @ x - b, 1)))
    return ct.CvxpyLayer(prob, parameters=[A, b], variables=[x],
                         device=device)


def to_dev(arrs, dtype, device=None):
    return [torch.as_tensor(a, dtype=dtype, device=device or DEV)
            for a in arrs]


def sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


class Path:
    """A layer path at full width: its layer, its parameters (and their
    names), its solver_args, the kernel it must launch (`wants`), the
    kernel it must not launch (`forbids`), the route it must take
    ("dense" or "shared"), the lanes held against the port's own f64 CPU
    run, and whether the gradient phase weighs x by a seeded vector
    (sum(x) is constant on the simplex, so its gradient is zero)."""

    def __init__(self, name, layer, build, params, names, args, wants,
                 forbids, route, agree_lanes, weighted=False):
        self.name, self.layer, self.build = name, layer, build
        self.params, self.names, self.args = params, names, args
        self.wants, self.forbids, self.route = wants, forbids, route
        self.agree_lanes, self.weighted = agree_lanes, weighted


PATHS = {
    # the main path and its interior-point twin: OptNet's box-QP
    "admm": Path("admm", "box_qp", box_qp_layer, box_qp_params, "vGh",
                 dict(BOX_QP_ARGS, solve_method="admm"), "K1", None,
                 "dense", 16),
    "ipm": Path("ipm", "box_qp", box_qp_layer, box_qp_params, "vGh",
                dict(BOX_QP_ARGS, solve_method="ipm"), "K2", None, "dense",
                16),
    # the sparsemax-style simplex projection: P and A are constant, so
    # the default call takes the shared-factor route, which has no kernel
    "shared": Path("shared", "simplex",
                   lambda ct, dev: simplex_layer(ct, dev, n=50),
                   simplex_params, "v", SIMPLEX_ARGS, None, "K1", "shared",
                   8, weighted=True),
    # the same instances on the dense per-instance route, for the record
    "shared_off": Path("shared_off", "simplex",
                       lambda ct, dev: simplex_layer(ct, dev, n=50),
                       simplex_params, "v",
                       dict(SIMPLEX_ARGS, shared_setup="off"), "K1", None,
                       "dense", 8),
    # an LP through the interior-point method's default form, the
    # self-dual embedding: K2 once per iteration at (B, 170, 50). The
    # IPM's own target is eps/100 (SolverSettings.ipm_eps_abs): an IPM
    # that stops at eps hands the polish points on the edge of its basin
    # on this LP, and a sixth of the lanes end MAX_ITERS after the
    # polish, in f64 as in f32, in both packages (1.5 % at eps/10). The
    # cap of 40 iterations cuts the f32 tail of lanes that creep toward
    # that target for 50-150 iterations; they keep their best iterate.
    # An LP's f32 KKT solves (polish and adjoint) run CG on the normal
    # equations: 40 steps leave gradients 0.3-2 off the f64 ones on some
    # lanes, in both packages; 200 reach the f64 gradient
    "hsde": Path("hsde", "box_lp", box_lp_layer, box_qp_params, "vGh",
                 ipm_args(LAD_ARGS, ipm_eps_abs=1e-6, ipm_max_iters=40,
                          cg_iters=200),
                 "K2", None, "dense", 8),
}


def route_of(layer, args):
    """The route the layer takes for these solver_args, and for the
    interior-point method the form (the self-dual embedding when P is
    structurally zero under ipm_mode "auto" or "hsde")."""
    from cvxpylayers_tpu_torch.layer.cvxpylayer import _settings_from_args

    st = _settings_from_args(layer._base_settings, args)
    route = "shared" if layer._use_shared(st) else "dense"
    form = None
    if st.solve_method == "ipm":
        form = ("hsde" if layer.prog.P_rows.size == 0
                and st.ipm_mode in ("auto", "hsde") else "pd")
    return route, form


def check_launches(what, launches, wants, forbids):
    if DEV != "cuda":
        return
    if wants and launches[wants] == 0:
        fail(f"{what}: {wants} was never launched")
    if forbids and launches[forbids] != 0:
        fail(f"{what}: {forbids} was launched {launches[forbids]} times "
             "on a route without it")


def main_path_phase(ct, counters, path, calls=4, B=1024):
    """A layer path at full width through solve_with_info. `counters`
    maps each kernel's name to the module that counts its launches;
    every count is set to 0 just before the calls and read just after."""
    r = np.random.default_rng(0)
    layer = path.build(ct, DEV)
    route, form = route_of(layer, path.args)
    if route != path.route:
        fail(f"{path.name}: route {route}, expected {path.route}")
    # fresh inputs for every call, made up front and moved in bulk
    host = [path.params(r, B) for _ in range(calls + 1)]
    inputs = [to_dev(h, torch.float32) for h in host]
    sync()

    for mod in counters.values():
        mod.LAUNCHES = 0
    times = []
    solved = []
    iters_max = []
    first = None
    for i, params in enumerate(inputs):
        t0 = time.perf_counter()
        (x,), status, iters = layer.solve_with_info(
            *params, solver_args=path.args)
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        if i == 0:
            first = (x, status, iters)
        else:  # call 0 is the warm-up (allocator, library load)
            times.append(dt)
        solved.append(float((status == 0).float().mean()))
        iters_max.append(int(iters.max()))
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    check_launches(f"{path.name} path", launches, path.wants, path.forbids)
    if route == "shared" and not layer._shared_solvers:
        fail(f"{path.name}: the shared solver never ran")

    x, status, iters = first
    n = layer.prog.var_info[id(layer._outputs[0][1])].shape[0]
    if tuple(x.shape) != (B, n) or not bool(torch.isfinite(x).all()):
        fail(f"{path.name} path: bad output {tuple(x.shape)}")
    # reference: the port's own f64 CPU run on the first lanes
    k = path.agree_lanes
    cpu_layer = path.build(ct, "cpu")
    (x64,), st64, _ = cpu_layer.solve_with_info(
        *to_dev([h[:k] for h in host[0]], torch.float64, "cpu"),
        solver_args=path.args)
    diff = float((x[:k].double().cpu() - x64).abs().max())
    res = dict(
        path=path.name, layer=path.layer, route=route, ipm_form=form,
        n=n, m=layer.prog.m, B=B,
        dtype="float32", solver_args=path.args, calls=len(inputs),
        solved_fraction_first=solved[0],
        solved_fraction_min=min(solved),
        iters_max_per_call=iters_max,
        iters_mean_first=float(iters.float().mean()),
        launches_before={k_: 0 for k_ in counters},
        launches_after=launches,
        launches_per_call={k_: v / len(inputs)
                           for k_, v in launches.items()},
        median_ms_per_call=statistics.median(times),
        ms_per_call=times,
        solves_per_s=B / statistics.median(times) * 1e3,
        agree_lanes=k,
        max_abs_diff_vs_f64_cpu=diff,
        f64_cpu_solved=float((st64 == 0).double().mean()),
    )
    say("main", json.dumps(res))
    if min(solved) < 0.99:
        fail(f"{path.name} path: solved fraction {min(solved)} < 0.99")
    # f32 at eps 1e-4 against f64: the solution agrees to ~1e-4, and
    # 2e-3 leaves room for the loosest certified lanes
    if diff > 2e-3:
        fail(f"{path.name} path: f32 cuda vs f64 cpu max abs diff "
             f"{diff:.3e}")
    return res, launches[path.wants] if path.wants else 0


def device_profile(layer, params, args):
    """Device time by kernel name for one layer call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        layer.solve_with_info(*params, solver_args=args)
        torch.cuda.synchronize()
    rows = []
    total = 0.0
    count = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # operator rows repeat their kernels' device time
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
            total += dev_us
            count += e.count
    rows.sort(reverse=True)
    return total, count, rows[:8]


def profile_phase(ct, path):
    layer = path.build(ct, DEV)
    params = to_dev(path.params(np.random.default_rng(7), 1024),
                    torch.float32)
    layer.solve_with_info(*params, solver_args=path.args)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total_us, count, top = device_profile(layer, params, path.args)
    wall_ms = (time.perf_counter() - t0) * 1e3
    say(f"profile ({path.name}): one call runs {count} device "
        f"kernels for {total_us / 1e3:.3f} ms of device time "
        f"({wall_ms:.1f} ms on the host clock with the profiler on); "
        "top (us, name, count):")
    for us, key, n_calls in top:
        say(f"  {us:10.1f}  {key[:90]}  x{n_calls}")
    say("profile_record", json.dumps(dict(
        path=path.name, device_kernels=count, device_ms=total_us / 1e3,
        host_ms_profiler_on=wall_ms)))


def gradient_phase(ct, counters, path, calls=3, B=1024):
    """Forward + backward through a layer path: finite gradients of
    sum(x) (of w'x with a seeded w on a weighted path) with respect to
    every parameter, and the first 8 instances'
    gradients against the port's f64 CPU gradients of the same
    instances. At eps 1e-4 the f32 solution sits ~1e-7 from the f64 one
    after the polish and the adjoint solve takes one refinement pass, so
    gradients agree to ~1e-4 of their scale; 1e-2 is the limit. Each
    parameter's error is taken over its own largest f64 gradient, or
    over 1e-3 of the largest of all parameters where that is larger: an
    LP's solution does not move with its cost vector, so that gradient
    is zero up to rounding and has no scale of its own."""
    r = np.random.default_rng(11)
    layer = path.build(ct, DEV)
    host = [path.params(r, B) for _ in range(calls + 1)]
    n = layer.prog.var_info[id(layer._outputs[0][1])].shape[0]
    w = (np.random.default_rng(12).standard_normal((B, n)) if path.weighted
         else np.ones((B, n)))
    w32 = to_dev([w], torch.float32)[0]
    for mod in counters.values():
        mod.LAUNCHES = 0
    times = []
    first = None
    for i, h in enumerate(host):
        params = [t.requires_grad_() for t in to_dev(h, torch.float32)]
        sync()
        t0 = time.perf_counter()
        (x,), status, _ = layer.solve_with_info(*params,
                                                solver_args=path.args)
        (x * w32).sum().backward()
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        if i == 0:
            first = (params, status)
        else:
            times.append(dt)
        for p in params:
            if p.grad is None or tuple(p.grad.shape) != tuple(p.shape):
                fail(f"gradient ({path.name}): a parameter got no "
                     "gradient")
            if not bool(torch.isfinite(p.grad).all()):
                fail(f"gradient ({path.name}): non-finite gradient")
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    check_launches(f"gradient ({path.name})", launches, path.wants,
                   path.forbids)

    k = 8
    params, status = first
    cpu_layer = path.build(ct, "cpu")
    ref = [t.requires_grad_() for t in
           to_dev([a[:k] for a in host[0]], torch.float64, "cpu")]
    (x64,), st64, _ = cpu_layer.solve_with_info(*ref, solver_args=path.args)
    (x64 * to_dev([w[:k]], torch.float64, "cpu")[0]).sum().backward()
    both = (status[:k].cpu() == 0) & (st64 == 0)
    if not bool(both.any()):
        fail(f"gradient ({path.name}): no lane solved on both devices")
    overall = max(float(q.grad[both].abs().max()) for q in ref)
    rel = []
    for p, q in zip(params, ref):
        g = p.grad[:k].double().cpu()[both]
        g64 = q.grad[both]
        rel.append(float((g - g64).abs().max()
                         / max(float(g64.abs().max()), 1e-3 * overall)))
    res = dict(path=path.name, layer=path.layer, B=B, dtype="float32",
               loss="w'x, w seeded" if path.weighted else "sum(x)",
               calls=len(host), fwd_bwd_median_ms=statistics.median(times),
               fwd_bwd_ms=times, launches=launches,
               solved_fraction_first=float((status == 0).float().mean()),
               lanes_compared=int(both.sum()),
               grad_rel_err_vs_f64_cpu_first8=dict(zip(path.names, rel)),
               grad_abs_max=[float(p.grad.abs().max()) for p in params],
               grad_abs_max_f64_first8=[float(q.grad.abs().max())
                                        for q in ref])
    say("grad", json.dumps(res))
    if max(rel) > 1e-2:
        fail(f"gradient ({path.name}): relative error {max(rel):.3e} "
             "against the f64 CPU gradient > 1e-2")
    return res


def small_layers_phase(ct, counters):
    r = np.random.default_rng(1)
    B = 256
    out = {}
    simplex_v = [r.standard_normal((B, 20))]
    lad_ab = [r.standard_normal((B, 3, 2)), r.standard_normal((B, 3))]
    # (name, layer, parameters, solver_args, kernel wanted, kernel
    # forbidden, route)
    for name, build, params, args, wants, forbids, want_route in (
        # P and A constant: the default call takes the shared route
        ("simplex", simplex_layer, simplex_v, SIMPLEX_ARGS, None, "K1",
         "shared"),
        # the dense route keeps K1's packed four-to-a-block tile on a
        # layer path
        ("simplex_dense", simplex_layer, simplex_v,
         dict(SIMPLEX_ARGS, shared_setup="off"), "K1", None, "dense"),
        ("lad", lad_layer, lad_ab, LAD_ARGS, "K1", None, "dense"),
        ("simplex_ipm", simplex_layer, simplex_v, ipm_args(SIMPLEX_ARGS),
         "K2", None, "dense"),
        # an LP: the default form is the self-dual embedding
        ("lad_ipm", lad_layer, lad_ab, ipm_args(LAD_ARGS), "K2", None,
         "dense"),
        ("lad_ipm_pd", lad_layer, lad_ab, ipm_args(LAD_ARGS, ipm_mode="pd"),
         "K2", None, "dense"),
    ):
        layer = build(ct, DEV)
        route, form = route_of(layer, args)
        if route != want_route:
            fail(f"{name}: route {route}, expected {want_route}")
        dev = to_dev(params, torch.float32)
        for mod in counters.values():
            mod.LAUNCHES = 0
        (x,), status, iters = layer.solve_with_info(*dev, solver_args=args)
        sync()
        launches = {k: mod.LAUNCHES for k, mod in counters.items()}
        solved = float((status == 0).float().mean())
        check_launches(name, launches, wants, forbids)
        if not bool(torch.isfinite(x).all()):
            fail(f"{name}: non-finite output")
        k = 8
        cpu = build(ct, "cpu")
        (x64,), st64, _ = cpu.solve_with_info(
            *to_dev([p[:k] for p in params], torch.float64, "cpu"),
            solver_args=args)
        both = ((status[:k].cpu() == 0) & (st64 == 0))
        diff = float((x[:k].double().cpu() - x64).abs().max(dim=1)
                     .values[both].max()) if bool(both.any()) else None
        rec = dict(layer=name, B=B, dtype="float32", route=route,
                   ipm_form=form, solved_fraction=solved,
                   iters_max=int(iters.max()), launches=launches,
                   max_abs_diff_vs_f64_cpu_solved_lanes=diff)
        say("small", json.dumps(rec))
        if diff is not None and diff > 2e-3:
            fail(f"{name}: f32 cuda vs f64 cpu max abs diff {diff:.3e}")
        out[name] = rec
    return out


def kernel_record(name, source, replaces, launches, main, shapes):
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=main["max_abs_err"], tol=main["tol"],
        ms=main["ms"], kernel_ms=main["ms"],
        ms_method=main.get("ms_method", MS_EVENTS),
        ms_plain_launch=main.get("ms_plain_launch", main["ms"]),
        plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main.get("library_ms"),
        shape=" ".join(f"{k}={main[k]}" for k in
                       ("B", "n", "m", "iters", "dtype") if k in main),
        shapes_within_tol=len(shapes),
    )


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "cvxpylayers_tpu_torch")):
        fail("cvxpylayers_tpu_torch/ is not beside chip_smoke.py: run it "
             "from the root of a checkout")
    sys.path.insert(0, root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say(f"card: {smi}")
    say(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")

    import cvxpylayers_tpu_torch as ct
    from cvxpylayers_tpu_torch import cuda_build
    from cvxpylayers_tpu_torch.solver import cuda_admm, cuda_linalg

    if any(m == "jax" or m.startswith("jax.") or m == "cvxpylayers_tpu"
           or m.startswith("cvxpylayers_tpu.") for m in sys.modules):
        fail("the port imported JAX or the JAX package")

    # ---- 1. build
    t0 = time.perf_counter()
    cuda_build.build_all()
    say(f"build: {len(cuda_build.KERNEL_SOURCES)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, log in cuda_build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions
    k1, k1_shapes = kernel_phase(cuda_admm)
    k2, k2_shapes = qr_kernel_phase(cuda_linalg)

    # ---- 3. the paths at full width, each with its counts from 0
    counters = {"K1": cuda_admm, "K2": cuda_linalg}
    _, k1_launches = main_path_phase(ct, counters, PATHS["admm"])
    _, k2_launches = main_path_phase(ct, counters, PATHS["ipm"])
    for name in ("shared", "shared_off", "hsde"):
        main_path_phase(ct, counters, PATHS[name])
    for name in ("admm", "ipm", "shared", "hsde"):
        profile_phase(ct, PATHS[name])

    # ---- 4. gradients through the layer
    for name in ("admm", "ipm", "shared", "hsde"):
        gradient_phase(ct, counters, PATHS[name])

    # ---- 5. small layers
    small_layers_phase(ct, counters)

    kernels = [
        kernel_record(
            "admm_polyhedral_epoch",
            "cvxpylayers_tpu_torch/csrc/admm_epoch.cu",
            "cvxpylayers_tpu/solver/pallas_admm.py:85",
            k1_launches, k1, k1_shapes),
        kernel_record(
            "house_qr_r",
            "cvxpylayers_tpu_torch/csrc/house_qr.cu",
            "cvxpylayers_tpu/solver/pallas_linalg.py:98",
            k2_launches, k2, k2_shapes),
    ]
    say(f"card: {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
