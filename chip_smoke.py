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
             through CvxpyLayer(...).solve_with_info(*params), or
             solve_with_rescue on a rescue path, its kernel launches
             counted from 0 just before it and read just after: the
             OptNet box-QP projection layer (n=50, G 20x50) with
             solve_method="admm" (kernel K1) and "ipm" (kernel K2); the
             simplex projection at n=50 on the shared constant-P/A route
             (no kernel: K1 must stay at 0) and, for the record, on the
             dense route; a box-constrained LP through the self-dual
             embedding (K2 once per iteration); the rescue and Anderson
             paths; and the general cones, where K1 and K2 must stay at
             0: bench.py's Markowitz SOCP fast route (B=512, dense
             route), its entropy softmax with the equality dual behind
             the two-stage rescue ladder (B=512, shared route) and its
             16x16 spectahedron SDP (B=256, shared route, Newton-Schulz
             PSD in the inner loop); and the interior-point method's cone
             blocks: bench.py's Markowitz SOCP in full (the fast route,
             then its self-dual-embedding IPM rescue of capacity 64, K2
             on the rescued sub-batch), the same instances with every
             lane through that IPM (K2 once per iteration at
             (512, 113, 51)), the 32x32 spectahedron by the IPM (B=128,
             one PSD block of svec 528: the Cholesky route, no kernel)
             and the Markowitz SOCP at n=500 (B=128, the structural
             block apply, a primal-dual IPM rescue of capacity 16, no
             kernel). Solved fraction, route, iterations,
             exact-eigh calls, ms per call with fresh inputs, agreement of
             the first lanes' outputs with the port's own f64 CPU run; a
             device profile of one call of each profiled path
  4. grad    the profiled paths with requires_grad on the parameters and
             a backward pass: finite gradients, agreement of 8 instances
             with the port's f64 CPU gradients, ms per forward+backward
  5. small   the simplex-projection and LAD layers at B=256 by every
             route: shared and dense ADMM, the IPM's primal-dual form and
             its self-dual embedding; a power-cone projection layer, an
             SOC layer whose polish takes the PCG and the spectral KKT
             modes, the softmax (32 exp triples) and the power-cone
             layer through the IPM's primal-dual form, and the softmax
             ladder behind a fast route that fails on purpose, so both
             of its stages run on the card; and the same outputs with
             TF32 matmuls allowed globally as without (the package pins
             its own products)
  6. sparse  bench.py's 64x64 transport LP (n=4096, 128 equality and
             4096 nonneg rows, nnz(A)=12288, B=8) on the sparse route by
             PDHG and by the matrix-free ADMM (K1 and K2 must stay at
             0): solved fraction 1.0, every lane's objective within 1e-3
             of HiGHS's, two PDHG calls on the same inputs bit for bit
             equal, forward+backward, a device profile; the flagship
             box-QP at B=1024 with derivative="forward" (K1 once a call,
             the dot-product identity against the adjoint, 8 lanes'
             JVPs against the f64 CPU JVP); at B=256 dense PDHG on the
             box-LP, the "auto" assembly taking the sparse route, and
             forward-mode JVPs by the IPM (K2) and on the sparse route
  7. gp      bench.py's GP row through gp=True at full width (B=1024,
             f32, bench.py's settings; K1 and K2 must stay at 0): solved
             fraction, ms per call, 8 lanes against the f64 CPU run, a
             device profile, forward+backward against the f64 CPU
             gradients; cone duals at B=256 in their shapes (the SOC
             parts of the Markowitz risk budget, the 16x16 PSD dual of
             the spectahedron, the exp-cone parts of the softmax), each
             with the gradient through one part, against f64 CPU;
             Problem.solve with the default device (an LP against
             linprog, a cached re-solve, the GP, an infeasible and an
             unbounded problem); a layer of structured atoms
             (sum_largest, norm_nuc, lambda_sum_largest) at B=256
  8. serve   the model zoo served by dist.BucketScheduler: three steps of
             a mixed stream (two box_qp(50, 20) layers in one bucket at
             1024, 1024 and 896 rows, capacity 1024; sparsemax,
             csparsemax and relu at B=256 and an unbatched sparsemax
             instance, f32, the box-QP's settings), K1 on every bucket's
             flush and K2 never, each item against a direct call of its
             layer, 8 lanes of each against the port's f64 bucketed
             solve on the CPU, the warm start carried over (and dropped
             when the composition changes), the box-QP bucket's stats,
             the gradient through the scheduler against direct calls; a
             profiled step inside a trace_annotation, PhaseTimer phases,
             problem_summary of every zoo layer; on one card the
             distributed runtime (a world of one rank on NCCL, the
             global mesh, a global batch round trip, the sharded box-QP
             call at B=1024 against the direct call, solve_bucketed over
             the mesh); and the scaling harness in its own process

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
# bench.py's lad_b4096 rescue stage: deeper ADMM, a tighter internal
# target and a longer polish
LAD_RESCUE_ARGS = dict(
    LAD_ARGS, max_iters=2000, epoch=200, admm_eps_abs=1e-5,
    admm_eps_rel=1e-5, refine_steps=8,
)
# bench.py's box_qp_ipm rescue stage, ADMM, with the adjoint's Schur-CG
# steps at their default (20 at n=50) instead of the row's 5: on the f32
# borderline lane that the stage rescues, 5 steps leave the f32 gradient
# 6-13 % off the f64 one, in the reference as in the port
# (tests/test_torch_port_rescue.py), and 20 reach it
IPM_RESCUE_ARGS = {k: v for k, v in BOX_QP_ARGS.items()
                   if k != "schur_iters"}
IPM_RESCUE_ARGS["solve_method"] = "admm"
# a fast route that fails on purpose (the reference tests' BAD idea): one
# epoch and no polish, so most lanes end MAX_ITERS
LAD_FORCED_ARGS = dict(LAD_ARGS, max_iters=100, refine_steps=0)


# bench.py's _tuned_args: ADMM to ~1e-3, then the Newton polish to eps
TUNED_ARGS = {
    "eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-3,
    "admm_eps_rel": 1e-3, "max_iters": 50, "epoch": 50, "refine_steps": 4,
}
# bench.py's markowitz_socp fast route. The f32 KKT solves there
# (n + m = 114, the dense-normal window) run CG on the normal equations:
# at the default 40 steps the f32 gradients sit 10-40 % off the f64 ones
# on solved lanes, in the reference as in the port; 100 steps reach them
# within 1e-5
MARKOWITZ_ARGS = dict(TUNED_ARGS, max_iters=300, epoch=100, refine_steps=10,
                      cg_iters=100)
# its rescue stage: the IPM (the self-dual embedding: P = 0 and only
# symmetric cones) to eps/10, then the spectral polish; capacity 64
MARKOWITZ_IPM_ARGS = dict(TUNED_ARGS, solve_method="ipm",
                          kkt_mode="spectral", refine_steps=15, ipm_eps=1e-5,
                          matmul_precision="highest")
MARKOWITZ_CAPACITY = 64
# bench.py's sdp_trace_32 row: the 32x32 spectahedron by the IPM
SDP32_ARGS = dict(TUNED_ARGS, assembly="dense", solve_method="ipm",
                  kkt_mode="spectral", refine_steps=10, ipm_eps=1e-5,
                  matmul_precision="highest")
# bench.py's markowitz_large_n500 row and its primal-dual IPM rescue of
# capacity 16, both at eps 1e-3
N500_ARGS = dict(TUNED_ARGS, assembly="dense", solve_method="ipm",
                 kkt_mode="spectral", refine_steps=6, ipm_eps=1e-6,
                 matmul_precision="highest", eps_abs=1e-3, eps_rel=1e-3)
N500_RESCUE = dict(N500_ARGS, ipm_mode="pd", refine_steps=20, ipm_eps=3e-7)
N500_CAPACITY = 16
# bench.py's softmax_duals row and its rescue ladder: deep polish, then
# the stale-factor PCG mode, capacity 24, warm
SM_ARGS = dict(TUNED_ARGS, max_iters=500, epoch=100, admm_eps_abs=3e-4,
               admm_eps_rel=3e-4, refine_steps=20)
SM_RESCUE = dict(TUNED_ARGS, max_iters=700, epoch=100, refine_steps=30,
                 matmul_precision="highest")
SM_LADDER = [SM_RESCUE, dict(SM_RESCUE, kkt_mode="pcg")]
SM_CAPACITY = 24
# a softmax fast route that fails on purpose: one epoch, no polish
SM_FORCED_ARGS = dict(SM_ARGS, max_iters=100, refine_steps=0)
# bench.py's sdp_trace row: Newton-Schulz PSD in the f32 inner loop,
# exact eigh for statuses and the polish
SDP_ARGS = dict(TUNED_ARGS, max_iters=1000, epoch=100, refine_steps=5)
# bench.py's row 8, ot_common: a 64x64 transport LP on the sparse
# (matrix-free) route at eps 1e-3; PDHG with its deeper internal target
# and 60000-iteration cap, and the matrix-free ADMM
OT_ARGS = {"assembly": "sparse", "eps_abs": 1e-3, "eps_rel": 1e-3,
           "admm_eps_abs": 1e-3, "admm_eps_rel": 1e-3, "max_iters": 20000,
           "epoch": 500, "refine_steps": 10}
OT_PDHG_ARGS = dict(OT_ARGS, solve_method="pdhg", max_iters=60000,
                    admm_eps_abs=1e-4, admm_eps_rel=1e-4)
# a solved lane's objective against HiGHS's: within 1e-3 of the larger
# of 1 and its size, the scale of the solver's own gap certificate at
# eps 1e-3 (eps_abs + eps_rel |obj|). The plain relative error is
# recorded: the optimal costs here are 0.03-0.25, and on these instances
# the reference's own f32 solve (JAX on the CPU) is up to 9.1e-3 off in
# relative terms on solved lanes (bench.py's 7e-4 is on its instances)
OT_OBJ_TOL = 1e-3


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
        # the Markowitz IPM's stacked factor [Lp'; B A_in]: 51 rows of
        # Lp', 62 scaled inequality rows with a dense SOC block
        ("markowitz IPM f32", 512, 113, 51, torch.float32, False),
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


def markowitz_layer(ct, device, n=50, k=10):
    """bench.py's Markowitz SOCP: maximize mu'w under a risk budget
    ||F w|| <= 0.25 on the simplex; F is a parameter, so the route is the
    dense per-instance one."""
    w = ct.Variable(n, nonneg=True)
    mu = ct.Parameter(n)
    F = ct.Parameter((k, n))
    prob = ct.Problem(ct.Maximize(mu @ w),
                      [ct.norm(F @ w, 2) <= 0.25, ct.sum(w) == 1])
    return ct.CvxpyLayer(prob, parameters=[mu, F], variables=[w],
                         device=device)


def markowitz_params(r, B, n=50, k=10):
    return [r.standard_normal((B, n)) * 0.1,
            r.standard_normal((B, k, n)) / np.sqrt(n)]


def softmax_layer(ct, device, n=32):
    """bench.py's entropy-regularized softmax with its equality dual as a
    second output: exponential cones, A constant (the shared route)."""
    y = ct.Variable(n, nonneg=True)
    c = ct.Parameter(n)
    con = ct.sum(y) == 1
    prob = ct.Problem(ct.Maximize(c @ y + ct.sum(ct.entr(y))), [con])
    return ct.CvxpyLayer(prob, parameters=[c],
                         variables=[y, con.dual_variables[0]], device=device)


def softmax_params(r, B, n=32):
    return [r.standard_normal((B, n))]


def sdp_layer(ct, device, s=16):
    """bench.py's spectahedron SDP: min tr(C X) over X PSD with tr X = 1;
    the solution is the projector onto C's least eigenvector."""
    X = ct.Variable((s, s), PSD=True)
    C = ct.Parameter((s, s))
    prob = ct.Problem(ct.Minimize(ct.trace(C @ X)), [ct.trace(X) == 1])
    return ct.CvxpyLayer(prob, parameters=[C], variables=[X], device=device)


def sdp_params(r, B, s=16):
    C = r.standard_normal((B, s, s))
    return [0.5 * (C + C.transpose(0, 2, 1))]


def pow3_layer(ct, device, alpha=0.4):
    """The projection onto a 3-D power cone, as a layer: its solution is
    project_pow3(v)."""
    x = ct.Variable(3)
    v = ct.Parameter(3)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x - v)),
                      [ct.PowCone3D(x[0], x[1], x[2], alpha)])
    return ct.CvxpyLayer(prob, parameters=[v], variables=[x], device=device)


def ot_layer(ct, device, n_s=64, n_d=64):
    """bench.py's optimal-transport LP: the plan P >= 0 between uniform
    marginals under a cost C, min <C, P>. n = n_s n_d variables, n_s + n_d
    equality rows, n nonneg rows, nnz(A) = 3n."""
    C = ct.Parameter((n_s, n_d))
    P = ct.Variable((n_s, n_d), nonneg=True)
    prob = ct.Problem(
        ct.Minimize(ct.sum(ct.multiply(C, P))),
        [P @ ct.Constant(np.ones(n_d)) == ct.Constant(np.full(n_s, 1 / n_s)),
         P.T @ ct.Constant(np.ones(n_s))
         == ct.Constant(np.full(n_d, 1 / n_d))])
    return ct.CvxpyLayer(prob, parameters=[C], variables=[P], device=device)


def ot_params(r, B, n_s=64, n_d=64):
    """Squared distances between seeded points on a line, as bench.py."""
    xs = r.standard_normal((B, n_s))
    ys = r.standard_normal((B, n_d))
    return [(xs[:, :, None] - ys[:, None, :]) ** 2]


def ot_linprog(C):
    """HiGHS's optimal objective of each lane's transport LP (C (B, s, d))."""
    from scipy.optimize import linprog

    _, n_s, n_d = C.shape
    A_eq = np.vstack([np.kron(np.eye(n_s), np.ones(n_d)),
                      np.kron(np.ones(n_s), np.eye(n_d))])
    b_eq = np.r_[np.full(n_s, 1 / n_s), np.full(n_d, 1 / n_d)]
    out = []
    for c in C:
        res = linprog(c.ravel(), A_eq=A_eq, b_eq=b_eq, bounds=(0, None),
                      method="highs")
        if res.status != 0:
            fail(f"linprog: {res.message}")
        out.append(res.fun)
    return np.array(out)


def to_dev(arrs, dtype, device=None):
    return [torch.as_tensor(a, dtype=dtype, device=device or DEV)
            for a in arrs]


def sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


# solve_with_rescue's capacity on every rescue path, as bench.py's rows;
# every rescue stage is ADMM and launches K1
RESCUE_CAPACITY = 16


class Path:
    """A layer path at full width: its layer, its parameters (and their
    names), its solver_args, the kernel it must launch (`wants`), the
    kernels it must not launch (`forbids`: a name or a tuple of names),
    the route it must take ("dense" or "shared"), the lanes held against
    the port's own f64 CPU run, and whether the gradient phase weighs the
    outputs by seeded arrays (sum(x) is constant on the simplex, so its
    gradient is zero). A path with `rescue` (a stage's solver_args, or a
    ladder of them) runs through solve_with_rescue with `capacity` and
    `warm` (warm_start_rescue); each stage must launch `stage_wants`;
    `forced` says its fast route fails on purpose, so a stage must run on
    every call. `min_solved` is the solved fraction a path must reach
    (None: a record). `agree_solved_only` holds only the lanes solved on
    both devices against the f64 run, and lets a lane that did not solve
    carry a non-finite x (the Anderson route's f32 Gram inverse can
    overflow there, in the reference too); solved lanes must be finite on
    every path. `calls` is the number of timed calls after the warm-up.
    `k2_per_iteration`: every K2 launch of the path must be at the shape
    of its stacked factor [Lp'; B A_in], one per IPM iteration.
    `grad_floor`: the gradient phase takes each parameter's error over
    its own largest f64 gradient or over this fraction of the largest of
    all parameters, whichever is larger. `grad_calls`: the gradient
    phase's timed calls (default: one fewer than `calls`, at least 2)."""

    def __init__(self, name, layer, build, params, names, args, wants,
                 forbids, route, agree_lanes, weighted=False, B=1024,
                 rescue=None, forced=False, min_solved=0.99,
                 agree_solved_only=False, capacity=RESCUE_CAPACITY,
                 warm=False, stage_wants="K1", calls=4,
                 k2_per_iteration=False, grad_floor=1e-3, grad_calls=None):
        self.name, self.layer, self.build = name, layer, build
        self.params, self.names, self.args = params, names, args
        self.wants, self.route = wants, route
        self.forbids = ((forbids,) if isinstance(forbids, str)
                        else tuple(forbids or ()))
        self.agree_lanes, self.weighted = agree_lanes, weighted
        self.B, self.rescue, self.forced = B, rescue, forced
        self.min_solved = min_solved
        self.agree_solved_only = agree_solved_only
        self.capacity, self.warm = capacity, warm
        self.stage_wants, self.calls = stage_wants, calls
        self.k2_per_iteration = k2_per_iteration
        self.grad_floor = grad_floor
        self.grad_calls = (max(calls - 1, 2) if grad_calls is None
                           else grad_calls)

    @property
    def ladder(self):
        """The rescue stages' solver_args, as a list."""
        if self.rescue is None:
            return []
        return (list(self.rescue) if isinstance(self.rescue, (list, tuple))
                else [self.rescue])

    def solve(self, ct, layer, params):
        """(outs, status, iters) of one call of the path."""
        if self.rescue is None:
            return layer.solve_with_info(*params, solver_args=self.args)
        return ct.solve_with_rescue(
            layer, *params, solver_args=self.args,
            rescue_args=self.rescue, capacity=self.capacity,
            warm_start_rescue=self.warm)


def lad_params(r, B):
    return [r.standard_normal((B, 3, 2)), r.standard_normal((B, 3))]


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
    # bench.py's lad_b4096 row: the LAD fit at B=4096 with a deeper-ADMM
    # rescue of capacity 16 (K1 on the fast stage and on the sub-batch)
    "lad_rescue": Path("lad_rescue", "lad", lad_layer, lad_params, "Ab",
                       LAD_ARGS, "K1", None, "dense", 16, B=4096,
                       rescue=LAD_RESCUE_ARGS, agree_solved_only=True),
    # the same instances behind a fast route that fails on purpose, so
    # the rescue stage runs on the card on every call: exactly
    # min(failures, 16) lanes change, every other lane keeps the fast
    # route's output and status bit for bit
    "lad_rescue_forced": Path("lad_rescue_forced", "lad", lad_layer,
                              lad_params, "Ab", LAD_FORCED_ARGS, "K1", None,
                              "dense", 16, B=4096,
                              rescue=LAD_RESCUE_ARGS, forced=True,
                              min_solved=None, agree_solved_only=True),
    # bench.py's box_qp_ipm row: the IPM behind an ADMM rescue of
    # capacity 16, on the ipm path's instances; K2 on the fast stage, K1
    # whenever a lane failed (the f32 borderline lane of the IPM)
    "ipm_rescue": Path("ipm_rescue", "box_qp", box_qp_layer, box_qp_params,
                       "vGh", dict(BOX_QP_ARGS, solve_method="ipm"), "K2",
                       None, "dense", 16, rescue=IPM_RESCUE_ARGS,
                       agree_solved_only=True),
    # Anderson acceleration of the ADMM epoch on the LAD fit: the
    # accelerated epoch is torch ops (the reference's Pallas kernel, like
    # K1, computes only the plain scan), so K1 must stay at 0
    "admm_aa": Path("admm_aa", "lad", lad_layer, lad_params, "Ab",
                    dict(LAD_ARGS, accel_lookback=3), None, "K1", "dense", 16,
                    min_solved=None, agree_solved_only=True),
    # the same instances without acceleration, for the record
    "admm_aa_off": Path("admm_aa_off", "lad", lad_layer, lad_params, "Ab",
                        LAD_ARGS, "K1", None, "dense", 16,
                        agree_solved_only=True),
    # the general cones (no kernel: the plain ADMM scan, K1 and K2 must
    # stay at 0). bench.py's markowitz_socp fast route without its IPM
    # rescue: a few percent of lanes are doubly degenerate there, so 0.90
    "markowitz_admm": Path("markowitz_admm", "markowitz", markowitz_layer,
                           markowitz_params, ["mu", "F"], MARKOWITZ_ARGS,
                           None, ("K1", "K2"), "dense", 16, weighted=True,
                           B=512, min_solved=0.90, agree_solved_only=True,
                           calls=2),
    # bench.py's softmax_duals row with its two-stage ladder (deep polish,
    # then PCG), capacity 24, warm; one timed call and one timed gradient
    # (depth: its calls take 15-35 s)
    "softmax_rescue": Path("softmax_rescue", "softmax", softmax_layer,
                           softmax_params, ["c"], SM_ARGS, None,
                           ("K1", "K2"), "shared", 16, weighted=True, B=512,
                           rescue=SM_LADDER, capacity=SM_CAPACITY, warm=True,
                           stage_wants=None, agree_solved_only=True,
                           calls=1, grad_calls=1),
    # bench.py's sdp_trace row: Newton-Schulz PSD in the f32 inner loop
    "sdp_trace": Path("sdp_trace", "sdp", sdp_layer, sdp_params, ["C"],
                      SDP_ARGS, None, ("K1", "K2"), "shared", 16,
                      weighted=True, B=256, agree_solved_only=True, calls=1,
                      grad_calls=1),
    # the interior-point method's cone blocks. bench.py's markowitz_socp
    # in full: the fast route, then the IPM rescue of the failed lanes on
    # a sub-batch of 64, whose condensed f32 KKT goes through K2
    "markowitz_rescue": Path("markowitz_rescue", "markowitz",
                             markowitz_layer, markowitz_params, ["mu", "F"],
                             MARKOWITZ_ARGS, None, "K1", "dense", 16,
                             weighted=True, B=512, rescue=MARKOWITZ_IPM_ARGS,
                             capacity=MARKOWITZ_CAPACITY, stage_wants="K2",
                             agree_solved_only=True, calls=2),
    # the same instances with every lane through that IPM: K2 once per
    # iteration at (512, 113, 51)
    "markowitz_ipm": Path("markowitz_ipm", "markowitz", markowitz_layer,
                          markowitz_params, ["mu", "F"], MARKOWITZ_IPM_ARGS,
                          "K2", "K1", "dense", 16, weighted=True, B=512,
                          agree_solved_only=True, calls=2,
                          k2_per_iteration=True),
    # bench.py's sdp_trace_32: one PSD block of svec 528, n = 528 > 160,
    # so the condensed KKT takes the Jacobi-scaled Cholesky, no kernel
    "sdp_ipm_32": Path("sdp_ipm_32", "sdp32",
                       lambda ct, dev: sdp_layer(ct, dev, s=32),
                       lambda r, B: sdp_params(r, B, s=32), ["C"],
                       SDP32_ARGS, None, ("K1", "K2"), "dense", 4,
                       weighted=True, B=128, min_solved=None,
                       agree_solved_only=True, calls=1),
    # bench.py's markowitz_large_n500: 532 inequality rows in two blocks,
    # so the scaling is applied block by block; its primal-dual rescue.
    # The optimum sits at a degenerate vertex where w does not move with
    # mu: the f64 gradient in mu is 0 (~1e-15), and the f32 adjoint there
    # returns noise of ~1e-3 of the largest gradient (F's), in the
    # reference too (1.24e-3 on the first 8 lanes, CPU, against 0.96 for
    # F). So each parameter's error is taken over the largest gradient
    "markowitz_n500": Path("markowitz_n500", "markowitz500",
                           lambda ct, dev: markowitz_layer(ct, dev, n=500,
                                                           k=30),
                           lambda r, B: markowitz_params(r, B, n=500, k=30),
                           ["mu", "F"], N500_ARGS, None, ("K1", "K2"),
                           "dense", 4, weighted=True, B=128,
                           rescue=N500_RESCUE, capacity=N500_CAPACITY,
                           stage_wants=None, min_solved=None,
                           agree_solved_only=True, calls=1,
                           grad_floor=1.0),
}


# the paths with a device profile and a gradient check (shared_off and
# admm_aa_off are records of the same instances on another setting)
PROFILED = ("admm", "ipm", "shared", "hsde", "lad_rescue",
            "lad_rescue_forced", "ipm_rescue", "admm_aa", "markowitz_admm",
            "softmax_rescue", "sdp_trace", "markowitz_rescue",
            "markowitz_ipm", "sdp_ipm_32", "markowitz_n500")
# the paths of the rescue and Anderson slice
RESCUE_PATHS = ("lad_rescue", "lad_rescue_forced", "ipm_rescue", "admm_aa")
# the paths of the general-cone slice
CONE_PATHS = ("markowitz_admm", "softmax_rescue", "sdp_trace")
# the paths of the IPM cone-block slice
IPM_CONE_PATHS = ("markowitz_rescue", "markowitz_ipm", "sdp_ipm_32",
                  "markowitz_n500")


def route_of(layer, args):
    """The route the layer takes for these solver_args, and for the
    interior-point method the form (the self-dual embedding when P is
    structurally zero under ipm_mode "hsde", or under "auto" when every
    cone is symmetric)."""
    from cvxpylayers_tpu_torch.layer.cvxpylayer import _settings_from_args

    st = _settings_from_args(layer._base_settings, args)
    route = "shared" if layer._use_shared(st) else layer._route(st)
    form = None
    if st.solve_method == "ipm":
        dims = layer.prog.dims
        symmetric = dims.exp == 0 and not dims.pow3
        hsde = layer.prog.P_rows.size == 0 and (
            st.ipm_mode == "hsde" or (st.ipm_mode == "auto" and symmetric))
        form = "hsde" if hsde else "pd"
    return route, form


def check_launches(what, launches, wants, forbids):
    if DEV != "cuda":
        return
    if wants and launches[wants] == 0:
        fail(f"{what}: {wants} was never launched")
    for k in ((forbids,) if isinstance(forbids, str) else forbids or ()):
        if launches[k] != 0:
            fail(f"{what}: {k} was launched {launches[k]} times on a route "
                 "without it")


class EighCount:
    """Counts the calls of torch.linalg.eigh and eigvalsh (the exact PSD
    projection and Jacobian factor, the IPM's PSD scalings, step lengths
    and membership tests, its exp/pow Hessian factors; each reads the
    device once to check convergence) while it is entered."""

    _NAMES = ("eigh", "eigvalsh")

    def __enter__(self):
        self.n = 0
        self._orig = {k: getattr(torch.linalg, k) for k in self._NAMES}

        def counted(fn):
            def call(*a, **k):
                self.n += 1
                return fn(*a, **k)
            return call

        for k, fn in self._orig.items():
            setattr(torch.linalg, k, counted(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self._orig.items():
            setattr(torch.linalg, k, fn)


class QrShapes:
    """Records the shape of every matrix the IPM hands to K2's wrapper
    (cvxpylayers_tpu_torch.solver.ipm.qr_r) while it is entered; it calls
    the wrapper itself, so the launch counts are unchanged."""

    def __enter__(self):
        from cvxpylayers_tpu_torch.solver import ipm

        self.shapes = []
        self._ipm, self._qr = ipm, ipm.qr_r

        def logged(M):
            self.shapes.append(tuple(M.shape))
            return self._qr(M)

        ipm.qr_r = logged
        return self

    def __exit__(self, *exc):
        self._ipm.qr_r = self._qr


def flat_outputs(outs):
    """The outputs of a call as one (B, k) tensor."""
    return torch.cat([o.reshape(o.shape[0], -1) for o in outs], dim=1)


class StageLog:
    """Records each solve a rescue path makes through its layer: the fast
    stage comes through solve_and_state and each rescue stage that runs
    through solve_with_info (solve_with_rescue calls nothing else). A
    record holds the solve's batch, every kernel's launches during it,
    its statuses, iterations and outputs. It reads the launch counts and
    changes none."""

    def __init__(self, layer, counters):
        self.records = []
        for name in ("solve_and_state", "solve_with_info"):
            setattr(layer, name,
                    self._wrap(getattr(layer, name), name, counters))

    def _wrap(self, fn, name, counters):
        def logged(*args, **kw):
            before = {k: mod.LAUNCHES for k, mod in counters.items()}
            out = fn(*args, **kw)
            self.records.append(dict(
                stage="fast" if name == "solve_and_state" else "rescue",
                B=int(out[-2].shape[0]), outs=out[0], status=out[-2],
                iters=out[-1],
                launches={k: mod.LAUNCHES - before[k]
                          for k, mod in counters.items()}))
            return out
        return logged

    def take(self):
        records, self.records = self.records, []
        return records


def check_rescue(path, records, outs, status, iters):
    """One call of a rescue path against its stage records: stage k of the
    ladder runs iff a lane was still unsolved after stage k-1 (so a call
    that ends with a failed lane ran every stage), each on a
    capacity-sized sub-batch, launching the stage's kernel; the fast stage
    launches the path's kernel; the lanes whose iterations grew are
    failed lanes, at least min(failures, capacity) and at most
    min(failures, capacity x stages) of them (exactly the first for one
    stage); every other lane keeps the fast route's outputs and status
    bit for bit. Returns the call's record and the rescued lanes."""
    fast, stages = records[0], records[1:]
    B = fast["B"]
    cap = min(path.capacity, B)
    failed = fast["status"] != 0
    n_failed = int(failed.sum())
    rescued = iters != fast["iters"]
    n_rescued = int(rescued.sum())
    n_ladder = len(path.ladder)
    left = bool((status != 0).any())
    what = f"{path.name} rescue"
    ran_ok = (len(stages) == 0 if not n_failed
              else 1 <= len(stages) <= n_ladder
              and (len(stages) == n_ladder or not left))
    if fast["stage"] != "fast" or not ran_ok or any(
            r["stage"] != "rescue" for r in stages):
        fail(f"{what}: stages {[r['stage'] for r in records]} with "
             f"{n_failed} failed lanes, {int((status != 0).sum())} left, "
             f"a ladder of {n_ladder}")
    if path.forced and not n_failed:
        fail(f"{what}: the forced fast route solved every lane")
    on_card = DEV == "cuda"
    if on_card and path.wants and fast["launches"][path.wants] == 0:
        fail(f"{what}: the fast stage did not launch {path.wants}")
    for r in stages:
        if r["B"] != cap:
            fail(f"{what}: a stage solved {r['B']} lanes, capacity {cap}")
        if on_card and path.stage_wants and \
                r["launches"][path.stage_wants] == 0:
            fail(f"{what}: the stage on the sub-batch did not launch "
                 f"{path.stage_wants}")
    most = min(n_failed, cap * max(len(stages), 1))
    if (n_rescued < min(n_failed, cap) or n_rescued > most
            or bool((rescued & ~failed).any())):
        fail(f"{what}: {n_rescued} lanes changed, {n_failed} failed, "
             f"capacity {cap}, {len(stages)} stages")
    keep = ~rescued
    if not (torch.equal(status[keep], fast["status"][keep])
            and all(torch.equal(o[keep], f[keep])
                    for o, f in zip(outs, fast["outs"]))):
        fail(f"{what}: a lane outside the rescue differs from the fast "
             "route")
    rec = dict(solved_before=1.0 - n_failed / B,
               solved_after=float((status == 0).float().mean()),
               failed=n_failed, rescued=n_rescued,
               rescued_solved=int((status[rescued] == 0).sum()),
               stages=len(stages),
               fast_launches=fast["launches"],
               stage_batches=[r["B"] for r in stages],
               stage_launches=[r["launches"] for r in stages])
    return rec, rescued


def main_path_phase(ct, counters, path, calls=None, B=None):
    """A layer path at full width (`B` overrides the path's batch in a
    rehearsal) through solve_with_info, or solve_with_rescue on a rescue
    path, `calls` timed calls (the path's own count by default) after a
    warm-up. `counters` maps each kernel's name to the module that counts
    its launches; every count is set to 0 just before the calls and read
    just after. Every output of the layer is held against the f64 run."""
    r = np.random.default_rng(0)
    B = B or path.B
    calls = path.calls if calls is None else calls
    layer = path.build(ct, DEV)
    route, form = route_of(layer, path.args)
    if route != path.route:
        fail(f"{path.name}: route {route}, expected {path.route}")
    log = StageLog(layer, counters) if path.rescue else None
    # fresh inputs for every call, made up front and moved in bulk
    host = [path.params(r, B) for _ in range(calls + 1)]
    inputs = [to_dev(h, torch.float32) for h in host]
    sync()

    for mod in counters.values():
        mod.LAUNCHES = 0
    times = []
    solved = []
    iters_max = []
    rescues = []
    first = None
    with EighCount() as eigh, QrShapes() as qr_shapes:
        for i, params in enumerate(inputs):
            t0 = time.perf_counter()
            outs, status, iters = path.solve(ct, layer, params)
            sync()
            dt = (time.perf_counter() - t0) * 1e3
            if i == 0:
                first = (outs, status, iters)
            else:  # call 0 is the warm-up (allocator, library load)
                times.append(dt)
            solved.append(float((status == 0).float().mean()))
            iters_max.append(int(iters.max()))
            if log:
                rescues.append(check_rescue(path, log.take(), outs, status,
                                            iters)[0])
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    check_launches(f"{path.name} path", launches, path.wants, path.forbids)
    # the stacked factor [Lp'; B A_in] of the IPM's condensed KKT
    k2_shape = (B, layer.prog.m - layer.prog.dims.zero + layer.prog.n,
                layer.prog.n)
    if path.k2_per_iteration and DEV == "cuda" and (
            set(qr_shapes.shapes) != {k2_shape}
            or launches["K2"] != sum(iters_max)):
        fail(f"{path.name} path: K2 ran {launches['K2']} times at "
             f"{sorted(set(qr_shapes.shapes))} over {sum(iters_max)} "
             f"iterations, expected one launch an iteration at {k2_shape}")
    if route == "shared" and not layer._shared_solvers:
        fail(f"{path.name}: the shared solver never ran")

    outs, status, iters = first
    var = layer._outputs[0][1]
    want_shape = (B,) + tuple(layer.prog.var_info[id(var)].shape)
    x = flat_outputs(outs)
    finite = torch.isfinite(x).all(dim=1)
    must = (status == 0 if path.agree_solved_only
            else torch.ones_like(finite))
    if tuple(outs[0].shape) != want_shape or not bool(finite[must].all()):
        fail(f"{path.name} path: bad output {tuple(outs[0].shape)}")
    # reference: the port's own f64 CPU run on the first lanes
    k = path.agree_lanes
    cpu_layer = path.build(ct, "cpu")
    outs64, st64, _ = path.solve(
        ct, cpu_layer, to_dev([h[:k] for h in host[0]], torch.float64, "cpu"))
    gap = (x[:k].double().cpu() - flat_outputs(outs64)).abs().max(dim=1).values
    both = (status[:k].cpu() == 0) & (st64 == 0)
    if path.agree_solved_only:
        if not bool(both.any()):
            fail(f"{path.name} path: no lane of the first {k} solved on "
                 "both devices")
        gap = gap[both]
    diff = float(gap.max())
    res = dict(
        path=path.name, layer=path.layer, route=route, ipm_form=form,
        n=layer.prog.n, m=layer.prog.m, dims=str(layer.prog.dims), B=B,
        dtype="float32", solver_args=path.args, calls=len(inputs),
        solved_fraction_first=solved[0],
        solved_fraction_min=min(solved),
        solved_fraction_per_call=solved,
        iters_max_per_call=iters_max,
        iters_mean_first=float(iters.float().mean()),
        launches_before={k_: 0 for k_ in counters},
        launches_after=launches,
        launches_per_call={k_: v / len(inputs)
                           for k_, v in launches.items()},
        eigh_calls_per_call=eigh.n / len(inputs),
        k2_shapes=sorted(set(qr_shapes.shapes)),
        median_ms_per_call=statistics.median(times),
        ms_per_call=times,
        solves_per_s=B / statistics.median(times) * 1e3,
        agree_lanes=k,
        agree_solved_only=path.agree_solved_only,
        lanes_solved_on_both=int(both.sum()),
        max_abs_diff_vs_f64_cpu=diff,
        f64_cpu_solved=float((st64 == 0).double().mean()),
        nonfinite_lanes_first=int((~finite).sum()),
    )
    if path.rescue:
        res.update(rescue_args=path.rescue, capacity=path.capacity,
                   warm=path.warm, rescue_per_call=rescues)
    say("main", json.dumps(res))
    if path.min_solved is not None and min(solved) < path.min_solved:
        fail(f"{path.name} path: solved fraction {min(solved)} < "
             f"{path.min_solved}")
    # f32 at eps 1e-4 against f64: the solution agrees to ~1e-4, and
    # 2e-3 leaves room for the loosest certified lanes
    if diff > 2e-3:
        fail(f"{path.name} path: f32 cuda vs f64 cpu max abs diff "
             f"{diff:.3e}")
    return res, launches


def device_profile(ct, path, layer, params):
    """Device time by kernel name for one call of a path."""
    return kernel_times(lambda: path.solve(ct, layer, params))[:3]


def kernel_times(fn, host=False):
    """(device us, device kernel count, the top 8 (us, name, count), the
    profile) of one call of `fn`; `host` records host events as well
    (user annotations among them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only, read from the trace's raw events: recording
    # every host operator, or averaging through key_averages(), costs
    # about 0.2 ms an event, many seconds on the Anderson path
    acts = (([ProfilerActivity.CUDA] if DEV == "cuda" else [])
            + ([ProfilerActivity.CPU] if host else []))
    with profile(activities=acts) as prof:
        fn()
        sync()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue  # host events, and annotation ranges on the device
        us, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    rows = sorted(((us, name, n) for name, (us, n) in by_name.items()),
                  reverse=True)
    total = sum(us for us, _, _ in rows)
    count = sum(n for _, _, n in rows)
    return total, count, rows[:8], prof


def profile_phase(ct, path):
    layer = path.build(ct, DEV)
    params = to_dev(path.params(np.random.default_rng(7), path.B),
                    torch.float32)
    path.solve(ct, layer, params)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total_us, count, top = device_profile(ct, path, layer, params)
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


def gradient_lanes(rescued, k=8):
    """The lanes held against f64: the rescued lanes first (up to half of
    them), then the first lanes."""
    lanes = torch.nonzero(rescued).flatten().tolist()[:k // 2]
    lanes += [i for i in range(k + len(lanes)) if i not in lanes]
    return lanes[:k]


def gradient_phase(ct, counters, path, calls=None, B=None):
    """Forward + backward through a layer path: finite gradients of
    sum(x) (of sum_i w_i'out_i over every output, with seeded w_i, on a
    weighted path) with respect to every parameter, and 8 instances'
    gradients against the port's f64 CPU gradients of the same instances:
    the first 8 of the first call, or on a rescue path, of the first call
    whose rescue solved a lane, up to 4 such lanes and the first lanes
    after them (a path whose fast route failed no lane, or whose rescue
    solved none, compares the first call's first 8 and says so).
    At eps 1e-4 the f32 solution sits ~1e-7 from the f64 one after the
    polish and the adjoint solve takes one refinement pass, so gradients
    agree to ~1e-4 of their scale; 1e-2 is the limit. Each parameter's
    error is taken over its own largest f64 gradient, or over 1e-3 of the
    largest of all parameters where that is larger (the path's
    grad_floor): an LP's solution does not move with its cost vector, so
    that gradient is zero up to rounding and has no scale of its own."""
    r = np.random.default_rng(11)
    B = B or path.B
    calls = path.grad_calls if calls is None else calls
    layer = path.build(ct, DEV)
    log = StageLog(layer, counters) if path.rescue else None
    host = [path.params(r, B) for _ in range(calls + 1)]
    w_rng = np.random.default_rng(12)
    weights = None

    def loss(outs, ws):
        if not path.weighted:
            return outs[0].sum()
        return sum((o * w).sum() for o, w in zip(outs, ws))

    for mod in counters.values():
        mod.LAUNCHES = 0
    times = []
    runs = []
    for i, h in enumerate(host):
        params = [t.requires_grad_() for t in to_dev(h, torch.float32)]
        sync()
        t0 = time.perf_counter()
        outs, status, iters = path.solve(ct, layer, params)
        if weights is None:
            weights = [w_rng.standard_normal(tuple(o.shape)) for o in outs]
            w32 = to_dev(weights, torch.float32)
        loss(outs, w32).backward()
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        if i:
            times.append(dt)
        rescued = torch.zeros(B, dtype=torch.bool)
        if log:
            rescued = check_rescue(path, log.take(), outs, status,
                                   iters)[1].cpu()
        # the lanes a rescue solved
        runs.append((params, status, rescued & (status.cpu() == 0)))
        for p in params:
            if p.grad is None or tuple(p.grad.shape) != tuple(p.shape):
                fail(f"gradient ({path.name}): a parameter got no "
                     "gradient")
            if not bool(torch.isfinite(p.grad).all()):
                fail(f"gradient ({path.name}): non-finite gradient")
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    check_launches(f"gradient ({path.name})", launches, path.wants,
                   path.forbids)

    call = next((i for i, run in enumerate(runs) if bool(run[2].any())), 0)
    params, status, rescued = runs[call]
    lanes = gradient_lanes(rescued)
    cpu_layer = path.build(ct, "cpu")
    ref = [t.requires_grad_() for t in
           to_dev([a[lanes] for a in host[call]], torch.float64, "cpu")]
    outs64, st64, _ = path.solve(ct, cpu_layer, ref)
    loss(outs64, to_dev([w[lanes] for w in weights], torch.float64,
                        "cpu")).backward()
    both = (status[lanes].cpu() == 0) & (st64 == 0)
    rescued_compared = int((rescued[lanes] & both).sum())
    rel = []
    if bool(both.any()):
        overall = max(float(q.grad[both].abs().max()) for q in ref)
        for p, q in zip(params, ref):
            g = p.grad[lanes].double().cpu()[both]
            scale = max(float(q.grad[both].abs().max()),
                        path.grad_floor * overall)
            rel.append(float((g - q.grad[both]).abs().max() / scale))
    res = dict(path=path.name, layer=path.layer, B=B, dtype="float32",
               loss="sum_i w_i'out_i, w seeded" if path.weighted
               else "sum(x)",
               calls=len(host), fwd_bwd_median_ms=statistics.median(times),
               fwd_bwd_ms=times, launches=launches,
               compared_call=call,
               solved_fraction=float((status == 0).float().mean()),
               lanes=lanes, lanes_compared=int(both.sum()),
               rescued_lanes_solved_per_call=[int(run[2].sum())
                                              for run in runs],
               rescued_lanes_compared=rescued_compared,
               grad_floor=path.grad_floor,
               grad_rel_err_vs_f64_cpu=dict(zip(path.names, rel)),
               grad_abs_max=[float(p.grad.abs().max()) for p in params],
               grad_abs_max_f64=[float(q.grad.abs().max()) for q in ref])
    say("grad", json.dumps(res))
    if not bool(both.any()):
        fail(f"gradient ({path.name}): no lane solved on both devices")
    if bool(rescued.any()) and not rescued_compared:
        fail(f"gradient ({path.name}): no rescued lane among the lanes "
             "held against f64")
    if path.forced and not rescued_compared:
        fail(f"gradient ({path.name}): the forced rescue compared no "
             "rescued lane")
    if max(rel) > 1e-2:
        fail(f"gradient ({path.name}): relative error {max(rel):.3e} "
             "against the f64 CPU gradient > 1e-2")
    return res


# the forced softmax rescue of the small-layers phase: every lane of the
# fast route fails, so both ladder stages, the PCG one among them, run on
# the card on every call
SOFTMAX_FORCED = Path("softmax_forced", "softmax", softmax_layer,
                      softmax_params, ["c"], SM_FORCED_ARGS, None,
                      ("K1", "K2"), "shared", 8, weighted=True, B=256,
                      rescue=SM_LADDER, capacity=SM_CAPACITY, warm=True,
                      stage_wants=None, forced=True, min_solved=None,
                      agree_solved_only=True)


def small_markowitz(ct, device):
    return markowitz_layer(ct, device, n=10, k=3)


def small_layers_phase(ct, counters):
    r = np.random.default_rng(1)
    B = 256
    out = {}
    simplex_v = [r.standard_normal((B, 20))]
    lad_ab = [r.standard_normal((B, 3, 2)), r.standard_normal((B, 3))]
    pow_v = [r.standard_normal((B, 3))]
    soc = markowitz_params(r, B, n=10, k=3)
    sm_c = softmax_params(r, B)
    pow_args = dict(TUNED_ARGS, max_iters=1000, epoch=50, refine_steps=10)
    cones = ("K1", "K2")
    # (name, layer, parameters, solver_args, kernel wanted, kernels
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
        # the general cones: a power cone on the shared route (its
        # solution is the cone's projection of v), and an SOC layer whose
        # polish takes the stale-factor PCG and the spectral-Schur modes
        ("pow3", pow3_layer, pow_v, pow_args, None, cones, "shared"),
        ("soc_pcg", small_markowitz, soc,
         dict(MARKOWITZ_ARGS, kkt_mode="pcg"), None, cones, "dense"),
        ("soc_spectral", small_markowitz, soc,
         dict(MARKOWITZ_ARGS, kkt_mode="spectral"), None, cones, "dense"),
        # the IPM's nonsymmetric blocks: the primal-dual form, which
        # "auto" takes for exp and power cones (n > 160 on neither, so a
        # K2 launch per iteration and one for the initial point)
        ("softmax_ipm", softmax_layer, sm_c,
         ipm_args(SM_ARGS, ipm_max_iters=50), "K2", "K1", "dense"),
        ("pow3_ipm", pow3_layer, pow_v, ipm_args(pow_args, ipm_max_iters=50),
         "K2", "K1", "dense"),
    ):
        layer = build(ct, DEV)
        route, form = route_of(layer, args)
        if route != want_route:
            fail(f"{name}: route {route}, expected {want_route}")
        if name in ("softmax_ipm", "pow3_ipm") and form != "pd":
            fail(f"{name}: the IPM took the {form} form, expected pd")
        dev = to_dev(params, torch.float32)
        for mod in counters.values():
            mod.LAUNCHES = 0
        (x, *_), status, iters = layer.solve_with_info(*dev,
                                                      solver_args=args)
        sync()
        launches = {k: mod.LAUNCHES for k, mod in counters.items()}
        solved = float((status == 0).float().mean())
        check_launches(name, launches, wants, forbids)
        if not bool(torch.isfinite(x).all()):
            fail(f"{name}: non-finite output")
        k = 8
        cpu = build(ct, "cpu")
        (x64, *_), st64, _ = cpu.solve_with_info(
            *to_dev([p[:k] for p in params], torch.float64, "cpu"),
            solver_args=args)
        both = ((status[:k].cpu() == 0) & (st64 == 0))
        diff = float((x[:k].double().cpu() - x64).abs().max(dim=1)
                     .values[both].max()) if bool(both.any()) else None
        rec = dict(layer=name, B=B, dtype="float32", route=route,
                   ipm_form=form, solved_fraction=solved,
                   iters_max=int(iters.max()), launches=launches,
                   max_abs_diff_vs_f64_cpu_solved_lanes=diff)
        if name.startswith("pow3"):
            from cvxpylayers_tpu_torch.cones.projections import project_pow3
            proj = project_pow3(dev[0], 0.4)
            ok = status == 0
            rec["max_abs_diff_vs_projection_solved_lanes"] = float(
                (x - proj).abs().max(dim=1).values[ok].max()) \
                if bool(ok.any()) else None
            if not bool(ok.any()) or \
                    rec["max_abs_diff_vs_projection_solved_lanes"] > 2e-3:
                fail(f"{name}: the layer is not the cone's projection")
        say("small", json.dumps(rec))
        if diff is not None and diff > 2e-3:
            fail(f"{name}: f32 cuda vs f64 cpu max abs diff {diff:.3e}")
        out[name] = rec
    out["softmax_forced"] = forced_ladder_record(ct, counters)
    out["tf32_pinned"] = tf32_record(ct)
    return out


def tf32_record(ct):
    """The package pins its own products to full f32: an SDP layer (the
    Newton-Schulz inner loop, the exact polish, the PSD Jacobians), the
    SOC layer by the PCG mode and by the IPM give the same outputs with
    TF32 matmuls allowed globally as without (within 1e-6; a TF32 product
    would move them by ~1e-3)."""
    r = np.random.default_rng(3)
    B = 256
    rec = {}
    for name, build, params, args in (
        ("sdp_s6", lambda ct_, dev: sdp_layer(ct_, dev, s=6),
         sdp_params(r, B, s=6), SDP_ARGS),
        ("soc_pcg", small_markowitz, markowitz_params(r, B, n=10, k=3),
         dict(MARKOWITZ_ARGS, kkt_mode="pcg")),
        # the IPM's SOC blocks, its condensed KKT through K2 and the
        # spectral polish
        ("soc_ipm", small_markowitz, markowitz_params(r, B, n=10, k=3),
         MARKOWITZ_IPM_ARGS),
    ):
        layer = build(ct, DEV)
        dev = to_dev(params, torch.float32)
        got = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                (x,), status, _ = layer.solve_with_info(*dev,
                                                        solver_args=args)
                sync()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            got[tf32] = (x, status)
        diff = float((got[True][0] - got[False][0]).abs().max())
        rec[name] = dict(max_abs_diff_tf32_on_vs_off=diff,
                         same_status=bool(torch.equal(got[True][1],
                                                      got[False][1])))
        if diff > 1e-6 or not rec[name]["same_status"]:
            fail(f"tf32 ({name}): outputs move by {diff:.3e} when TF32 "
                 "matmuls are allowed")
    say("small", json.dumps(dict(layer="tf32_pinned", B=B, **rec)))
    return rec


def forced_ladder_record(ct, counters):
    """The forced softmax ladder at B=256: both stages run (the first
    leaves every lane beyond its capacity unsolved), K1 and K2 stay at 0,
    and the lanes solved on the card and by the same ladder in f64 on the
    CPU agree within 2e-3."""
    path = SOFTMAX_FORCED
    layer = path.build(ct, DEV)
    log = StageLog(layer, counters)
    host = path.params(np.random.default_rng(2), path.B)
    for mod in counters.values():
        mod.LAUNCHES = 0
    outs, status, iters = path.solve(ct, layer,
                                     to_dev(host, torch.float32))
    sync()
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    check_launches(path.name, launches, None, path.forbids)
    rec, _ = check_rescue(path, log.take(), outs, status, iters)
    if rec["stages"] != len(path.ladder):
        fail(f"{path.name}: {rec['stages']} of {len(path.ladder)} ladder "
             "stages ran")
    k = path.agree_lanes
    outs64, st64, _ = path.solve(ct, path.build(ct, "cpu"),
                                 to_dev([h[:k] for h in host],
                                        torch.float64, "cpu"))
    both = (status[:k].cpu() == 0) & (st64 == 0)
    gap = (flat_outputs(outs)[:k].double().cpu()
           - flat_outputs(outs64)).abs().max(dim=1).values
    diff = float(gap[both].max()) if bool(both.any()) else None
    rec.update(layer=path.name, B=path.B, launches=launches,
               lanes_solved_on_both=int(both.sum()),
               max_abs_diff_vs_f64_cpu_solved_lanes=diff)
    say("small", json.dumps(rec))
    if diff is None or diff > 2e-3:
        fail(f"{path.name}: f32 cuda vs f64 cpu max abs diff {diff}")
    return rec


# ---------------------------------------------------- the sparse route


# bench.py's two ot rows at their own width (B=8, 64x64); `calls` timed
# calls after a warm-up. bench.py read solved 1.0 on its instances; on
# these the reference's own f32 PDHG (JAX on the CPU) leaves one lane of
# 8 unsolved after its polish in one of three calls (a knife-edge lane,
# as bench.py's notes describe), and the port on the card one of 8 on
# the second call; so a call fails below 7 of 8
OT_PATHS = {
    "ot_lp_pdhg": Path("ot_lp_pdhg", "ot64", ot_layer, ot_params, ["C"],
                       OT_PDHG_ARGS, None, ("K1", "K2"), "sparse", 0,
                       weighted=True, B=8, min_solved=0.875, calls=1),
    "ot_lp_admm": Path("ot_lp_admm", "ot64", ot_layer, ot_params, ["C"],
                       OT_ARGS, None, ("K1", "K2"), "sparse", 0,
                       weighted=True, B=8, min_solved=0.875, calls=1),
}
# the path whose sparse reductions are checked for determinism: two calls
# on the same inputs give bitwise-equal outputs and equal iterations
OT_DETERMINISM = "ot_lp_pdhg"


def ot_phase(ct, counters, path, calls=None, B=None):
    """A transport LP path on the sparse route: `calls` timed calls with
    fresh inputs after a warm-up, K1 and K2 counted from 0 and held at 0,
    the solved fraction (at least the path's min_solved), every solved
    lane's objective against HiGHS's (linprog) within OT_OBJ_TOL of the
    larger of 1 and its size (every lane's plain relative error is
    recorded), the iterations;
    on OT_DETERMINISM a second call on the warm-up's inputs must give the
    same outputs bit for bit and the same iterations; then one forward +
    backward on fresh inputs (the gradient in C of a seeded weighting of
    the plan, finite; the solver is warm from the calls before), and a
    device profile of one call. Returns (record, launches)."""
    B = B or path.B
    calls = path.calls if calls is None else calls
    layer = path.build(ct, DEV)
    route, _ = route_of(layer, path.args)
    if route != path.route:
        fail(f"{path.name}: route {route}, expected {path.route}")
    r = np.random.default_rng(0)
    host = [path.params(r, B) for _ in range(calls + 1)]
    inputs = [to_dev(h, torch.float32) for h in host]
    sync()

    for mod in counters.values():
        mod.LAUNCHES = 0
    times, solved, iters_max, iters_mean, outs = [], [], [], [], []
    for i, params in enumerate(inputs):
        t0 = time.perf_counter()
        (X,), status, iters = layer.solve_with_info(*params,
                                                    solver_args=path.args)
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        if i:
            times.append(dt)
        solved.append(float((status == 0).float().mean()))
        iters_max.append(int(iters.max()))
        iters_mean.append(float(iters.float().mean()))
        outs.append((X, status, iters))
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    check_launches(f"{path.name} path", launches, path.wants, path.forbids)

    # objectives against HiGHS, every lane of every call
    rel, err_solved = [], []
    for h, (X, status, _) in zip(host, outs):
        if not bool(torch.isfinite(X).all()):
            fail(f"{path.name}: non-finite plan")
        obj = (X.double().cpu().numpy() * h[0]).sum(axis=(1, 2))
        lp = ot_linprog(h[0])
        rel.extend((np.abs(obj - lp) / np.abs(lp)).tolist())
        ok = status.cpu().numpy() == 0
        err_solved.extend((np.abs(obj - lp)
                           / np.maximum(np.abs(lp), 1.0))[ok].tolist())

    same = None
    if path.name == OT_DETERMINISM:
        (X2,), st2, it2 = layer.solve_with_info(*inputs[0],
                                                solver_args=path.args)
        sync()
        X1, st1, it1 = outs[0]
        same = bool(torch.equal(X1, X2) and torch.equal(st1, st2)
                    and torch.equal(it1, it2))

    # forward + backward: the gradient in C of a seeded weighting
    w = to_dev([np.random.default_rng(12).standard_normal(
        tuple(outs[0][0].shape))], torch.float32)[0]
    (C,) = [t.requires_grad_() for t in
            to_dev(path.params(r, B), torch.float32)]
    sync()
    t0 = time.perf_counter()
    (X,), status, _ = layer.solve_with_info(C, solver_args=path.args)
    (X * w).sum().backward()
    sync()
    g_ms = (time.perf_counter() - t0) * 1e3
    if C.grad is None or not bool(torch.isfinite(C.grad).all()):
        fail(f"gradient ({path.name}): no finite gradient in C")

    total_us, count, top = device_profile(ct, path, layer, inputs[0])
    n_, m_ = layer.prog.n, layer.prog.m
    res = dict(
        path=path.name, layer=path.layer, route=route, n=n_, m=m_,
        nnz_A=int(layer.prog.A_rows.size), dims=str(layer.prog.dims), B=B,
        dtype="float32", solver_args=path.args, calls=len(inputs),
        solved_fraction_per_call=solved,
        solved_fraction_min=min(solved),
        iters_max_per_call=iters_max, iters_mean_per_call=iters_mean,
        launches_before={k: 0 for k in counters}, launches_after=launches,
        launches_per_call={k: v / len(inputs) for k, v in launches.items()},
        median_ms_per_call=statistics.median(times), ms_per_call=times,
        solves_per_s=B / statistics.median(times) * 1e3,
        obj_rel_err_vs_linprog_max=max(rel), obj_rel_err_vs_linprog=rel,
        obj_err_solved_lanes_max=max(err_solved),
        deterministic_repeat=same,
        fwd_bwd_ms=g_ms,
        device_kernels=count, device_ms=total_us / 1e3,
        device_top=[(round(us, 1), name[:60], n) for us, name, n in top])
    say("ot", json.dumps(res))
    if min(solved) < path.min_solved:
        fail(f"{path.name}: solved fraction {min(solved)} < "
             f"{path.min_solved}")
    if max(err_solved) > OT_OBJ_TOL:
        fail(f"{path.name}: a solved lane's objective is {max(err_solved):.3e}"
             f" from linprog's (over max(1, |obj|)) > {OT_OBJ_TOL}")
    if same is False:
        fail(f"{path.name}: two calls on the same inputs differ (the "
             "sparse route's reductions must be deterministic)")
    return res, launches


# ------------------------------------------------- forward-mode derivative


def jvp_call(layer, params, tangents, args):
    """(x, J t, status) of one forward-mode call."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) for p, t in zip(params, tangents)]
        (x,), status, _ = layer.solve_with_info(*duals, solver_args=args)
        x, dx = fwAD.unpack_dual(x)
    return x, dx, status


def jvp_against_f64(ct, build, host, tangents, args, dx, status, k=8):
    """Agreement of a forward-mode call's first k lanes (dx, status) with
    the port's f64 CPU JVP of the same instances: (max abs difference
    over the f64 JVP's largest entry, on the lanes solved on both, their
    count)."""
    _, dx64, st64 = jvp_call(
        build(ct, "cpu"), to_dev([h[:k] for h in host], torch.float64, "cpu"),
        to_dev([t[:k] for t in tangents], torch.float64, "cpu"), args)
    both = (status[:k].cpu() == 0) & (st64 == 0)
    if not bool(both.any()):
        return None, 0
    scale = max(float(dx64[both].abs().max()), 1e-12)
    err = float((dx[:k].double().cpu() - dx64)[both].abs().max())
    return err / scale, int(both.sum())


# the flagship's settings with the Schur-CG steps at their default (20 at
# n=50), as ipm_rescue's stage: with the row's 5 the f32 KKT solves are
# inexact on a few lanes, the forward rule's as the adjoint's (on lane
# 755 of these instances <g, J t> is -16.42 against -18.22 in f64, in
# the reference's f32 JVP as in the port's, and <J'g, t> -18.02; CPU);
# with 20 both are within 2e-7 of the f64 value
JVP_ARGS = {k: v for k, v in BOX_QP_ARGS.items() if k != "schur_iters"}
JVP_ARGS.update(solve_method="admm", derivative="forward")


def box_qp_jvp_phase(ct, counters, B=1024, calls=2):
    """The flagship box-QP (n=50, G 20x50, f32) with derivative="forward":
    one forward-mode pass along a seeded tangent of every parameter a
    call, K1 counted from 0 (once a call on the forward: one epoch);
    the dot-product identity <g, J t> = <J'g, t> against the adjoint on
    the same instances (per lane, over the batch's largest |<g, J t>|),
    and the JVP of 8 lanes against the port's f64 CPU JVP, each failed
    above 1e-2; ms per forward+JVP."""
    layer = box_qp_layer(ct, DEV)
    r = np.random.default_rng(21)
    host = [box_qp_params(r, B) for _ in range(calls + 1)]
    t_host = [r.standard_normal(a.shape) for a in host[0]]
    tangents = to_dev(t_host, torch.float32)
    inputs = [to_dev(h, torch.float32) for h in host]
    sync()
    for mod in counters.values():
        mod.LAUNCHES = 0
    times = []
    first = None
    for i, params in enumerate(inputs):
        t0 = time.perf_counter()
        out = jvp_call(layer, params, tangents, JVP_ARGS)
        sync()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        else:
            first = out
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    check_launches("box_qp_jvp", launches, "K1", None)
    if DEV == "cuda" and launches["K1"] != len(inputs):
        fail(f"box_qp_jvp: K1 ran {launches['K1']} times in "
             f"{len(inputs)} calls, expected once a call")
    x, dx, status = first
    if not bool(torch.isfinite(dx).all()):
        fail("box_qp_jvp: non-finite tangent")

    # the adjoint on the same instances: <J'g, t> per lane
    g = to_dev([np.random.default_rng(22).standard_normal((B, 50))],
               torch.float32)[0]
    params = [p.clone().requires_grad_() for p in inputs[0]]
    (xa,), st_a, _ = layer.solve_with_info(
        *params, solver_args=dict(JVP_ARGS, derivative="adjoint"))
    (xa * g).sum().backward()
    lhs = (g * dx).sum(dim=1)
    rhs = sum((p.grad * t).reshape(B, -1).sum(dim=1)
              for p, t in zip(params, tangents))
    ok = (status == 0) & (st_a == 0)
    dot_scale = float(lhs[ok].abs().max())
    dot_err = float((lhs - rhs)[ok].abs().max()) / dot_scale

    f64_err, f64_lanes = jvp_against_f64(ct, box_qp_layer, host[0], t_host,
                                         JVP_ARGS, dx, status)
    res = dict(path="box_qp_jvp", layer="box_qp", B=B, dtype="float32",
               solver_args=JVP_ARGS, calls=len(inputs),
               solved_fraction=float((status == 0).float().mean()),
               launches=launches,
               launches_per_call={k: v / len(inputs)
                                  for k, v in launches.items()},
               fwd_jvp_median_ms=statistics.median(times),
               fwd_jvp_ms=times,
               dot_identity_rel_err=dot_err,
               dot_identity_lanes=int(ok.sum()),
               jvp_rel_err_vs_f64_cpu=f64_err,
               jvp_lanes_compared=f64_lanes)
    say("jvp", json.dumps(res))
    if f64_err is None or f64_err > 1e-2:
        fail(f"box_qp_jvp: JVP against the f64 CPU JVP {f64_err}")
    if dot_err > 1e-2:
        fail(f"box_qp_jvp: <g, J t> and <J'g, t> differ by {dot_err:.3e} "
             "of the largest")
    return res, launches


def small_new_routes_phase(ct, counters):
    """Small records at B=256 of the sparse route, PDHG and the forward-
    mode rule: dense PDHG on the box-LP, the "auto" assembly taking the
    sparse route on a simplex projection whose m n exceeds 2^16, and
    forward-mode JVPs by the IPM (K2 on its path) and on the sparse
    route, each against the port's f64 CPU run of its first 8 lanes:
    outputs within 2e-3, the LP's objective within 2e-3 relative (two
    eps-solutions of an LP may lie further apart than its objectives: on
    the CPU one lane's f32 and f64 plans differ by 3.5e-3 where their
    objectives differ by 5e-5), JVPs within 1e-2 of scale."""
    r = np.random.default_rng(4)
    B = 256
    out = {}
    box = box_qp_params(r, B)
    simplex_v = simplex_params(r, B, n=300)
    big_simplex = lambda ct_, dev: simplex_layer(ct_, dev, n=300)  # noqa
    cones = ("K1", "K2")
    # an LP's f32 polish runs CG on the normal equations: 200 steps, as
    # the HSDE box-LP path (40 leave the plan ~1e-2 off the f64 one)
    for name, build, params, args, wants, forbids, want_route in (
        ("box_lp_pdhg", box_lp_layer, box,
         dict(BOX_QP_ARGS, solve_method="pdhg", max_iters=4000, epoch=50,
              cg_iters=200),
         None, cones, "dense"),
        ("simplex_auto_sparse", big_simplex, simplex_v, SIMPLEX_ARGS, None,
         cones, "sparse"),
    ):
        layer = build(ct, DEV)
        route, _ = route_of(layer, args)
        if route != want_route:
            fail(f"{name}: route {route}, expected {want_route}")
        dev = to_dev(params, torch.float32)
        for mod in counters.values():
            mod.LAUNCHES = 0
        (x,), status, iters = layer.solve_with_info(*dev, solver_args=args)
        sync()
        launches = {k: mod.LAUNCHES for k, mod in counters.items()}
        check_launches(name, launches, wants, forbids)
        k = 8
        (x64,), st64, _ = build(ct, "cpu").solve_with_info(
            *to_dev([p[:k] for p in params], torch.float64, "cpu"),
            solver_args=args)
        both = (status[:k].cpu() == 0) & (st64 == 0)
        if not bool(both.any()):
            fail(f"{name}: no lane of the first {k} solved on both devices")
        x32 = x[:k].double().cpu()
        diff = float((x32 - x64).abs().max(dim=1).values[both].max())
        rec = dict(layer=name, B=B, dtype="float32", route=route,
                   solved_fraction=float((status == 0).float().mean()),
                   iters_max=int(iters.max()), launches=launches,
                   max_abs_diff_vs_f64_cpu_solved_lanes=diff)
        if name == "box_lp_pdhg":
            v = torch.as_tensor(params[0][:k])
            obj, obj64 = (v * x32).sum(dim=1), (v * x64).sum(dim=1)
            rec["obj_rel_diff_vs_f64_cpu_solved_lanes"] = float(
                ((obj - obj64).abs() / obj64.abs().clamp_min(1.0))[both]
                .max())
        say("small", json.dumps(rec))
        if not bool(torch.isfinite(x).all()):
            fail(f"{name}: non-finite output")
        worst = rec.get("obj_rel_diff_vs_f64_cpu_solved_lanes", diff)
        if worst > 2e-3:
            fail(f"{name}: f32 cuda vs f64 cpu {worst:.3e}")
        out[name] = rec

    tangents = [r.standard_normal(a.shape) for a in box]
    for name, args, wants, forbids, want_route in (
        ("box_qp_jvp_ipm", dict(JVP_ARGS, solve_method="ipm"), "K2", "K1",
         "dense"),
        ("box_qp_jvp_sparse", dict(JVP_ARGS, assembly="sparse"), None,
         cones, "sparse"),
    ):
        layer = box_qp_layer(ct, DEV)
        route, _ = route_of(layer, args)
        if route != want_route:
            fail(f"{name}: route {route}, expected {want_route}")
        for mod in counters.values():
            mod.LAUNCHES = 0
        _, dx, status = jvp_call(layer, to_dev(box, torch.float32),
                                 to_dev(tangents, torch.float32), args)
        sync()
        launches = {k: mod.LAUNCHES for k, mod in counters.items()}
        check_launches(name, launches, wants, forbids)
        err, lanes = jvp_against_f64(ct, box_qp_layer, box, tangents, args,
                                     dx, status)
        rec = dict(layer=name, B=B, dtype="float32", route=route,
                   solved_fraction=float((status == 0).float().mean()),
                   launches=launches, jvp_rel_err_vs_f64_cpu=err,
                   jvp_lanes_compared=lanes)
        say("small", json.dumps(rec))
        if not bool(torch.isfinite(dx).all()):
            fail(f"{name}: non-finite tangent")
        if err is None or err > 1e-2:
            fail(f"{name}: JVP against the f64 CPU JVP {err}")
        out[name] = rec
    return out


# ------------------------------- geometric programs, duals, plain solve


def gp_layer(ct, device):
    """bench.py's GP row (the reference's test_basic_gp problem): min
    1/(xyz) s.t. a(xy + xz + yz) <= b, x >= y^c, solved in log space
    (gp=True): 4 nonneg rows and 4 exponential cones, c multiplies a
    variable, so the route is the dense per-instance one."""
    x, y, z = (ct.Variable((), pos=True) for _ in range(3))
    a = ct.Parameter((), pos=True)
    b = ct.Parameter((), pos=True)
    c = ct.Parameter(())
    prob = ct.Problem(ct.Minimize(1.0 / (x * y * z)),
                      [a * (x * y + x * z + y * z) <= b, x >= y ** c])
    return ct.CvxpyLayer(prob, parameters=[a, b, c], variables=[x, y, z],
                         gp=True, device=device)


def gp_params(r, B):
    """bench.py's draws: |N| + 1, |N| + 3, U(0.3, 0.9)."""
    return [np.abs(r.standard_normal(B)) + 1.0,
            np.abs(r.standard_normal(B)) + 3.0, r.uniform(0.3, 0.9, B)]


# bench.py's row 5 settings: _tuned_args with 300 iterations in epochs of
# 100 and 15 CG steps
GP_ARGS = dict(TUNED_ARGS, max_iters=300, epoch=100, cg_iters=15)
GP_PATHS = {
    # a general-cone program: K1 (polyhedral only) and K2 (IPM) stay at 0
    "gp": Path("gp", "gp", gp_layer, gp_params, "abc", GP_ARGS, None,
               ("K1", "K2"), "dense", 8, weighted=True, B=1024, calls=2),
}
# its gradient, with the f32 KKT solves' CG steps at their default 40: at
# bench.py's 15 the adjoint's CG stops short and the f32 gradients sit up
# to 8 % off the f64 ones (the port on the CPU, B=32); at 40, 3e-7
GP_GRAD_PATHS = {
    "gp": Path("gp", "gp", gp_layer, gp_params, "abc",
               dict(GP_ARGS, cg_iters=40), None, ("K1", "K2"), "dense", 8,
               weighted=True, B=1024, calls=2),
}


def markowitz_soc_layer(ct, device, n=50, k=10):
    """bench.py's Markowitz risk budget as an explicit SOC constraint
    (0.25, F w), returning w and both parts of the constraint's dual: the
    scalar t-part (B,) and the F w-shaped part (B, k)."""
    w = ct.Variable(n, nonneg=True)
    mu = ct.Parameter(n)
    F = ct.Parameter((k, n))
    risk = ct.SOC(ct.Constant(0.25), F @ w)
    prob = ct.Problem(ct.Maximize(mu @ w), [risk, ct.sum(w) == 1])
    return ct.CvxpyLayer(prob, parameters=[mu, F],
                         variables=[w] + list(risk.dual_variables),
                         device=device)


def sdp_dual_layer(ct, device, s=16):
    """bench.py's spectahedron SDP with X >> 0 as a constraint on a
    symmetric variable (bench.py's PSD=True variable carries the cone
    implicitly), returning X and the constraint's dual as an (s, s)
    matrix."""
    X = ct.Variable((s, s), symmetric=True)
    C = ct.Parameter((s, s))
    psd = X >> 0
    prob = ct.Problem(ct.Minimize(ct.trace(C @ X)),
                      [psd, ct.trace(X) == 1])
    return ct.CvxpyLayer(prob, parameters=[C],
                         variables=[X, psd.dual_variables[0]], device=device)


def softmax_exp_layer(ct, device, n=32):
    """bench.py's entropy softmax with its exponential cones written out:
    t_i <= -y_i log y_i as (t, y, 1) in K_exp, returning y and the three
    parts of the cone's dual, each (B, n)."""
    y = ct.Variable(n, nonneg=True)
    t = ct.Variable(n)
    c = ct.Parameter(n)
    cone = ct.ExpCone(t, y, ct.Constant(np.ones(n)))
    prob = ct.Problem(ct.Maximize(c @ y + ct.sum(t)), [ct.sum(y) == 1, cone])
    return ct.CvxpyLayer(prob, parameters=[c],
                         variables=[y] + list(cone.dual_variables),
                         device=device)


def structured_layer(ct, device):
    """sum_largest (an LP epigraph), norm_nuc and lambda_sum_largest (PSD
    epigraphs) in one prox layer (tests/test_torch_port_structured.py)."""
    v = ct.Parameter(8)
    M = ct.Parameter((4, 3))
    S = ct.Parameter((4, 4))
    x = ct.Variable(8)
    X = ct.Variable((4, 3))
    Y = ct.Variable((4, 4))
    prob = ct.Problem(ct.Minimize(
        ct.sum_squares(x - v) + ct.sum_squares(X - M)
        + ct.sum_squares(Y - S) + ct.sum_largest(x, 3)
        + ct.norm_nuc(X) + ct.lambda_sum_largest(Y, 2)))
    return ct.CvxpyLayer(prob, parameters=[v, M, S], variables=[x, X, Y],
                         device=device)


def structured_params(r, B):
    S = r.standard_normal((B, 4, 4))
    return [r.standard_normal((B, 8)), r.standard_normal((B, 4, 3)),
            0.5 * (S + S.transpose(0, 2, 1))]


# (name, layer, parameters, solver_args, the output whose gradient is
# checked, the shapes of the dual outputs without the batch axis)
DUAL_LAYERS = (
    ("markowitz_soc_duals", markowitz_soc_layer,
     lambda r, B: markowitz_params(r, B), MARKOWITZ_ARGS, 2,
     [(), (10,)]),
    ("sdp_psd_dual", sdp_dual_layer, lambda r, B: sdp_params(r, B),
     SDP_ARGS, 1, [(16, 16)]),
    ("softmax_exp_duals", softmax_exp_layer,
     lambda r, B: softmax_params(r, B), SM_ARGS, 3, [(32,)] * 3),
)
STRUCTURED_ARGS = dict(TUNED_ARGS, max_iters=1000, epoch=100,
                       refine_steps=10)


def layer_against_f64(ct, counters, name, build, params, args, grad_out,
                      dual_shapes=None, k=8, B=256):
    """One layer at B on the card in f32 against the port's f64 CPU run
    of its first k lanes: every output's shape (the duals' as given), the
    solved lanes' outputs within 2e-3 of the largest f64 output of each,
    and the gradient of a seeded weighting of output `grad_out` alone (of
    every output when it is None) within 1e-2 of the largest f64
    gradient (each parameter's error over
    its own largest, or over 1e-3 of all where that is larger). K1 and K2
    are counted from 0 and must stay there."""
    host = params(np.random.default_rng(6), B)
    layer = build(ct, DEV)
    dev = [t.requires_grad_() for t in to_dev(host, torch.float32)]
    for mod in counters.values():
        mod.LAUNCHES = 0
    sync()
    t0 = time.perf_counter()
    outs, status, iters = layer.solve_with_info(*dev, solver_args=args)
    weighed = range(len(outs)) if grad_out is None else [grad_out]
    w_rng = np.random.default_rng(13)
    ws = {i: w_rng.standard_normal(tuple(outs[i].shape)) for i in weighed}
    sum((outs[i] * to_dev([w], torch.float32)[0]).sum()
        for i, w in ws.items()).backward()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k_: mod.LAUNCHES for k_, mod in counters.items()}
    check_launches(name, launches, None, ("K1", "K2"))
    if dual_shapes is not None:
        got = [tuple(o.shape[1:]) for o in outs[len(outs)
                                                - len(dual_shapes):]]
        if got != [tuple(s) for s in dual_shapes]:
            fail(f"{name}: dual shapes {got}, expected {dual_shapes}")
    cpu = [t.requires_grad_() for t in
           to_dev([h[:k] for h in host], torch.float64, "cpu")]
    outs64, st64, _ = build(ct, "cpu").solve_with_info(*cpu,
                                                        solver_args=args)
    sum((outs64[i] * torch.as_tensor(w[:k])).sum()
        for i, w in ws.items()).backward()
    both = (status[:k].cpu() == 0) & (st64 == 0)
    if not bool(both.any()):
        fail(f"{name}: no lane of the first {k} solved on both devices")
    out_err = [float((o[:k].detach().double().cpu() - o64.detach())
                     .reshape(k, -1)[both].abs().max()
                     / max(float(o64.detach().abs().max()), 1e-3))
               for o, o64 in zip(outs, outs64)]
    overall = max(float(q.grad[both].abs().max()) for q in cpu)
    grad_err = [float((p.grad[:k].double().cpu() - q.grad)[both].abs().max()
                      / max(float(q.grad[both].abs().max()),
                            1e-3 * overall))
                for p, q in zip(dev, cpu)]
    rec = dict(layer=name, B=B, dtype="float32", n=layer.prog.n,
               m=layer.prog.m, dims=str(layer.prog.dims),
               route=route_of(layer, args)[0],
               solved_fraction=float((status == 0).float().mean()),
               iters_max=int(iters.max()), launches=launches,
               output_shapes=[list(o.shape) for o in outs],
               lanes_solved_on_both=int(both.sum()),
               out_rel_err_vs_f64_cpu=out_err, grad_output=grad_out,
               grad_rel_err_vs_f64_cpu=grad_err, fwd_bwd_ms=ms)
    say("phase7", json.dumps(rec))
    for o in outs:
        if not bool(torch.isfinite(o[status == 0]).all()):
            fail(f"{name}: non-finite output on a solved lane")
    if max(out_err) > 2e-3:
        fail(f"{name}: f32 cuda vs f64 cpu output error {max(out_err):.3e}")
    if max(grad_err) > 1e-2:
        fail(f"{name}: f32 cuda vs f64 cpu gradient error "
             f"{max(grad_err):.3e}")
    return rec, launches


def plain_solve_phase(ct, counters):
    """Problem.solve with the default device (the card): the LP of
    tests/test_problem_solve.py against scipy's linprog, a cached re-solve
    after a new Parameter.value that builds no second layer, the GP of
    that file against the port's f64 CPU value, and an infeasible and an
    unbounded problem (their status strings and infinite values). The
    parameters' values are float64, so the card solves in f64. A
    rehearsal without a card (DEV "cpu") passes the CPU explicitly."""
    from scipy.optimize import linprog

    device = None if DEV == "cuda" else DEV
    r = np.random.default_rng(11)
    for mod in counters.values():
        mod.LAUNCHES = 0
    rec = {}
    x = ct.Variable(4)
    c = ct.Parameter(4)
    lp = ct.Problem(ct.Minimize(c @ x), [x >= -1, x <= 1])
    for key in ("lp", "lp_resolve"):
        c.value = r.standard_normal(4)
        val = lp.solve(device=device)
        ref = linprog(c.value, bounds=[(-1, 1)] * 4, method="highs")
        (layer_key, (layer, _, _)), = lp._solve_layers.items()
        if key == "lp":
            first = layer
        rec[key] = dict(value=val, linprog=ref.fun, status=lp.status,
                        x_err=float(np.abs(x.value - ref.x).max()),
                        num_iters=lp.solver_stats.num_iters,
                        solve_time_ms=lp.solver_stats.solve_time * 1e3,
                        layer_device=str(layer.device))
        if layer.device.type != DEV or layer_key[1].type != DEV:
            fail(f"plain solve: the layer is on {layer.device}")
        if lp.status != "optimal" or abs(val - ref.fun) > 1e-6 \
                or rec[key]["x_err"] > 1e-6:
            fail(f"plain solve ({key}): {rec[key]}")
    if len(lp._solve_layers) != 1 or layer is not first:
        fail("plain solve: the re-solve built a second layer")

    def gp_problem():
        xg = ct.Variable((), pos=True)
        yg = ct.Variable((), pos=True)
        return ct.Problem(ct.Minimize(xg * yg + 1.0 / (xg * yg)),
                          [xg * yg <= 2.0, xg >= 0.5])

    gp = gp_problem()
    val = gp.solve(gp=True, device=device)
    val64 = gp_problem().solve(gp=True, device="cpu")
    rec["gp"] = dict(value=val, f64_cpu_value=val64, status=gp.status,
                     num_iters=gp.solver_stats.num_iters,
                     solve_time_ms=gp.solver_stats.solve_time * 1e3)
    if gp.status != "optimal" or abs(val - val64) > 1e-6 \
            or abs(val - 2.0) > 1e-6:
        fail(f"plain solve (gp): {rec['gp']}")
    z = ct.Variable(2)
    for key, prob, want, value in (
        ("infeasible", ct.Problem(ct.Minimize(ct.sum(z)), [z >= 1, z <= 0]),
         "infeasible", float("inf")),
        ("unbounded", ct.Problem(ct.Minimize(ct.sum(z)), [z <= 0]),
         "unbounded", float("-inf")),
    ):
        val = prob.solve(device=device)
        rec[key] = dict(value=val, status=prob.status)
        if prob.status != want or val != value or z.value is not None:
            fail(f"plain solve ({key}): {rec[key]}")
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    rec["launches"] = launches
    say("phase7", json.dumps(dict(layer="plain_solve", **rec)))
    return rec, launches


# ---------------------------------------------------------------- 8. serve

# the scheduler's box-QP items in each step, over two box_qp(50, 20)
# layers (a, b, a) that share one bucket: steps 1 and 2 fill capacity
# 1024 with the same composition and data (the warm start carries over),
# step 3 holds 896 rows at the same capacity (a new composition: cold)
SERVE_BOX_STEPS = ((384, 512, 128), (384, 512, 128), (320, 512, 64))
SERVE_N = 50
SERVE_B = 256        # each of sparsemax, csparsemax and relu
SERVE_LANES = 8      # lanes of each item held against f64 on the CPU
SERVE_SHARD_B = 1024  # the sharded box-QP call's batch
SERVE_LABELS = ("box_qp", "box_qp", "sparsemax", "csparsemax", "relu")


class BucketLog:
    """Wraps the bucket solver that solve_bucketed and the scheduler
    build (dist/bucketing.py's `_shared_core`) to record, for every
    bucket solve, its (n, m), its padded batch, whether it started warm,
    the launches of each kernel during it, and its statuses and
    iterations."""

    def __init__(self, counters):
        self.counters = counters
        self.records = []

    def __enter__(self):
        from cvxpylayers_tpu_torch.dist import bucketing

        self._core = core = bucketing._shared_core

        def logged_core(dims, n, *rest):
            solve = core(dims, n, *rest)

            def logged(P, q, A, b, x0, y0, s0):
                before = {k: mod.LAUNCHES for k, mod in self.counters.items()}
                warm = bool(x0.any())
                out = solve(P, q, A, b, x0, y0, s0)
                self.records.append(dict(
                    n=n, m=dims.total, B=q.shape[0], warm=warm,
                    launches={k: mod.LAUNCHES - before[k]
                              for k, mod in self.counters.items()},
                    status=out[3].detach(), iters=out[4].detach()))
                return out

            return logged

        bucketing._shared_core = logged_core
        return self

    def __exit__(self, *exc):
        from cvxpylayers_tpu_torch.dist import bucketing

        bucketing._shared_core = self._core


def serve_layers(device):
    """box_qp(50, 20) twice, sparsemax, csparsemax and relu at n=50."""
    from cvxpylayers_tpu_torch import models

    return (models.box_qp(SERVE_N, 20, device=device),
            models.box_qp(SERVE_N, 20, device=device),
            models.sparsemax(SERVE_N, device=device),
            models.csparsemax(SERVE_N, device=device),
            models.relu(SERVE_N, device=device))


def serve_host(r, sizes):
    """One step's host arrays, item by item: the box-QP items of `sizes`,
    sparsemax, csparsemax and relu at SERVE_B, one unbatched sparsemax
    instance."""
    host = [box_qp_params(r, B) for B in sizes]
    host += [[r.standard_normal((SERVE_B, SERVE_N))] for _ in range(3)]
    return host + [[r.standard_normal(SERVE_N)]]


def serve_items(layers, host, dtype, device=None, lanes=None, grad=False):
    """(layer, params) items over `host`: the owners are box a, b, a,
    sparsemax, csparsemax, relu, sparsemax; `lanes` keeps the first lanes
    of each batched item; `grad` makes the box-QP parameters leaves that
    require gradients."""
    box_a, box_b, spm, cspm, relu = layers
    owners = (box_a, box_b, box_a, spm, cspm, relu, spm)
    items = []
    for i, (layer, h) in enumerate(zip(owners, host)):
        if lanes is not None and i < 6:
            h = [a[:lanes] for a in h]
        params = to_dev(h, dtype, device)
        if grad and i < 3:
            params = [p.requires_grad_() for p in params]
        items.append((layer, tuple(params)))
    return items


def item_status(items, records):
    """Each item's lanes' statuses from the bucket records of one step
    (items of a bucket lie in submission order)."""
    by_m = {rec["m"]: rec for rec in records}
    offset = {}
    out = []
    for layer, params in items:
        m = layer.prog.m
        B = layer._parse_batch(params)[0] or 1
        off = offset.get(m, 0)
        out.append(by_m[m]["status"][off:off + B])
        offset[m] = off + B
    return out


def serve_phase(ct, counters):
    """bench.py's flagship box-QP and three zoo layers served by the
    bucket scheduler on the card (module docstring, phase 8). Returns the
    launches over the three steps and SERVE_SHARD_B box-QP instances
    that solved both through the scheduler and by a direct call."""
    from cvxpylayers_tpu_torch.dist import BucketScheduler, solve_bucketed
    from cvxpylayers_tpu_torch.dist.bucketing import structure_key
    from cvxpylayers_tpu_torch.layer.cvxpylayer import _settings_from_args
    from cvxpylayers_tpu_torch.utils import (
        PhaseTimer,
        problem_summary,
        trace_annotation,
    )

    layers = serve_layers(DEV)
    labels = {l.prog.m: name for l, name in zip(layers, SERVE_LABELS)}
    if len(labels) != 4:
        fail(f"serve: the zoo layers' row counts {sorted(labels)} do not "
             "tell the four buckets apart")
    r = np.random.default_rng(12)
    sched = BucketScheduler(solver_args=BOX_QP_ARGS)
    timer = PhaseTimer()
    steps = []
    for i, sizes in enumerate(SERVE_BOX_STEPS):
        if i == 1:  # the same composition and data as step 1
            host = steps[0]["host"]
        else:
            host = serve_host(r, sizes)
        items = serve_items(layers, host, torch.float32, grad=(i == 0))
        sync()
        for mod in counters.values():
            mod.LAUNCHES = 0
        outs = []
        with BucketLog(counters) as log, \
                timer.phase(f"step{i + 1}", block_on=outs):
            outs.extend(sched.step(items))
        launches = {k: mod.LAUNCHES for k, mod in counters.items()}
        steps.append(dict(host=host, items=items, outs=outs,
                          records=log.records, launches=launches,
                          ms=timer.totals[f"step{i + 1}"] * 1e3))
    box_key = structure_key(layers[0], _settings_from_args(
        layers[0]._base_settings, BOX_QP_ARGS))
    stats = sched.stats()[box_key]

    # ---- every bucket of every step: kernels, solved lanes, warm starts
    summary = []
    total_solved = total = 0
    for i, st in enumerate(steps):
        real = {"box_qp": sum(SERVE_BOX_STEPS[i]), "sparsemax": SERVE_B + 1,
                "csparsemax": SERVE_B, "relu": SERVE_B}
        if sorted(labels[rec["m"]] for rec in st["records"]) != sorted(real):
            fail(f"serve step {i + 1}: buckets "
                 f"{[labels.get(rec['m']) for rec in st['records']]}")
        for rec in st["records"]:
            name = labels[rec["m"]]
            Br = real[name]
            ok = int((rec["status"][:Br] == 0).sum())
            total_solved += ok
            total += Br
            rec.update(name=name, real=Br, solved=ok / Br,
                       iters_mean=float(rec["iters"][:Br].float().mean()))
            check_launches(f"serve step {i + 1} bucket {name}",
                           rec["launches"], "K1", ("K2",))
            # cold on step 1, warm on step 2, and on step 3 warm only
            # where the bucket's composition is unchanged
            want_warm = i == 1 or (i == 2 and name != "box_qp")
            if rec["warm"] != want_warm:
                fail(f"serve step {i + 1} bucket {name}: warm start "
                     f"{rec['warm']}, expected {want_warm}")
            summary.append(dict(
                step=i + 1, bucket=name, rows=Br, capacity=rec["B"],
                warm=rec["warm"], solved=rec["solved"],
                iters_mean=rec["iters_mean"],
                iters_max=int(rec["iters"][:Br].max()),
                launches=rec["launches"]))
    for rec1, rec2 in zip(sorted(steps[0]["records"], key=lambda d: d["m"]),
                          sorted(steps[1]["records"], key=lambda d: d["m"])):
        if rec2["iters_mean"] > rec1["iters_mean"]:
            fail(f"serve bucket {rec1['name']}: mean iterations "
                 f"{rec2['iters_mean']} warm against {rec1['iters_mean']} "
                 "cold")
    box3 = next(rec for rec in steps[2]["records"] if rec["name"] == "box_qp")
    rows = [sum(sizes) for sizes in SERVE_BOX_STEPS]
    cap = 1 << (max(rows) - 1).bit_length()
    # the reference's occupancy is over every flush: 1024 + 1024 + 896
    # rows of 3 x 1024 at full width; the last flush alone is 896 / 1024
    if (stats["capacity"] != cap or stats["compiles"] != 1
            or stats["flushes"] != 3
            or abs(stats["occupancy"] - sum(rows) / (3 * cap)) > 1e-12
            or (box3["real"], box3["B"]) != (rows[2], cap)):
        fail(f"serve: box-QP bucket stats {stats}, step 3 {box3['real']} "
             f"rows at capacity {box3['B']}")

    # ---- every item against a direct call of its own layer
    worst = 0.0
    both_frac = []
    pool = [[], [], []]
    for i, st in enumerate(steps):
        sched_status = item_status(st["items"], st["records"])
        for j, ((layer, params), outs, s_st) in enumerate(
                zip(st["items"], st["outs"], sched_status)):
            d_outs, d_st, _ = layer.solve_with_info(
                *(p.detach() for p in params), solver_args=BOX_QP_ARGS)
            # a lane left at MAX_ITERS carries no certified answer to
            # agree with (csparsemax leaves ~1.6 % there at 50 iterations
            # on either route): hold the lanes solved on both
            both = (s_st.reshape(-1) == 0) & (d_st.reshape(-1) == 0)
            both_frac.append(float(both.float().mean()))
            if not bool(both.any()):
                fail(f"serve step {i + 1} item {j}: no lane solved on both "
                     "routes")
            x = outs[0].detach().reshape(both.shape[0], -1)
            xd = d_outs[0].reshape(both.shape[0], -1)
            worst = max(worst, float((x - xd)[both].abs().max()))
            if j < 3 and i != 1:  # box-QP instances for the sharded call
                keep = both.cpu().numpy()
                for k in range(3):
                    pool[k].append(st["host"][j][k][keep])
    if worst > 2e-3:
        fail(f"serve: scheduler against direct calls {worst:.3e}")
    pool = [np.concatenate(a)[:SERVE_SHARD_B] for a in pool]
    if pool[0].shape[0] != SERVE_SHARD_B:
        fail(f"serve: only {pool[0].shape[0]} box-QP lanes solved both ways")

    # ---- 8 lanes of each item of step 1 against f64 on the CPU, where
    # both solved
    cpu_items = serve_items(serve_layers("cpu"), steps[0]["host"],
                            torch.float64, "cpu", lanes=SERVE_LANES)
    with BucketLog({}) as log64:
        ref = solve_bucketed(cpu_items, solver_args=BOX_QP_ARGS)
    f64_worst = 0.0
    f64_lanes = 0
    for outs, outs64, st32, st64 in zip(
            steps[0]["outs"], ref,
            item_status(steps[0]["items"], steps[0]["records"]),
            item_status(cpu_items, log64.records)):
        k = st64.shape[0]
        both = ((st32[:k].cpu() == 0) & (st64 == 0)).reshape(-1)
        x = outs[0].detach().reshape(-1, SERVE_N)[:k].double().cpu()
        gap = (x - outs64[0].reshape(k, -1)).abs().max(dim=1).values
        f64_lanes += int(both.sum())
        if bool(both.any()):
            f64_worst = max(f64_worst, float(gap[both].max()))
    if f64_worst > 2e-3:
        fail(f"serve: f32 on the card against f64 on the CPU {f64_worst:.3e}")

    # ---- the gradient of step 1's box-QP outputs against direct calls
    rg = np.random.default_rng(13)
    weights = [torch.as_tensor(rg.standard_normal((B, SERVE_N)),
                               dtype=torch.float32, device=DEV)
               for B in SERVE_BOX_STEPS[0]]
    box_items = steps[0]["items"][:3]
    sum((w * outs[0]).sum() for w, outs in
        zip(weights, steps[0]["outs"][:3])).backward()
    grad_worst = 0.0
    for (layer, params), w, h in zip(box_items, weights, steps[0]["host"]):
        leaves = [p.requires_grad_() for p in to_dev(h, torch.float32)]
        (x,), _, _ = layer.solve_with_info(*leaves, solver_args=BOX_QP_ARGS)
        (w * x).sum().backward()
        for p, q_ in zip(params, leaves):
            g, gd = p.grad[:SERVE_LANES], q_.grad[:SERVE_LANES]
            scale = max(float(gd.abs().max()), 1e-3)
            grad_worst = max(grad_worst, float((g - gd).abs().max()) / scale)
    if grad_worst > 1e-2:
        fail(f"serve: gradient through the scheduler against direct calls "
             f"{grad_worst:.3e}")

    # ---- one more step of step 3's composition, profiled, annotated
    items3 = [(layer, tuple(p.detach() for p in params))
              for layer, params in steps[2]["items"]]
    with trace_annotation("serve_step"):
        sched.step(items3)  # warm-up of the annotation's own path
    sync()

    def annotated():
        with trace_annotation("serve_step"):
            sched.step(items3)

    total_us, count, top, prof = kernel_times(annotated, host=True)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    if "serve_step" not in names:
        fail("serve: trace_annotation's range is not in the profiler trace")
    if DEV == "cuda" and count == 0:
        fail("serve: the profiled step ran no device kernel")
    say(f"profile (serve step 3's composition): {count} device kernels "
        f"for {total_us / 1e3:.3f} ms of device time; top (us, name, "
        "count):")
    for us, key, n_calls in top:
        say(f"  {us:10.1f}  {key[:90]}  x{n_calls}")
    for name, layer in zoo_layers():
        say("zoo", name, json.dumps(problem_summary(layer)))
    say("serve", json.dumps(dict(
        B_per_step=[sum(s) + 3 * SERVE_B + 1 for s in SERVE_BOX_STEPS],
        ms_per_step=[st["ms"] for st in steps],
        phase_timer=timer.summary().splitlines(),
        solved_fraction=total_solved / total,
        buckets=summary, box_qp_stats=stats,
        last_flush_occupancy=box3["real"] / box3["B"],
        max_abs_diff_vs_direct=worst,
        solved_on_both_routes_per_item=both_frac,
        max_abs_diff_vs_f64_cpu=f64_worst,
        f64_lanes_solved_on_both=f64_lanes,
        grad_rel_err_vs_direct=grad_worst,
        profiled_step=dict(device_kernels=count, device_ms=total_us / 1e3),
        launches_per_step=[st["launches"] for st in steps])))
    if total_solved / total < 0.99:
        fail(f"serve: solved fraction {total_solved / total}")
    launches = {k: sum(st["launches"][k] for st in steps) for k in counters}
    return launches, pool


def zoo_layers():
    """Every zoo factory at n=50 on the card (exp-cone layers are built,
    not solved: their layer code is phase 7's exp-cone path)."""
    from cvxpylayers_tpu_torch import models

    return [
        ("relu", models.relu(50, device=DEV)),
        ("sigmoid", models.sigmoid(50, device=DEV)),
        ("softmax", models.softmax(50, device=DEV)),
        ("sparsemax", models.sparsemax(50, device=DEV)),
        ("csoftmax", models.csoftmax(50, device=DEV)),
        ("csparsemax", models.csparsemax(50, device=DEV)),
        ("lml", models.lml(50, 5, device=DEV)),
        ("box_qp", models.box_qp(50, 20, device=DEV)),
        ("ellipsoid_projection", models.ellipsoid_projection(50,
                                                             device=DEV)),
        ("markowitz", models.markowitz(50, device=DEV)),
        ("logistic_regression_layer",
         models.logistic_regression_layer(10, 50, device=DEV)),
    ]


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_dist_phase(ct, counters, pool):
    """The distributed runtime on one card: a world of one rank (NCCL on
    the card), the global mesh, a global batch round trip, the sharded
    box-QP call at B=1024 against the direct call (outputs and gradient)
    and solve_bucketed over the mesh. Returns the sharded call's
    launches."""
    import torch.distributed as tdist

    from cvxpylayers_tpu_torch import models
    from cvxpylayers_tpu_torch.dist import (
        global_batch,
        host_local_results,
        initialize,
        make_global_mesh,
        solve_bucketed,
    )
    from cvxpylayers_tpu_torch.parallel import shard_layer_call

    if not initialize(f"127.0.0.1:{free_port()}", 1, 0, device=DEV):
        fail("dist: initialize started no process group")
    try:
        backend = tdist.get_backend()
        if backend != ("nccl" if DEV == "cuda" else "gloo"):
            fail(f"dist: backend {backend} on {DEV}")
        mesh = make_global_mesh(device_type=DEV)
        local = np.arange(24, dtype=np.float32).reshape(8, 3)
        g = global_batch(local, mesh)
        if (tuple(g.shape) != (8, 3)
                or not np.array_equal(host_local_results(g), local)
                or not np.array_equal(g.full_tensor().cpu().numpy(), local)):
            fail("dist: global_batch / host_local_results round trip")

        box = models.box_qp(SERVE_N, 20, device=DEV)
        w = torch.as_tensor(np.random.default_rng(14).standard_normal(
            (pool[0].shape[0], SERVE_N)), dtype=torch.float32, device=DEV)

        def run(call):
            leaves = [p.requires_grad_() for p in to_dev(pool, torch.float32)]
            sync()
            for mod in counters.values():
                mod.LAUNCHES = 0
            t0 = time.perf_counter()
            (x,) = call(*leaves, solver_args=BOX_QP_ARGS)
            (w * x).sum().backward()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: mod.LAUNCHES for k, mod in counters.items()}
            return x.detach(), [p.grad for p in leaves], launches, ms

        xs, gs, launches, ms_shard = run(shard_layer_call(box, mesh))
        xd, gd, _, ms_direct = run(box)
        dx = float((xs - xd).abs().max())
        dg = max(float((a - b).abs().max()) for a, b in zip(gs, gd))
        check_launches("dist sharded box-QP", launches, "K1", ("K2",))
        # a world of one rank is a plain call: the same solve
        if dx > 1e-6 or dg > 1e-6:
            fail(f"dist: sharded call against direct call: outputs "
                 f"{dx:.3e}, gradients {dg:.3e}")
        spm = models.sparsemax(SERVE_N, device=DEV)
        items = [(box, tuple(to_dev([a[:256] for a in pool], torch.float32))),
                 (spm, tuple(to_dev([pool[0][:64]], torch.float32)))]
        res = solve_bucketed(items, solver_args=BOX_QP_ARGS, mesh=mesh)
        ref = solve_bucketed(items, solver_args=BOX_QP_ARGS)
        db = max(float((a[0] - b[0]).abs().max()) for a, b in zip(res, ref))
        if db > 1e-6:
            fail(f"dist: solve_bucketed over the mesh against no mesh {db:.3e}")
        say("dist", json.dumps(dict(
            backend=backend, world=tdist.get_world_size(),
            mesh=str(mesh), B=int(pool[0].shape[0]),
            sharded_vs_direct_out=dx, sharded_vs_direct_grad=dg,
            ms_fwd_bwd_sharded=ms_shard, ms_fwd_bwd_direct=ms_direct,
            bucketed_mesh_vs_plain=db, launches=launches)))
    finally:
        tdist.destroy_process_group()
    return launches


def harness_phase(root, args=("--batch", "1024", "--n", "20", "--steps",
                              "3", "--sweep-batch")):
    """The scaling harness in its own process on the card: every solves/s
    above 0."""
    cmd = [sys.executable, "-m", "cvxpylayers_tpu_torch.dist.harness",
           *args] + (["--cpu"] if DEV != "cuda" else [])
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=root, env=env)
    if res.returncode != 0:
        fail(f"harness exited {res.returncode}: {res.stderr[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        fail(f"harness printed no result: {res.stdout[-2000:]}")
    out = json.loads(lines[-1])
    rates = [v for k, v in out.items() if k.startswith("solves_per_s")
             and not isinstance(v, dict)]
    rates += list(out.get("solves_per_s_1host_by_batch", {}).values())
    if not rates or min(rates) <= 0:
        fail(f"harness: a rate is not above 0: {out}")
    say("harness", json.dumps(out))
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
    t0 = time.perf_counter()
    k1, k1_shapes = kernel_phase(cuda_admm)
    k2, k2_shapes = qr_kernel_phase(cuda_linalg)
    say(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    # ---- 3. the paths at full width, each with its counts from 0
    counters = {"K1": cuda_admm, "K2": cuda_linalg}
    t0 = time.perf_counter()
    launches = {}
    for name, path in PATHS.items():
        t1 = time.perf_counter()
        launches[name] = main_path_phase(ct, counters, path)[1]
        say(f"path {name}: {time.perf_counter() - t1:.1f} s")
    say(f"phase main: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name in PROFILED:
        t1 = time.perf_counter()
        profile_phase(ct, PATHS[name])
        say(f"profile {name}: {time.perf_counter() - t1:.1f} s")
    say(f"phase profile: {time.perf_counter() - t0:.1f} s")

    # ---- 4. gradients through the layer
    t0 = time.perf_counter()
    for name in PROFILED:
        t1 = time.perf_counter()
        gradient_phase(ct, counters, PATHS[name])
        say(f"grad {name}: {time.perf_counter() - t1:.1f} s")
    say(f"phase grad: {time.perf_counter() - t0:.1f} s")

    # ---- 5. small layers
    t0 = time.perf_counter()
    small_layers_phase(ct, counters)
    say(f"phase small: {time.perf_counter() - t0:.1f} s")

    # ---- 6. the sparse route and the forward-mode derivative, each path
    # with its counts from 0
    t0 = time.perf_counter()
    for name, path in OT_PATHS.items():
        t1 = time.perf_counter()
        launches[name] = ot_phase(ct, counters, path)[1]
        say(f"path {name}: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    launches["box_qp_jvp"] = box_qp_jvp_phase(ct, counters)[1]
    say(f"path box_qp_jvp: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    small_new_routes_phase(ct, counters)
    say(f"small new routes: {time.perf_counter() - t1:.1f} s")
    say(f"phase sparse_jvp: {time.perf_counter() - t0:.1f} s")

    # ---- 7. geometric programs, cone duals, the plain solve and the
    # structured atoms, each with its counts from 0
    t0 = time.perf_counter()
    for name, path in GP_PATHS.items():
        t1 = time.perf_counter()
        launches[name] = main_path_phase(ct, counters, path)[1]
        profile_phase(ct, path)
        gradient_phase(ct, counters, GP_GRAD_PATHS[name])
        say(f"path {name}: {time.perf_counter() - t1:.1f} s")
    for name, build, params, args, grad_out, shapes in DUAL_LAYERS:
        t1 = time.perf_counter()
        launches[name] = layer_against_f64(ct, counters, name, build,
                                           params, args, grad_out,
                                           shapes)[1]
        say(f"duals {name}: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    launches["plain_solve"] = plain_solve_phase(ct, counters)[1]
    say(f"plain solve: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    launches["structured"] = layer_against_f64(
        ct, counters, "structured", structured_layer, structured_params,
        STRUCTURED_ARGS, None)[1]
    say(f"structured: {time.perf_counter() - t1:.1f} s")
    say(f"phase gp_duals_solve: {time.perf_counter() - t0:.1f} s")

    # ---- 8. the bucket scheduler serving zoo layers, profiling, the
    # distributed runtime on one card and the scaling harness, each with
    # its counts from 0
    t0 = time.perf_counter()
    launches["serve"], pool = serve_phase(ct, counters)
    say(f"serve: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    launches["serve_dist"] = serve_dist_phase(ct, counters, pool)
    say(f"dist: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    harness_phase(root)
    say(f"harness: {time.perf_counter() - t1:.1f} s")
    say(f"phase serve: {time.perf_counter() - t0:.1f} s")
    if any(m == "jax" or m.startswith("jax.") or m == "cvxpylayers_tpu"
           or m.startswith("cvxpylayers_tpu.") for m in sys.modules):
        fail("the port's dist, models or utils imported JAX or the JAX "
             "package")

    # each kernel's launches on the main path of its slice and on every
    # path a later slice added (the ADMM general-cone paths launch
    # neither; the Markowitz IPM paths launch K2; box_qp_jvp launches K1,
    # the OT paths neither; the GP, dual and structured layers neither;
    # the plain solve's f64 LP launches K1; every bucket of the serve
    # phase and the sharded box-QP launch K1)
    later = (RESCUE_PATHS + CONE_PATHS + IPM_CONE_PATHS + tuple(OT_PATHS)
             + ("box_qp_jvp",) + tuple(GP_PATHS)
             + tuple(d[0] for d in DUAL_LAYERS)
             + ("plain_solve", "structured", "serve", "serve_dist"))
    k1_launches = sum(launches[p]["K1"] for p in ("admm",) + later)
    k2_launches = sum(launches[p]["K2"] for p in ("ipm",) + later)
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
