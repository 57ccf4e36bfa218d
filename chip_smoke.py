#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port, cvxpylayers_tpu_torch.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. build   compile every CUDA kernel of the port from csrc/, all at once
  2. kernels hold each kernel against its plain PyTorch version on the
             card, at the main path's shapes and at the edge shapes
             (ragged batch, equality rows, beyond shared memory); time the
             kernel, the plain version and the card's bound
  3. main    the OptNet box-QP projection layer (n=50, G 20x50, B=1024,
             f32) through CvxpyLayer(...)(*params): solved fraction,
             kernel launches, ms per call with fresh inputs, and agreement
             of the first 16 instances with the port's own f64 CPU run
  4. small   the simplex-projection and LAD layers at B=256

Imports nothing of JAX or of cvxpylayers_tpu. The second-to-last lines
are the card's name and power limit and the per-kernel JSON record; the
last line is {"ok": true, "device": {...}}.
"""

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
    dev = "cuda"
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


def kernel_phase(cuda_admm):
    """K1 against its plain version. Tolerance: the kernel may differ from
    the plain version by at most four times the plain version's own
    rounding error at its dtype (its distance from the same loop in f64
    on the same inputs), and by at least 1e-5 (f32) / 1e-12 (f64) of the
    output's scale, since the two sum the matvecs in another order."""
    cases = [
        ("main path box-QP f32", 1024, 50, 120, 0, torch.float32),
        ("main path box-QP f64", 1024, 50, 120, 0, torch.float64),
        ("ragged B, equality rows f32", 1000, 50, 120, 7, torch.float32),
        ("beyond shared memory f32", 256, 120, 400, 5, torch.float32),
        ("beyond shared memory f64", 256, 120, 400, 5, torch.float64),
    ]
    iters = 50
    shapes = []
    main = None
    for label, B, n, m, n_zero, dtype in cases:
        a = epoch_inputs(B, n, m, n_zero, dtype, seed=B + n_zero)
        kw = dict(n_zero=n_zero, iters=iters, sigma=1e-6, alpha=1.6)
        in_shared, smem = cuda_admm.epoch_plan(n, m, dtype, a["q"].device)
        if label.startswith("beyond") and in_shared:
            fail(f"{label}: expected the device-memory branch")
        if not label.startswith("beyond") and not in_shared:
            fail(f"{label}: expected the shared-memory branch")
        out = cuda_admm.polyhedral_inner_epoch(*(a[k] for k in _ORDER), **kw)
        torch.cuda.synchronize()
        ref = cuda_admm.polyhedral_inner_epoch_plain(
            *(a[k] for k in _ORDER), **kw)
        torch.cuda.synchronize()
        ref64 = cuda_admm.polyhedral_inner_epoch_plain(
            *(a[k].double() for k in _ORDER), **kw)
        torch.cuda.synchronize()
        for o in out:
            if not bool(torch.isfinite(o).all()):
                fail(f"{label}: non-finite kernel output")
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        noise = max(float((r.double() - r64).abs().max())
                    for r, r64 in zip(ref, ref64))
        scale = max(float(r.abs().max()) for r in ref)
        floor = (1e-5 if dtype == torch.float32 else 1e-12) * scale
        tol = max(4.0 * noise, floor)
        ok = err <= tol
        ms = time_cuda(lambda: cuda_admm.polyhedral_inner_epoch(
            *(a[k] for k in _ORDER), **kw), reps=20, warmup=3)
        plain_ms = time_cuda(lambda: cuda_admm.polyhedral_inner_epoch_plain(
            *(a[k] for k in _ORDER), **kw), reps=3)
        elem = torch.empty((), dtype=dtype).element_size()
        bound, bound_by = epoch_bound_ms(B, n, m, iters, elem)
        rec = dict(shape=label, B=B, n=n, m=m, n_zero=n_zero, iters=iters,
                   dtype=str(dtype).replace("torch.", ""),
                   branch="shared" if in_shared else "device-memory",
                   smem_bytes=smem, max_abs_err=err, tol=tol,
                   plain_f64_noise=noise, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by)
        say("kernel", json.dumps(rec))
        if not ok:
            fail(f"{label}: kernel vs plain max abs err {err:.3e} > "
                 f"tol {tol:.3e}")
        shapes.append(rec)
        if main is None:
            main = rec
    return main, shapes


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


def simplex_layer(ct, device, n=20):
    x = ct.Variable(n)
    v = ct.Parameter(n)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x - v)),
                      [ct.sum(x) == 1, x >= 0])
    return ct.CvxpyLayer(prob, parameters=[v], variables=[x], device=device)


def lad_layer(ct, device, n=2, m=3):
    x = ct.Variable(n, nonneg=True)
    A = ct.Parameter((m, n))
    b = ct.Parameter(m)
    prob = ct.Problem(ct.Minimize(0.5 * ct.pnorm(A @ x - b, 1)))
    return ct.CvxpyLayer(prob, parameters=[A, b], variables=[x],
                         device=device)


def to_dev(arrs, dtype, device="cuda"):
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs]


def main_path_phase(ct, cuda_admm, calls=7):
    r = np.random.default_rng(0)
    B = 1024
    layer = box_qp_layer(ct, "cuda")
    # fresh inputs for every call, made up front and moved in bulk
    host = [box_qp_params(r, B) for _ in range(calls + 1)]
    inputs = [to_dev(h, torch.float32) for h in host]
    torch.cuda.synchronize()

    cuda_admm.LAUNCHES = 0
    times = []
    solved = []
    first = None
    for i, params in enumerate(inputs):
        t0 = time.perf_counter()
        (x,), status, iters = layer.solve_with_info(
            *params, solver_args=BOX_QP_ARGS)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if i == 0:
            first = (x, status, iters)
        else:  # call 0 is the warm-up (allocator, library load)
            times.append(dt)
        solved.append(float((status == 0).float().mean()))
    launches = cuda_admm.LAUNCHES
    if launches == 0:
        fail("main path: K1 was never launched")

    x, status, iters = first
    if tuple(x.shape) != (B, 50) or not bool(torch.isfinite(x).all()):
        fail(f"main path: bad output {tuple(x.shape)}")
    # reference: the port's own f64 CPU run on the first 16 instances
    k = 16
    cpu_layer = box_qp_layer(ct, "cpu")
    (x64,), st64, _ = cpu_layer.solve_with_info(
        *to_dev([h[:k] for h in host[0]], torch.float64, "cpu"),
        solver_args=BOX_QP_ARGS)
    diff = float((x[:k].double().cpu() - x64).abs().max())
    res = dict(
        layer="box_qp", n=50, m_ineq=20, m=layer.prog.m, B=B,
        dtype="float32", solver_args=BOX_QP_ARGS, calls=len(inputs),
        solved_fraction_first=solved[0],
        solved_fraction_min=min(solved),
        iters_max=int(iters.max()),
        launches_before=0, launches_after=launches,
        launches_per_call=launches / len(inputs),
        median_ms_per_call=statistics.median(times),
        ms_per_call=times,
        solves_per_s=B / statistics.median(times) * 1e3,
        max_abs_diff_vs_f64_cpu_first16=diff,
        f64_cpu_solved_first16=float((st64 == 0).double().mean()),
    )
    say("main", json.dumps(res))
    if min(solved) < 0.99:
        fail(f"main path: solved fraction {min(solved)} < 0.99")
    # f32 at eps 1e-4 against f64: the solution agrees to ~1e-4, and
    # 2e-3 leaves room for the loosest certified lanes
    if diff > 2e-3:
        fail(f"main path: f32 cuda vs f64 cpu max abs diff {diff:.3e}")
    return res, launches


def device_profile(layer, params, args):
    """Device time by kernel name for one main-path call."""
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


def small_layers_phase(ct, cuda_admm):
    r = np.random.default_rng(1)
    B = 256
    out = {}
    for name, build, params, args in (
        ("simplex", simplex_layer, [r.standard_normal((B, 20))],
         SIMPLEX_ARGS),
        ("lad", lad_layer, [r.standard_normal((B, 3, 2)),
                            r.standard_normal((B, 3))], LAD_ARGS),
    ):
        layer = build(ct, "cuda")
        dev = to_dev(params, torch.float32)
        cuda_admm.LAUNCHES = 0
        (x,), status, _ = layer.solve_with_info(*dev, solver_args=args)
        torch.cuda.synchronize()
        launches = cuda_admm.LAUNCHES
        solved = float((status == 0).float().mean())
        if launches == 0:
            fail(f"{name}: K1 was never launched")
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
        rec = dict(layer=name, B=B, dtype="float32", solved_fraction=solved,
                   launches=launches,
                   max_abs_diff_vs_f64_cpu_solved_lanes=diff)
        say("small", json.dumps(rec))
        if diff is not None and diff > 2e-3:
            fail(f"{name}: f32 cuda vs f64 cpu max abs diff {diff:.3e}")
        out[name] = rec
    return out


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
    from cvxpylayers_tpu_torch.solver import cuda_admm

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

    # ---- 3. main path at full width
    _, launches = main_path_phase(ct, cuda_admm)
    layer = box_qp_layer(ct, "cuda")
    prof_params = to_dev(box_qp_params(np.random.default_rng(7), 1024),
                         torch.float32)
    total_us, count, top = device_profile(layer, prof_params, BOX_QP_ARGS)
    say(f"profile: one main-path call runs {count} device kernels for "
        f"{total_us / 1e3:.3f} ms of device time; top (us, name, count):")
    for us, key, count in top:
        say(f"  {us:10.1f}  {key[:90]}  x{count}")

    # ---- 4. small layers
    small_layers_phase(ct, cuda_admm)

    kernels = [dict(
        name="admm_polyhedral_epoch", route="cuda",
        source="cvxpylayers_tpu_torch/csrc/admm_epoch.cu",
        replaces="cvxpylayers_tpu/solver/pallas_admm.py:85",
        launches=launches,
        max_abs_err=k1["max_abs_err"], tol=k1["tol"],
        ms=k1["ms"], kernel_ms=k1["ms"], plain_ms=k1["plain_ms"],
        bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=None,
        shape=f"B={k1['B']} n={k1['n']} m={k1['m']} iters={k1['iters']} "
              f"{k1['dtype']}",
        shapes_within_tol=len(k1_shapes),
    )]
    say(f"card: {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
