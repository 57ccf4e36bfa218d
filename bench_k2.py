#!/usr/bin/env python3
"""Kernel K2 (cvxpylayers_tpu_torch/csrc/house_qr.cu) on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 bench_k2.py [--old PATH] [--out FILE]

Records, one JSON line each (also written to FILE when given):
  sweep      K2 at each shape chip_smoke.py runs, with 32, 64, 128 and 256
             threads per instance; the wrapper's own choice is marked
  wrapper    the same launch through cuda_linalg.qr_r, to show the host's
             share of a timed call
  staircase  K2 at the IPM main shape (m=170, n=50, f32) over batch sizes
             around multiples of 132 SMs
  ab         with --old, K2 against an older source of the same kernel
             with the earlier C interface (house_qr_r_plan and an
             8-argument launch), timed in turns (old, new, new, old)
  clocks     with --clocks, cycles by phase of the column step: an
             instrumented copy of the source is written to and built in
             _scratch/k2_clocks/ (never in the package), where thread 0 of
             block 0 adds up clock64() deltas for staging, the step's
             scalars, the loads of u, the column work of its warp, the
             step's barrier and the write-out; one launch each at
             B = 132, 792 and 1024

Every variant is held against the plain version through R'R (the
tolerance of chip_smoke.py's K2 phase) before it is timed. CUDA events,
20 launches after 3 warm-up launches.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    fail, qr_bound_ms, qr_inputs, say, time_cuda)

SHAPES = [  # (B, m, n, dtype), as chip_smoke.py's K2 phase runs them
    (1024, 170, 50, torch.float32),
    (1024, 170, 50, torch.float64),
    (1000, 40, 20, torch.float32),
    (64, 560, 160, torch.float32),
]
THREADS = (32, 64, 128, 256)
STAIRS = (132, 264, 396, 528, 660, 792, 924, 1024, 1056, 1188, 1584)


def check(R, Rp, M, label):
    """R'R against the plain version's, at chip_smoke.py's tolerance."""
    G = M.double().mT @ M.double()
    Gk = R.double().mT @ R.double()
    Gp = Rp.double().mT @ Rp.double()
    err = float((Gk - Gp).abs().max())
    floor = (1e-5 if M.dtype == torch.float32 else 1e-12) * float(
        G.abs().max())
    tol = max(4.0 * float((Gp - G).abs().max()), floor)
    if not bool(torch.isfinite(R).all()) or err > tol:
        fail(f"{label}: R'R error {err:.3e} > tol {tol:.3e}")
    return err


class NewK2:
    """The package's K2 (or a library with its C interface), launched with
    a chosen thread count."""

    def __init__(self, cuda_linalg, lib=None):
        self.cl = cuda_linalg
        self.lib = lib or cuda_linalg._library()
        self.optin = self.lib.house_qr_smem_optin(0)

    def __call__(self, M, threads):
        B, m, n = M.shape
        plan = self.cl.launch_plan(m, n, M.element_size(), self.optin,
                                   threads)
        R = torch.empty(B, n, n, dtype=M.dtype, device=M.device)
        work = torch.empty(0 if plan.in_shared else B * m * n,
                           dtype=M.dtype, device=M.device)
        fn = (self.lib.house_qr_r_f32 if M.dtype == torch.float32
              else self.lib.house_qr_r_f64)
        err = fn(M.data_ptr(), R.data_ptr(), work.data_ptr(), B, m, n,
                 plan.threads, plan.smem_bytes, int(plan.in_shared),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"K2 launch failed: cudaError {err}")
        return R


class OldK2:
    """An older house_qr.cu with the earlier C interface."""

    def __init__(self, src, build_dir):
        from cvxpylayers_tpu_torch import cuda_build

        os.makedirs(build_dir, exist_ok=True)
        so = os.path.join(build_dir, "libhouse_qr_old.so")
        subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                        "-o", so, src], check=True)
        lib = ctypes.CDLL(so)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.house_qr_r_f32, lib.house_qr_r_f64):
            fn.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
            fn.restype = i32
        lib.house_qr_r_plan.argtypes = [
            i32, i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)]
        lib.house_qr_r_plan.restype = i32
        self.lib = lib

    def __call__(self, M):
        B, m, n = M.shape
        smem = ctypes.c_longlong(0)
        in_shared = self.lib.house_qr_r_plan(m, n, M.element_size(), 0,
                                             ctypes.byref(smem))
        if in_shared < 0:
            fail(f"old house_qr_r_plan: {in_shared}")
        R = torch.empty(B, n, n, dtype=M.dtype, device=M.device)
        work = torch.empty(0 if in_shared else B * m * n, dtype=M.dtype,
                           device=M.device)
        fn = (self.lib.house_qr_r_f32 if M.dtype == torch.float32
              else self.lib.house_qr_r_f64)
        err = fn(M.data_ptr(), R.data_ptr(), work.data_ptr(), B, m, n,
                 in_shared, torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"old K2 launch failed: cudaError {err}")
        return R


# (text in csrc/house_qr.cu, text inserted after it) for the clocks copy
_PROBES = [
    ("#include <stddef.h>\n",
     "__device__ unsigned long long k2_clk[8];\n"
     "#define K2_STAMP(i) if (probe_) { long long t1_ = clock64(); "
     "atomicAdd(&k2_clk[i], (unsigned long long)(t1_ - t_)); t_ = t1_; }\n"),
    ("  const T tiny = T(1e-30);\n",
     "  const bool probe_ = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "  long long t_ = clock64();\n"),
    ("  if constexpr (kShared) __pipeline_wait_prior(0);\n  __syncthreads();\n",
     "  K2_STAMP(0)\n"),
    ("    if (j + 1 == n) break;\n", "    K2_STAMP(1)\n"),
    ("    u[0] = (lane == 0) ? uj : u[0];\n", "    K2_STAMP(2)\n"),
    ("    if (tid == 0) nrm[(j + 1) & 1] = sq;\n    __syncthreads();\n",
     None),
    ("      ++r;\n    }\n  }\n}\n", None),
]
_CLOCK_API = """
extern "C" int house_qr_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long zero[8] = {0};
    return (int)cudaMemcpyToSymbol(k2_clk, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, k2_clk, sizeof(k2_clk));
}
"""
PHASES = ("staging", "scalars", "u_loads", "columns", "barrier",
          "last_step_and_writeout")


def clocks_library(build_dir):
    """Build the instrumented copy of csrc/house_qr.cu described above."""
    from cvxpylayers_tpu_torch import cuda_build

    src = (cuda_build.SRC_DIR / "house_qr.cu").read_text()
    for anchor, insert in _PROBES:
        if src.count(anchor) != 1:
            fail(f"--clocks: anchor not found once in house_qr.cu: {anchor!r}")
        if insert is None and "__syncthreads" in anchor:
            src = src.replace(anchor, anchor.replace(
                "    __syncthreads();\n",
                "    K2_STAMP(3)\n    __syncthreads();\n    K2_STAMP(4)\n"))
            continue
        if insert is None:  # the end of the kernel: stamp before its brace
            src = src.replace(
                anchor, anchor[:-2] + f"  K2_STAMP({len(PHASES) - 1})\n}}\n")
        else:
            src = src.replace(anchor, anchor + insert)
    src += _CLOCK_API
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, "house_qr_clocks.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(build_dir, "libhouse_qr_clocks.so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    so, path], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.house_qr_r_f32, lib.house_qr_r_f64):
        fn.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
        fn.restype = i32
    lib.house_qr_smem_optin.argtypes = [i32]
    lib.house_qr_smem_optin.restype = i32
    lib.house_qr_clocks.argtypes = [ptr, i32]
    lib.house_qr_clocks.restype = i32
    return lib


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="an older house_qr.cu to time against")
    ap.add_argument("--out", help="also write the records to this file")
    ap.add_argument("--clocks", action="store_true",
                    help="also the cycles by phase of an instrumented copy")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("bench_k2.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from cvxpylayers_tpu_torch.solver import cuda_linalg

    records = []

    def emit(kind, **rec):
        rec = dict(record=kind, card=smi, **rec)
        records.append(rec)
        say(json.dumps(rec))

    from cvxpylayers_tpu_torch import cuda_build

    new = NewK2(cuda_linalg)
    for line in cuda_build.BUILD_LOGS.get("house_qr", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"ptxas: {line.strip()}")
    old = (OldK2(args.old, os.path.join(ROOT, "_scratch", "k2_old_build"))
           if args.old else None)
    for B, m, n, dtype in SHAPES:
        M = qr_inputs(B, m, n, dtype, seed=B + m)
        Rp = cuda_linalg.house_qr_r_plain(M)
        label = f"({B}, {m}, {n}) {dtype_name(dtype)}"
        chosen = cuda_linalg.qr_plan(m, n, dtype, M.device)
        bound, bound_by = qr_bound_ms(B, m, n, M.element_size())
        for t in THREADS:
            err = check(new(M, t), Rp, M, f"{label} threads={t}")
            ms = time_cuda(lambda: new(M, t), reps=20, warmup=3)
            emit("sweep", B=B, m=m, n=n, dtype=dtype_name(dtype), threads=t,
                 chosen=t == chosen.threads, in_shared=chosen.in_shared,
                 ms=ms, bound_ms=bound, bound_by=bound_by, gram_err=err)
        ms = time_cuda(lambda: cuda_linalg.qr_r(M), reps=20, warmup=3)
        emit("wrapper", B=B, m=m, n=n, dtype=dtype_name(dtype),
             threads=chosen.threads, ms=ms)
        if old is not None and B >= 1000:
            check(old(M), Rp, M, f"{label} old")
            turns = []
            for which in ("old", "new", "new", "old"):
                fn = ((lambda: old(M)) if which == "old"
                      else (lambda: new(M, chosen.threads)))
                turns.append((which, time_cuda(fn, reps=20, warmup=3)))
            o = [t for w, t in turns if w == "old"]
            w = [t for w, t in turns if w == "new"]
            emit("ab", B=B, m=m, n=n, dtype=dtype_name(dtype),
                 threads=chosen.threads, old_ms=o, new_ms=w,
                 speedup=(sum(o) / sum(w)))
        del M, Rp

    m, n = 170, 50
    t = cuda_linalg.qr_plan(m, n, torch.float32, "cuda").threads
    for B in STAIRS:
        M = qr_inputs(B, m, n, torch.float32, seed=B)
        ms = time_cuda(lambda: new(M, t), reps=20, warmup=3)
        emit("staircase", B=B, m=m, n=n, dtype="float32", threads=t, ms=ms,
             us_per_instance=ms * 1e3 / B)
    if args.clocks:
        lib = clocks_library(os.path.join(ROOT, "_scratch", "k2_clocks"))
        probe = NewK2(cuda_linalg, lib)
        buf = (ctypes.c_ulonglong * 8)()
        for B in (132, 792, 1024):
            M = qr_inputs(B, m, n, torch.float32, seed=B)
            check(probe(M, t), cuda_linalg.house_qr_r_plain(M), M,
                  f"clocks copy B={B}")
            torch.cuda.synchronize()
            lib.house_qr_clocks(buf, 1)
            probe(M, t)
            torch.cuda.synchronize()
            lib.house_qr_clocks(buf, 0)
            cyc = dict(zip(PHASES, list(buf)[:len(PHASES)]))
            total = sum(cyc.values())
            emit("clocks", B=B, m=m, n=n, dtype="float32", threads=t,
                 cycles=cyc, total_cycles=total,
                 share={k: v / total for k, v in cyc.items()})
    if args.out:
        with open(args.out, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
