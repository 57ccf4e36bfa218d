#!/usr/bin/env python3
"""Kernel K1 (cvxpylayers_tpu_torch/csrc/admm_epoch.cu) on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 bench_k1.py [--old PATH] [--clocks] [--sass] [--regcap]
                        [--out FILE]

Records, one JSON line each (also written to FILE when given):
  ptxas      registers, spills and shared memory of every kernel built
  sweep      K1 at each SHAPES entry with every launch plan that fits it
             (branch, threads per instance); the wrapper's choice marked
  wrapper    the same launch through cuda_admm.polyhedral_inner_epoch, to
             show the host's share of a timed call
  old        with --old, an older admm_epoch.cu with the version-1 C
             interface (admm_polyhedral_epoch_plan and a 21-argument
             launch) at each SHAPES entry
  ab         with --old, the package's K1 against that source, timed in
             turns (old, new, new, old) in this call
  staircase  the box-QP shape (n=50, m=120, 50 steps, f32) over batch
             sizes around multiples of the 132 SMs, for the package's
             plan and for --old; B = 132 x (instances per block) is one
             block alone on each SM, the latency of one block's chain
  regcap     with --regcap, the box-QP f32 register tile built under each
             __launch_bounds__ minimum of blocks per SM in REGCAPS (a copy
             of the source in _scratch/k1_regcap/), with ptxas's registers
             and spills, timed at REGCAP_BATCHES
  clocks     with --clocks, cycles by phase of one epoch: an instrumented
             copy of each source is written to and built in
             _scratch/k1_clocks/ (never in the package), where thread 0 of
             block 0 adds up clock64() deltas by phase; one launch each at
             B = 132, 792 and 1024
  sass       with --sass, `cuobjdump -sass` opcode counts per kernel of
             each build: shared loads and stores by width, shuffles,
             barriers, warp-sync and collective sequences, local-memory
             spills, FMAs

Every variant is held against the plain version at chip_smoke.py's K1
tolerance before it is timed. Kernel times: CUDA events around 20
launches captured in one CUDA graph (chip_smoke.time_graph), after 3
warm-up launches; the wrapper's time: 20 plain launches.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    _ORDER, epoch_bound_ms, epoch_error, epoch_inputs, fail, say, time_cuda,
    time_graph)

SHAPES = [  # (label, B, n, m, n_zero, dtype, iters) as the ADMM path runs K1
    ("box-QP f32", 1024, 50, 120, 0, torch.float32, 50),
    ("box-QP f64", 1024, 50, 120, 0, torch.float64, 50),
    ("simplex f32", 256, 20, 21, 1, torch.float32, 25),
    ("LAD f32", 256, 5, 8, 0, torch.float32, 100),
]
STAIRS = (132, 264, 396, 528, 660, 792, 924, 1024, 1056, 1188, 1320, 1452,
          1584)
CLOCK_BATCHES = (132, 792, 1024)
SIGMA, ALPHA = 1e-6, 1.6


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def check(out, a, kw, label):
    """The kernel's (x, z, y) against the plain version, at chip_smoke.py's
    tolerance."""
    for o in out:
        if not bool(torch.isfinite(o).all()):
            fail(f"{label}: non-finite kernel output")
    from cvxpylayers_tpu_torch.solver import cuda_admm

    err, tol, _ = epoch_error(cuda_admm, a, kw, out)
    if err > tol:
        fail(f"{label}: max abs err {err:.3e} > tol {tol:.3e}")
    return err, tol


def nvcc_build(src, so, extra=()):
    """Build one source with the package's nvcc flags; the ptxas report."""
    from cvxpylayers_tpu_torch import cuda_build

    os.makedirs(os.path.dirname(so), exist_ok=True)
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *extra, "-o", so,
         src], capture_output=True, text=True)
    if proc.returncode:
        fail(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def ptxas_report(log, needle):
    """(registers, spill store bytes, spill load bytes) of the one kernel
    whose mangled name contains `needle`, from a -Xptxas -v log."""
    lines = log.splitlines()
    for k, ln in enumerate(lines):
        if "Compiling entry function" in ln and needle in ln:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", "\n".join(lines[k:k + 3]))
            regs = re.search(r"Used (\d+) registers", "\n".join(
                lines[k:k + 4]))
            return (int(regs.group(1)) if regs else None,
                    *(int(v) for v in (spill.groups() if spill else (0, 0))))
    return None, None, None


# register caps (the __launch_bounds__ minimum of blocks per SM, f32) to
# try for the box-QP tile, and the batches each is timed at
REGCAPS = (1, 2, 3, 4)
REGCAP_BATCHES = (132, 528, 1024)


def regcap_library(tile, minb, build_dir):
    """A copy of csrc/admm_epoch.cu whose register tile `tile` asks for
    `minb` blocks per SM in f32, built in `build_dir`; (lib, ptxas log)."""
    from cvxpylayers_tpu_torch import cuda_build

    src = (cuda_build.SRC_DIR / "admm_epoch.cu").read_text()
    head, rest = src.split("constexpr Tile kTiles[] = {\n", 1)
    body, tail = rest.split("};", 1)
    rows = body.splitlines(keepends=True)
    fields = re.match(r"(\s*\{)(\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\}",
                      rows[tile])
    if fields is None:
        fail(f"--regcap: kTiles row {tile} not understood: {rows[tile]!r}")
    g = fields.groups()
    rows[tile] = rows[tile].replace(
        fields.group(0), f"{g[0]}{g[1]}, {g[2]}, {g[3]}, {g[4]}, {minb}, "
        f"{g[6]}}}")
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"admm_epoch_t{tile}_b{minb}.cu")
    with open(path, "w") as f:
        f.write(head + "constexpr Tile kTiles[] = {\n" + "".join(rows) + "};"
                + tail)
    so = os.path.join(build_dir, f"libadmm_epoch_t{tile}_b{minb}.so")
    log = nvcc_build(path, so)
    return ctypes.CDLL(so), log


class OldK1:
    """An admm_epoch.cu with the version-1 C interface."""

    def __init__(self, lib):
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.admm_polyhedral_epoch_f32,
                   lib.admm_polyhedral_epoch_f64):
            fn.argtypes = [ptr] * 12 + [i32] * 5 + [f64, f64, i32, ptr]
            fn.restype = i32
        lib.admm_polyhedral_epoch_plan.argtypes = [
            i32, i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)]
        lib.admm_polyhedral_epoch_plan.restype = i32
        self.lib = lib

    def plan(self, n, m, dtype):
        smem = ctypes.c_longlong(0)
        elem = torch.empty((), dtype=dtype).element_size()
        code = self.lib.admm_polyhedral_epoch_plan(n, m, elem, 0,
                                                   ctypes.byref(smem))
        if code < 0:
            fail(f"old admm_polyhedral_epoch_plan: {code}")
        return dict(branch="shared" if code else "device",
                    smem_bytes=int(smem.value))

    def __call__(self, a, n_zero, iters):
        B, n = a["q"].shape
        m = a["b"].shape[1]
        in_shared = self.plan(n, m, a["q"].dtype)["branch"] == "shared"
        outs = [torch.empty_like(a[k]) for k in ("x", "z", "y")]
        work = torch.empty(0 if in_shared else B * (2 * n + m),
                           dtype=a["q"].dtype, device=a["q"].device)
        fn = (self.lib.admm_polyhedral_epoch_f32
              if a["q"].dtype == torch.float32
              else self.lib.admm_polyhedral_epoch_f64)
        err = fn(*(a[k].data_ptr() for k in _ORDER),
                 *(o.data_ptr() for o in outs), work.data_ptr(), B, n, m,
                 n_zero, iters, SIGMA, ALPHA, int(in_shared),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"old K1 launch failed: cudaError {err}")
        return outs


class NewK1:
    """The package's K1 (or a library with its C interface), launched with
    a chosen plan."""

    def __init__(self, cuda_admm, lib=None):
        self.ca = cuda_admm
        self.lib = cuda_admm.bind(lib) if lib else cuda_admm._library()
        self.optin = self.lib.admm_epoch_smem_optin(0)

    def plan(self, n, m, dtype):
        elem = torch.empty((), dtype=dtype).element_size()
        return self.ca.launch_plan(n, m, elem, self.optin)

    def __call__(self, a, n_zero, iters, plan=None):
        n, m = a["q"].shape[1], a["b"].shape[1]
        plan = plan or self.plan(n, m, a["q"].dtype)
        return self.ca.launch(self.lib, plan, *(a[k] for k in _ORDER),
                              n_zero=n_zero, iters=iters, sigma=SIGMA,
                              alpha=ALPHA)


# ---------------------------------------------------------------- clocks

_CLOCK_HEAD = (
    "__device__ unsigned long long k1_clk[16];\n"
    "#define K1_STAMP(i) if (probe_) { long long t1_ = clock64(); "
    "atomicAdd(&k1_clk[i], (unsigned long long)(t1_ - t_)); t_ = t1_; }\n")
_CLOCK_API = """
extern "C" int admm_epoch_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long zero[16] = {0};
    return (int)cudaMemcpyToSymbol(k1_clk, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, k1_clk, sizeof(k1_clk));
}
"""
# version 1: (anchor in the source, the same text with probes); the phases
# in the order of their stamp numbers
_PROBES_V1 = [
    ("#include <stddef.h>\n", "#include <stddef.h>\n" + _CLOCK_HEAD),
    ("  const int nt = blockDim.x;\n",
     "  const int nt = blockDim.x;\n"
     "  const bool probe_ = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "  long long t_ = clock64();\n"),
    ("    t[i] = rho_inst[i] * zi - yi;\n  }\n  __syncthreads();\n",
     "    t[i] = rho_inst[i] * zi - yi;\n  }\n  __syncthreads();\n"
     "  K1_STAMP(0)\n"),
    ("      rhs[j] = sigma * x[j] - q[j] + acc;\n    }\n"
     "    __syncthreads();\n",
     "      rhs[j] = sigma * x[j] - q[j] + acc;\n    }\n    K1_STAMP(1)\n"
     "    __syncthreads();\n    K1_STAMP(2)\n"),
    ("      x[k] = alpha * acc + one_m_alpha * x[k];\n    }\n"
     "    __syncthreads();\n",
     "      x[k] = alpha * acc + one_m_alpha * x[k];\n    }\n"
     "    K1_STAMP(3)\n    __syncthreads();\n    K1_STAMP(4)\n"),
    ("      t[i] = ri * zn - yn;\n    }\n    __syncthreads();\n",
     "      t[i] = ri * zn - yn;\n    }\n    K1_STAMP(5)\n"
     "    __syncthreads();\n    K1_STAMP(6)\n"),
    ("      y_out[inst * (size_t)m + i] = y[i];\n    }\n  }\n}\n",
     "      y_out[inst * (size_t)m + i] = y[i];\n    }\n  }\n"
     "  K1_STAMP(7)\n}\n"),
]
_PHASES_V1 = ("staging", "At_t", "barrier_1", "Minv_rhs", "barrier_2",
              "A_xt_projection", "barrier_3", "writeout")
# version 2: the register branch's kernel (admm_epoch_reg_kernel)
_PROBES_V2 = [
    ("#include <stddef.h>\n", "#include <stddef.h>\n" + _CLOCK_HEAD),
    ("  T* p_s = base + L::kP;\n",
     "  T* p_s = base + L::kP;\n"
     "  const bool probe_ = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "  long long t_ = clock64();\n"),
    ("  __syncthreads();  // end of staging\n",
     "  __syncthreads();  // end of staging\n  K1_STAMP(0)\n"),
    ("    __syncthreads();  // barrier 1: the partials of A' t\n",
     "    K1_STAMP(1)\n    __syncthreads();\n    K1_STAMP(2)\n"),
    ("    __syncthreads();  // barrier 2: xt\n",
     "    K1_STAMP(3)\n    __syncthreads();\n    K1_STAMP(4)\n"),
    ("    __syncwarp();  // t is read back only inside this row group\n",
     "    K1_STAMP(5)\n    __syncwarp();\n    K1_STAMP(6)\n"),
    ("      y_out[inst * m + row[r]] = y[r];\n    }\n}\n",
     "      y_out[inst * m + row[r]] = y[r];\n    }\n  K1_STAMP(7)\n}\n"),
]
_PHASES_V2 = ("staging", "At_t", "barrier_1", "Minv_rhs", "barrier_2",
              "A_xt_projection", "warp_barrier", "writeout")


def clocks_library(src_path, build_dir, tag):
    """Build the instrumented copy of `src_path` (version 1 or 2, told by
    its C interface); returns (lib, version, phases)."""
    src = open(src_path).read()
    v1 = "admm_polyhedral_epoch_plan" in src
    probes, phases = (_PROBES_V1, _PHASES_V1) if v1 else (_PROBES_V2,
                                                          _PHASES_V2)
    for anchor, text in probes:
        if src.count(anchor) != 1:
            fail(f"--clocks: anchor not found once in {src_path}: {anchor!r}")
        src = src.replace(anchor, text)
    src += _CLOCK_API
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"admm_epoch_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(build_dir, f"libadmm_epoch_{tag}.so")
    nvcc_build(path, so)
    lib = ctypes.CDLL(so)
    lib.admm_epoch_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.admm_epoch_clocks.restype = ctypes.c_int
    return lib, 1 if v1 else 2, phases


# ------------------------------------------------------------------ sass

_SASS_KEYS = ("LD", "ST", "LDS", "LDS.32", "LDS.64", "LDS.128", "STS",
              "STS.32", "STS.64", "STS.128", "LDG", "STG",
              "SHFL", "BAR", "WARPSYNC", "ENDCOLLECTIVE", "BSSY", "LDL",
              "STL", "FFMA", "DFMA", "FADD", "MUFU")
_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(so, dump=None):
    """Opcode counts per kernel function of a built library; the whole
    listing also goes to the file `dump` when given."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    if dump:
        with open(dump, "w") as f:
            f.write(out)
    funcs = collections.OrderedDict()
    cur = None
    for line in out.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = collections.Counter()
            continue
        mt = _OP.search(line) if cur else None
        if mt:
            op = mt.group(1)
            base = op.split(".")[0]
            funcs[cur][base] += 1
            if base in ("LDS", "STS"):
                width = next((w for w in ("128", "64") if f".{w}" in op),
                             "32")
                funcs[cur][f"{base}.{width}"] += 1
    return {f: {k: c[k] for k in _SASS_KEYS if c[k]} for f, c in
            funcs.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="an older admm_epoch.cu (version-1 C "
                    "interface) to time against")
    ap.add_argument("--out", help="also write the records to this file")
    ap.add_argument("--clocks", action="store_true",
                    help="also the cycles by phase of instrumented copies")
    ap.add_argument("--sass", action="store_true",
                    help="also cuobjdump -sass opcode counts")
    ap.add_argument("--regcap", action="store_true",
                    help="also the box-QP f32 tile under other register caps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("bench_k1.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    from cvxpylayers_tpu_torch import cuda_build
    from cvxpylayers_tpu_torch.solver import cuda_admm

    records = []

    def emit(kind, **rec):
        rec = dict(record=kind, card=smi, **rec)
        records.append(rec)
        say(json.dumps(rec))

    scratch = os.path.join(ROOT, "_scratch")
    new = NewK1(cuda_admm)
    kernels = {"new": new}
    emit("ptxas", source="package",
         lines=ptxas_lines(cuda_build.BUILD_LOGS.get("admm_epoch", "")))
    old = None
    if args.old:
        so = os.path.join(scratch, "k1_old_build", "libadmm_epoch_old.so")
        log = nvcc_build(args.old, so)
        emit("ptxas", source=args.old, lines=ptxas_lines(log))
        old = OldK1(ctypes.CDLL(so))
        kernels["old"] = old
    if args.sass:
        emit("sass", source="package", counts=sass_counts(
            str(cuda_build.library_path("admm_epoch")),
            args.out and args.out + ".sass.txt"))
        if old is not None:
            emit("sass", source=args.old, counts=sass_counts(so))

    for label, B, n, m, n_zero, dtype, iters in SHAPES:
        a = epoch_inputs(B, n, m, n_zero, dtype, seed=B + n_zero)
        kw = dict(n_zero=n_zero, iters=iters, sigma=SIGMA, alpha=ALPHA)
        elem = torch.empty((), dtype=dtype).element_size()
        bound, bound_by = epoch_bound_ms(B, n, m, iters, elem)
        common = dict(shape=label, B=B, n=n, m=m, n_zero=n_zero, iters=iters,
                      dtype=dtype_name(dtype), bound_ms=bound,
                      bound_by=bound_by)
        chosen = new.plan(n, m, dtype)
        for plan in cuda_admm.plan_candidates(n, m, elem, new.optin):
            err, tol = check(new(a, n_zero, iters, plan), a, kw,
                             f"{label} {plan}")
            ms = time_graph(lambda: new(a, n_zero, iters, plan))
            emit("sweep", **common, plan=plan._asdict(),
                 chosen=plan == chosen, ms=ms, max_abs_err=err, tol=tol)
        ms = time_cuda(lambda: cuda_admm.polyhedral_inner_epoch(
            *(a[k] for k in _ORDER), **kw), reps=20, warmup=3)
        emit("wrapper", **common, plan=chosen._asdict(), ms=ms)
        if old is not None:
            err, tol = check(old(a, n_zero, iters), a, kw, f"{label} old")
            ms = time_graph(lambda: old(a, n_zero, iters))
            emit("old", **common, plan=old.plan(n, m, dtype), ms=ms,
                 max_abs_err=err, tol=tol)
        if old is not None:
            turns = []
            for which in ("old", "new", "new", "old"):
                k = kernels[which]
                turns.append((which, time_graph(lambda: k(a, n_zero, iters))))
            o = [t for w, t in turns if w == "old"]
            w = [t for w, t in turns if w == "new"]
            emit("ab", **common, plan=chosen._asdict(), old_ms=o, new_ms=w,
                 speedup=sum(o) / sum(w))
        del a

    n, m = 50, 120
    for which, k in kernels.items():
        plan = (new.plan(n, m, torch.float32)._asdict() if which == "new"
                else old.plan(n, m, torch.float32))
        for B in STAIRS:
            a = epoch_inputs(B, n, m, 0, torch.float32, seed=B)
            ms = time_graph(lambda: k(a, 0, 50))
            emit("staircase", kernel=which, B=B, n=n, m=m, dtype="float32",
                 iters=50, plan=plan, ms=ms, us_per_instance=ms * 1e3 / B)

    if args.regcap:
        plan = new.plan(n, m, torch.float32)
        tile = cuda_admm.TILES[plan.tile]
        needle = (f"reg_kernelIfLi{tile.threads}ELi{tile.rows_a}ELi"
                  f"{tile.rows_m}ELi{tile.cols}ELi")
        for minb in REGCAPS:
            lib, log = regcap_library(plan.tile, minb, os.path.join(
                scratch, "k1_regcap"))
            regs, spill_st, spill_ld = ptxas_report(log, f"{needle}{minb}E")
            k = NewK1(cuda_admm, lib)
            for B in REGCAP_BATCHES:
                a = epoch_inputs(B, n, m, 0, torch.float32, seed=B)
                kw = dict(n_zero=0, iters=50, sigma=SIGMA, alpha=ALPHA)
                check(k(a, 0, 50, plan), a, kw, f"regcap {minb} B={B}")
                ms = time_graph(lambda: k(a, 0, 50, plan))
                emit("regcap", B=B, n=n, m=m, dtype="float32", iters=50,
                     plan=plan._asdict(), min_blocks=minb, registers=regs,
                     spill_stores=spill_st, spill_loads=spill_ld, ms=ms)

    if args.clocks:
        sources = [("new", str(cuda_build.SRC_DIR / "admm_epoch.cu"))]
        if old is not None:
            sources.append(("old", args.old))
        buf = (ctypes.c_ulonglong * 16)()
        for tag, src in sources:
            lib, version, phases = clocks_library(
                src, os.path.join(scratch, "k1_clocks"), tag)
            probe = OldK1(lib) if version == 1 else NewK1(cuda_admm, lib)
            for B in CLOCK_BATCHES:
                a = epoch_inputs(B, n, m, 0, torch.float32, seed=B)
                kw = dict(n_zero=0, iters=50, sigma=SIGMA, alpha=ALPHA)
                check(probe(a, 0, 50), a, kw, f"clocks copy {tag} B={B}")
                torch.cuda.synchronize()
                lib.admm_epoch_clocks(buf, 1)
                probe(a, 0, 50)
                torch.cuda.synchronize()
                lib.admm_epoch_clocks(buf, 0)
                cyc = dict(zip(phases, list(buf)[:len(phases)]))
                total = sum(cyc.values())
                emit("clocks", kernel=tag, version=version, B=B, n=n, m=m,
                     dtype="float32", iters=50, cycles=cyc,
                     total_cycles=total,
                     share={k: v / total for k, v in cyc.items()})
    if args.out:
        with open(args.out, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
