"""Scaling measurement harness: forward+backward solves/s at 1 device,
one host and (several ranks) the whole world.

Counterpart of cvxpylayers_tpu/dist/harness.py, on torch.distributed,
where each device is one rank.

Run modes
---------
One process on the card (the default; `--cpu` runs it on the CPU):

    python -m cvxpylayers_tpu_torch.dist.harness --batch 1024 --sweep-batch

P hosts of D ranks each, simulated on the CPU of one machine with gloo
(`--procs` above 1 always runs on the CPU, as the reference's
multi-process mode does):

    python -m cvxpylayers_tpu_torch.dist.harness --procs 2 --devices-per-proc 2

`--procs 1 --devices-per-proc D` runs D ranks on D cards with NCCL. The
parent spawns one worker process per rank and stops them all if one
fails; rank 0 prints one JSON line with the measured throughputs:
`solves_per_s_1dev` (one rank alone), `solves_per_s_1host` (one host's
ranks sharing the batch), `solves_per_s_Nhost` (every rank sharing it),
`n_hosts`, `n_local_devices`, and optionally the batch sweep
(`solves_per_s_1host_by_batch`) and the geometric program
(`gp_solves_per_s_*`), with the least solved fraction of every timed
step (`solved_fraction_min`) and the device's name. Every step is one
forward and backward pass and the timed window ends in a synchronize.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def _build_problem(n: int, device):
    import cvxpylayers_tpu_torch as ct

    x = ct.Variable(n)
    v = ct.Parameter(n)
    G = ct.Parameter((n, n))
    prob = ct.Problem(
        ct.Minimize(ct.sum_squares(G @ x - v)), [x >= -1, x <= 1]
    )
    return ct.CvxpyLayer(prob, parameters=[v, G], variables=[x],
                         device=device)


def _build_gp_problem(device):
    """The reference's 3-variable GP (gp=True log-space path)."""
    import cvxpylayers_tpu_torch as ct

    xg = ct.Variable((), pos=True)
    yg = ct.Variable((), pos=True)
    zg = ct.Variable((), pos=True)
    a = ct.Parameter((), pos=True)
    bb = ct.Parameter((), pos=True)
    cc = ct.Parameter(())
    prob = ct.Problem(
        ct.Minimize(1.0 / (xg * yg * zg)),
        [a * (xg * yg + xg * zg + yg * zg) <= bb, xg >= yg ** cc],
    )
    return ct.CvxpyLayer(prob, parameters=[a, bb, cc],
                         variables=[xg, yg, zg], gp=True, device=device)


def _timed_steps(step, steps: int, device):
    """Seconds for `steps` calls of `step` after one warm-up, ending in
    a synchronize on the card, and the least solved fraction of the
    timed calls (each call returns its statuses, read after the
    window)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step()
    sync()
    t0 = time.perf_counter()
    statuses = [step() for _ in range(steps)]
    sync()
    dt = time.perf_counter() - t0
    return dt, min(float((st == 0).double().mean()) for st in statuses)


def _step_fn(layer, mesh, axis_name, params, sargs):
    """One forward and backward pass over `params`, split over `mesh`'s
    `axis_name` ranks (None: this rank alone); returns the statuses.
    Solver failures are data here, as under the reference's jit: a lane
    left at MAX_ITERS lowers the solved fraction and does not stop the
    measurement."""
    from ..parallel.mesh import _solve_with_info

    def step():
        outs, status, _ = _solve_with_info(layer, mesh, axis_name, params,
                                           {"solver_args": sargs})
        sum(torch.mean(o ** 2) for o in outs).backward()
        return status

    return step


def _gp_throughput(layer, B: int, mesh, axis_name, steps: int, dtype,
                   device):
    """(fwd+bwd GP solves/s, least solved fraction) with the batch split
    over `mesh` (every rank holds the whole batch; None: this rank
    alone)."""
    rng = np.random.default_rng(0)
    host = (np.abs(rng.standard_normal(B)) + 1.0,
            np.abs(rng.standard_normal(B)) + 3.0,
            rng.uniform(0.3, 0.9, B))
    params = [torch.tensor(h, dtype=dtype, device=device,
                           requires_grad=True) for h in host]
    sargs = {"eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-3,
             "admm_eps_rel": 1e-3, "max_iters": 300, "epoch": 100,
             "cg_iters": 15}
    dt, solved = _timed_steps(
        _step_fn(layer, mesh, axis_name, params, sargs), steps, device)
    return B * steps / dt, solved


def _throughput(layer, B: int, n: int, mesh, axis_name, steps: int, dtype,
                device):
    """(fwd+bwd solves/s (total across the mesh), least solved fraction)
    with the batch split over `mesh`: every rank holds the same B
    instances (seed 0) and solves its own rows; None is this rank
    alone. The loss is the mean square of x; the gradient flows to v."""
    rng = np.random.default_rng(0)
    v = torch.tensor(rng.standard_normal((B, n)), dtype=dtype,
                     device=device, requires_grad=True)
    G = torch.tensor(np.eye(n) + 0.1 * rng.standard_normal((B, n, n)),
                     dtype=dtype, device=device)
    sargs = {"eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-3,
             "admm_eps_rel": 1e-3, "max_iters": 500, "refine_steps": 3}
    dt, solved = _timed_steps(
        _step_fn(layer, mesh, axis_name, (v, G), sargs), steps, device)
    return B * steps / dt, solved


def worker(args) -> None:
    from .runtime import initialize, make_global_mesh, make_host_mesh

    world = args.procs * args.devices_per_proc
    if args.cpu:
        # one thread a rank: each rank stands for one device
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda",
                              args.proc_id % args.devices_per_proc)
    dtype = torch.float32
    host_mesh = global_mesh = None
    if world > 1:
        initialize(f"127.0.0.1:{args.port}", world, args.proc_id,
                   local_device_ids=None if args.cpu else [device.index],
                   device=device)
        host_mesh = make_host_mesh(device_type=device.type,
                                   ranks_per_host=args.devices_per_proc)
        global_mesh = make_global_mesh(device_type=device.type)
    layer = _build_problem(args.n, device)

    solved = []

    def tput(B, mesh, axis_name):
        rate, frac = _throughput(layer, B, args.n, mesh, axis_name,
                                 args.steps, dtype, device)
        solved.append(frac)
        return rate

    def gp_tput(mesh, axis_name):
        rate, frac = _gp_throughput(gp_layer, args.gp_batch, mesh,
                                    axis_name, args.steps, dtype, device)
        solved.append(frac)
        return rate

    results = {}
    # 1 device: this rank alone, no communication
    results["solves_per_s_1dev"] = tput(args.batch, None, None)
    # one host: the host's ranks share the batch
    results["solves_per_s_1host"] = tput(args.batch, host_mesh, "chip")
    # global mesh (N hosts)
    if world > 1:
        results["solves_per_s_Nhost"] = tput(args.batch, global_mesh,
                                             "data")
        results["n_hosts"] = args.procs
    if args.sweep_batch:
        # throughput vs batch size: a fixed small batch understates a
        # device's throughput, so report the curve
        sweep = {}
        for B in (64, 256, 1024, 4096):
            sweep[str(B)] = round(tput(B, host_mesh, "chip"), 1)
        results["solves_per_s_1host_by_batch"] = sweep
    if args.gp:
        gp_layer = _build_gp_problem(device)
        results["gp_solves_per_s_1host"] = gp_tput(host_mesh, "chip")
        if world > 1:
            results["gp_solves_per_s_Nhost"] = gp_tput(global_mesh, "data")
    # a rate counts only beside the fraction of lanes it solved
    results["solved_fraction_min"] = min(solved)
    results["n_local_devices"] = args.devices_per_proc
    results["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")
    if args.proc_id == 0:
        print(json.dumps(results), flush=True)
    if world > 1:
        torch.distributed.destroy_process_group()


def _run_ranks(world: int) -> int:
    """Spawn one worker per rank with this command line; if one fails,
    stop the others. Returns the worst exit code."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, "-m",
                          "cvxpylayers_tpu_torch.dist.harness",
                          *sys.argv[1:], "--proc-id", str(rank)], env=env)
        for rank in range(world)
    ]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.poll() is not None):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        codes = [p.wait() for p in procs]
    return max(abs(c) for c in codes)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--devices-per-proc", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--port", type=int, default=12377)
    ap.add_argument("--gp", action="store_true",
                    help="also measure the gp=True problem on the 1-host "
                         "and N-host meshes")
    ap.add_argument("--gp-batch", type=int, default=1024)
    ap.add_argument("--sweep-batch", action="store_true",
                    help="also sweep batch size 64..4096 on the 1-host "
                         "mesh (throughput-vs-batch curve)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (gloo between ranks)")
    ap.add_argument("--proc-id", type=int, default=None,
                    help="internal: set for spawned workers")
    args = ap.parse_args()

    world = args.procs * args.devices_per_proc
    if world > 1 and args.proc_id is None:
        sys.exit(_run_ranks(world))

    args.proc_id = args.proc_id or 0
    if args.procs > 1:
        args.cpu = True  # several hosts here are simulated on the CPU
    worker(args)


if __name__ == "__main__":
    main()
