"""The port's distributed runtime (dist/runtime.py), mesh sharding
(parallel/mesh.py) and scaling harness (dist/harness.py) on the CPU.

A world of several ranks runs as separate processes joined by gloo over
tcp on localhost (a free port, bound at port 0, so that test workers do
not collide), each with a timeout. One module-scoped job of four ranks
(two simulated hosts of two ranks) runs every multi-rank check once and
writes each rank's findings; the tests read them. The contracts: the
sharded box-QP call's outputs equal the single-process call's (1e-12,
f64: each lane's solve is the same), and its parameter gradients,
summed over the ranks, equal the single-process gradients (1e-12), each
rank's being nonzero on its own rows only (an autograd all-gather whose
backward sums over the ranks would give four times the gradient);
solve_bucketed and the BucketScheduler over the mesh equal their plain
runs; a solver failure on one rank raises on every rank; the global
batch round trip; the mesh shapes and placements. In this process:
`initialize` is a no-op without arguments and the backend follows the
device (the card by default: it raises without CUDA), `pad_batch`, and
the harness, whose multi-process run reports as tests/test_dist.py asks
of the reference's.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cvxpylayers_tpu_torch.dist import harness, initialize
from cvxpylayers_tpu_torch.parallel import make_data_mesh, pad_batch

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

_RANK = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    import cvxpylayers_tpu_torch as ct
    from cvxpylayers_tpu_torch.dist import (
        BucketScheduler, global_batch, host_local_results, initialize,
        make_global_mesh, make_host_mesh, solve_bucketed)
    from cvxpylayers_tpu_torch.parallel import (
        batch_sharding, replicated, shard_layer_call)

    res = {}
    res["init"] = initialize(f"127.0.0.1:{port}", world, rank,
                             device="cpu")
    res["init_again"] = initialize(f"127.0.0.1:{port}", world, rank,
                                   device="cpu")
    res["backend"] = dist.get_backend()
    mesh = make_global_mesh(device_type="cpu")
    host = make_host_mesh(device_type="cpu", ranks_per_host=2)
    res["host_shape"] = list(host.shape)
    res["host_names"] = list(host.mesh_dim_names)
    res["host_coord"] = list(host.get_coordinate())
    # every rank of this run shares one host name
    res["default_host_shape"] = list(make_host_mesh(device_type="cpu").shape)
    res["placements"] = [repr(p) for p in batch_sharding(mesh)]
    res["host_placements"] = [repr(p) for p in batch_sharding(host, "chip")]
    res["replicated"] = [repr(p) for p in replicated(host)]

    def box(n=4, m=2):
        x = ct.Variable(n)
        v = ct.Parameter(n)
        G = ct.Parameter((m, n))
        h = ct.Parameter(m)
        prob = ct.Problem(ct.Minimize(ct.sum_squares(x - v)),
                          [G @ x <= h, x >= 0, x <= 1])
        return ct.CvxpyLayer(prob, parameters=[v, G, h], variables=[x],
                             device="cpu")

    layer = box()
    r = np.random.default_rng(0)  # the same full batch on every rank
    B = 8
    host_params = [r.standard_normal((B, 4)),
                   r.standard_normal((B, 2, 4)) * 0.3,
                   np.abs(r.standard_normal((B, 2))) + 1.0]
    w = torch.as_tensor(r.standard_normal((B, 4)))

    def run(call):
        leaves = [torch.tensor(a, requires_grad=True) for a in host_params]
        (x,) = call(*leaves)
        (w * x).sum().backward()
        return x.detach(), [p.grad for p in leaves]

    xs, gs = run(shard_layer_call(layer, mesh))
    xd, gd = run(layer)
    res["out_diff"] = float((xs - xd).abs().max())
    b = B // world
    mine = torch.zeros(B, dtype=torch.bool)
    mine[rank * b:(rank + 1) * b] = True
    res["grad_off_rows"] = max(float(g[~mine].abs().max()) for g in gs)
    # v's gradient (G's and h's vanish where G x <= h is inactive)
    res["grad_own_rows"] = float(gs[0][mine].abs().max())
    for g in gs:
        dist.all_reduce(g)
    res["grad_sum_diff"] = max(float((a - c).abs().max())
                               for a, c in zip(gs, gd))
    xh, _ = run(shard_layer_call(layer, host, "chip"))
    res["host_out_diff"] = float((xh - xd).abs().max())

    local = np.arange(6.0).reshape(2, 3) + 10 * rank
    gb = global_batch(local, mesh)
    res["gb_shape"] = list(gb.shape)
    res["gb_full"] = gb.full_tensor().numpy().tolist()
    res["gb_local_ok"] = bool(np.array_equal(host_local_results(gb), local))

    x2 = ct.Variable(4)
    p2 = ct.Parameter(4)
    proj = ct.CvxpyLayer(ct.Problem(ct.Minimize(ct.sum_squares(x2 - p2)),
                                    [ct.sum(x2) == 1, x2 >= 0]),
                         parameters=[p2], variables=[x2], device="cpu")
    items = [(layer, tuple(torch.as_tensor(a[:5]) for a in host_params)),
             (proj, (torch.as_tensor(host_params[0][:3]),))]
    on_mesh = solve_bucketed(items, mesh=mesh)
    plain = solve_bucketed(items)
    res["bucketed_diff"] = max(float((a[0] - c[0]).abs().max())
                               for a, c in zip(on_mesh, plain))
    sched = BucketScheduler(mesh=mesh)
    res["sched_pad_multiple"] = sched.pad_multiple
    stepped = sched.step(items)
    res["sched_diff"] = max(float((a[0] - c[0]).abs().max())
                            for a, c in zip(stepped, plain))
    res["sched_capacities"] = sorted(
        s["capacity"] for s in sched.stats().values())

    # an infeasible instance on the last rank's rows only: every rank
    # raises, after the gather
    bad = [torch.as_tensor(a) for a in host_params]
    bad[2] = bad[2].clone()
    bad[2][-1] = -100.0
    try:
        shard_layer_call(layer, mesh)(*bad, solver_args={"max_iters": 200})
        res["raised"] = None
    except ct.SolverError as e:
        res["raised"] = str(e)
    dist.destroy_process_group()
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    """
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo ranks on this machine, each's findings as a dict."""
    out = tmp_path_factory.mktemp("ranks")
    script = out / "rank.py"
    script.write_text(_RANK)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), port, str(out)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def test_initialize_is_a_no_op_without_arguments():
    assert initialize() is False
    assert initialize(num_processes=1) is False
    assert not dist.is_initialized()


def test_initialize_backend_follows_the_device():
    """Partial arguments raise; the default device is the card, which
    raises without CUDA rather than switching to gloo; an unknown device
    raises. No process group is started by any of them."""
    with pytest.raises(ValueError, match="together"):
        initialize("127.0.0.1:1", 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            initialize("127.0.0.1:1", 2, 0)
    with pytest.raises(ValueError, match="backend"):
        initialize("127.0.0.1:1", 2, 0, device="meta")
    assert not dist.is_initialized()


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize"):
        make_data_mesh(device_type="cpu")


def test_pad_batch_repeats_the_last_instance():
    a = torch.arange(13.0).reshape(13, 1)
    b = torch.arange(26.0).reshape(13, 2)
    (pa, pb), B = pad_batch((a, b), 8)
    assert B == 13 and pa.shape == (16, 1) and pb.shape == (16, 2)
    assert torch.equal(pa[13:], a[-1:].expand(3, 1))
    assert torch.equal(pb[:13], b)
    same, B = pad_batch((a[:8],), 8)
    assert B == 8 and same[0] is not None and same[0].shape == (8, 1)


def test_initialize_is_idempotent_under_gloo(ranks):
    for r in ranks:
        assert r["init"] is True and r["init_again"] is True
        assert r["backend"] == "gloo"


def test_sharded_call_outputs_equal_the_single_process_call(ranks):
    for r in ranks:
        assert r["out_diff"] <= 1e-12
        assert r["host_out_diff"] <= 1e-12  # over a host's two ranks


def test_sharded_gradient_summed_over_ranks_equals_single_process(ranks):
    for r in ranks:
        assert r["grad_sum_diff"] <= 1e-12


def test_sharded_gradient_lies_on_each_ranks_own_rows(ranks):
    for r in ranks:
        assert r["grad_off_rows"] == 0.0
        assert r["grad_own_rows"] > 0.0


def test_global_batch_round_trip(ranks):
    full = np.concatenate([np.arange(6.0).reshape(2, 3) + 10 * k
                           for k in range(WORLD)])
    for r in ranks:
        assert r["gb_shape"] == [2 * WORLD, 3]
        np.testing.assert_array_equal(r["gb_full"], full)
        assert r["gb_local_ok"]


def test_host_mesh_shape_and_placements(ranks):
    for k, r in enumerate(ranks):
        assert r["host_shape"] == [2, 2]
        assert r["host_names"] == ["host", "chip"]
        assert r["host_coord"] == [k // 2, k % 2]
        assert r["default_host_shape"] == [1, WORLD]
        assert r["placements"] == ["Shard(dim=0)"]
        assert r["host_placements"] == ["Replicate()", "Shard(dim=0)"]
        assert r["replicated"] == ["Replicate()", "Replicate()"]


def test_solve_bucketed_over_the_mesh_equals_plain(ranks):
    for r in ranks:
        assert r["bucketed_diff"] <= 1e-12


def test_scheduler_over_the_mesh_pads_to_the_mesh(ranks):
    for r in ranks:
        assert r["sched_pad_multiple"] == WORLD
        assert r["sched_capacities"] == [4, 8]
        assert r["sched_diff"] <= 1e-12


def test_a_failure_on_one_rank_raises_on_every_rank(ranks):
    for r in ranks:
        assert r["raised"] is not None


def test_multiprocess_scaling_harness():
    """2 hosts x 2 ranks: gloo on the CPU, the host and global meshes,
    forward and backward through sharded calls."""
    res = subprocess.run(
        [sys.executable, "-m", "cvxpylayers_tpu_torch.dist.harness",
         "--procs", "2", "--devices-per-proc", "2", "--batch", "8",
         "--n", "6", "--steps", "2", "--port", str(_free_port())],
        capture_output=True, text=True, timeout=240, env=_env(), cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("{")][-1]
    out = json.loads(line)
    assert out["n_hosts"] == 2
    assert out["n_local_devices"] == 2
    assert out["device"] == "cpu" and 0.0 < out["solved_fraction_min"] <= 1
    for k in ("solves_per_s_1dev", "solves_per_s_1host",
              "solves_per_s_Nhost"):
        assert out[k] > 0, out


def test_harness_runs_on_the_card_unless_asked():
    """One process without --cpu takes the card: without CUDA the layer
    raises, with no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = argparse.Namespace(procs=1, devices_per_proc=1, batch=4, n=3,
                              steps=1, port=0, gp=False, gp_batch=4,
                              sweep_batch=False, cpu=False, proc_id=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.worker(args)
