"""The Newton polish as a CUDA graph (solver/refine.py, `GraphedPolish`).

On a CUDA device, below float64, with no PSD block and no autograd
history to record, a polish call is captured once per key (device,
dtype, the seven inputs' shapes and strides, the float32 matmul
precision) and replayed on every later call with that key; every other
call runs the eager polish as before. Here on the CPU: the rule, the
key, the bounded store of graphs, and that a CPU call is the eager
polish and is counted. On the card (tests marked `card`, skipped
without one): for the four benchmark cells' polishes (cvxbench/) a
replay equals the eager polish bitwise, a key is captured once, a
replay on new inputs gives their eager answer, and what one call
returned is not touched by the next.

    python -m pytest tests/test_torch_port_polish_graph.py -q
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cvxbench.spec import load_cell
from cvxpylayers_tpu_torch.cones.dims import ConeDims
from cvxpylayers_tpu_torch.layer.cvxpylayer import _settings_from_args
from cvxpylayers_tpu_torch.solver.refine import (
    GraphLRU,
    make_refiner,
    polish_graph_eligible,
    polish_graph_key,
)
from cvxpylayers_tpu_torch.utils import profiling
from cvxpylayers_tpu_torch.utils.precision import full_f32

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

CELLS = ["box_qp.admm_train", "box_qp.ipm_train", "markowitz.rescue_train",
         "lml.ipm_train"]
CUDA = torch.device("cuda")


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this machine has none")
    return CUDA


def _layer(cell, device):
    return cell.config_module().build_layer(cell.config, device)


# ------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("name", CELLS)
def test_each_cells_float32_polish_is_eligible_on_cuda(name):
    """Metadata only: a device object says "cuda", nothing launches."""
    dims = _layer(load_cell(name), "cpu").prog.dims
    assert polish_graph_eligible(dims, CUDA, torch.float32)


@pytest.mark.parametrize("case", ["cpu", "float64", "psd", "autograd"])
def test_eager_where_a_graph_cannot_stand(case):
    dims = ConeDims(zero=1, nonneg=4, soc=(3,))
    device, dtype, grad = CUDA, torch.float32, False
    if case == "cpu":
        device = torch.device("cpu")
    elif case == "float64":
        dtype = torch.float64
    elif case == "psd":
        dims = ConeDims(nonneg=2, psd=(3,))
    else:
        grad = True
    assert not polish_graph_eligible(dims, device, dtype, grad)


def test_inputs_that_take_gradients_are_eligible_without_grad_mode():
    dims = ConeDims(nonneg=4)
    with torch.no_grad():
        assert polish_graph_eligible(dims, CUDA, torch.float32, True)


def _args(B=3, n=4, m=5):
    return [torch.zeros(B, n), torch.zeros(B, m), torch.zeros(B, m),
            torch.zeros(B, n, n), torch.zeros(B, n), torch.zeros(B, m, n),
            torch.zeros(B, m)]


@pytest.mark.parametrize("i", range(7))
def test_key_changes_with_each_input_shape(i):
    args = _args()
    key = polish_graph_key(args)
    assert polish_graph_key(_args()) == key
    args[i] = torch.zeros(*args[i].shape[:-1], args[i].shape[-1] + 1)
    assert polish_graph_key(args) != key


def test_key_changes_with_the_matmul_precision():
    args = _args()
    old = torch.backends.cuda.matmul.allow_tf32
    old_prec = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = polish_graph_key(args)
        torch.backends.cuda.matmul.allow_tf32 = True
        assert polish_graph_key(args) != off
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("medium")
        assert polish_graph_key(args) != off
    finally:
        torch.set_float32_matmul_precision(old_prec)
        torch.backends.cuda.matmul.allow_tf32 = old


def test_key_changes_with_dtype_and_strides():
    args = _args()
    key = polish_graph_key(args)
    assert polish_graph_key([a.double() for a in args]) != key
    args[5] = torch.zeros(3, 4, 5).mT  # (B, m, n) with other strides
    assert polish_graph_key(args) != key


def test_store_evicts_the_least_recently_used_past_its_bound():
    lru = GraphLRU(3)
    for k in "abc":
        lru.put(k, k.upper())
    assert lru.get("a") == "A"  # now b is the least recently used
    lru.put("d", "D")
    assert len(lru) == 3 and lru.get("b") is None
    assert [lru.get(k) for k in "acd"] == ["A", "C", "D"]
    for k in "efgh":
        lru.put(k, k)
    assert len(lru) == 3 and list(lru.items) == ["f", "g", "h"]


def test_cpu_polish_is_the_eager_polish_and_is_counted():
    torch.manual_seed(0)
    B, n, m = 4, 3, 5
    dims = ConeDims(zero=1, nonneg=4)
    polish = make_refiner(dims, n, 3)
    P = torch.eye(n).expand(B, n, n).contiguous()
    A = torch.randn(B, m, n)
    args = (torch.randn(B, n), torch.rand(B, m), torch.rand(B, m), P,
            torch.randn(B, n), A, torch.randn(B, m))
    with profiling.recording() as rec:
        got = polish(*args)
        want = polish.fn(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rec.counts == {"polish_calls": 1}
    assert len(polish.graphs) == 0
    # no steps, no polish: the refiner is the identity, unwrapped
    assert make_refiner(dims, n, 0)(*args)[0] is args[0]


class _HostTraffic(TorchDispatchMode):
    """Records the operations that, on a CUDA tensor, copy from the host
    or read the device, which a graph capture refuses: data lifted from
    the host (torch.tensor, as_tensor of an array), a copy from a 0-dim
    tensor (an integer-indexed assignment of a Python number), and host
    reads of a tensor's value."""

    READS = ("aten._local_scalar_dense", "aten.item", "aten.nonzero",
             "aten.masked_select", "aten.is_nonzero")

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if ((name == "aten.lift_fresh.default" and args[0].dim() > 0)
                or (name.startswith("aten.copy_") and args[1].dim() == 0)
                or name.startswith(self.READS)):
            self.seen.add(name)
        return func(*args, **(kwargs or {}))


_MIXED = ConeDims(zero=1, nonneg=2, soc=(3, 3, 4), exp=2, pow3=(0.3, 0.6))


@pytest.mark.parametrize("case", CELLS[1:] + ["mixed-auto", "mixed-spectral",
                                              "mixed-pcg"])
def test_polish_copies_nothing_from_the_host(case):
    """What a capture refuses on the card shows on the CPU as an
    operation: after a first run (which makes the device constants),
    each eligible polish of a cell, and of every cone family in every
    f32 KKT mode, lifts no host data and reads no value (two steps of
    five CG iterations run every operation that more would)."""
    if case.startswith("mixed"):
        dims, n, kw = _MIXED, 6, {"kkt_mode": case.split("-")[1]}
    else:
        cell = load_cell(case)
        layer = _layer(cell, "cpu")
        args = dict(cell.config["solver_args"],
                    **cell.mix.get("solver_args", {}))
        st = _settings_from_args(layer._base_settings, args)
        dims, n = layer.prog.dims, layer.prog.n
        kw = dict(schur_iters=st.schur_iters,
                  p_diag_full=layer._p_diag_full,
                  p_diag_only=layer._p_diag_only, kkt_mode=st.kkt_mode)
    polish = make_refiner(dims, n, 2, cg_iters=5, **kw)
    g = torch.Generator().manual_seed(3)
    B, m = 2, dims.total
    P = torch.randn(B, n, n, generator=g)
    args = (torch.randn(B, n, generator=g), torch.rand(B, m, generator=g),
            torch.rand(B, m, generator=g), P @ P.mT + torch.eye(n),
            torch.randn(B, n, generator=g),
            torch.randn(B, m, n, generator=g), torch.randn(B, m, generator=g))
    with torch.no_grad(), full_f32():
        polish.fn(*args)
        with _HostTraffic() as mode:
            polish.fn(*args)
    assert mode.seen == set()


def test_host_traffic_is_seen():
    """The recorder above sees what the polish once did on the card."""
    with _HostTraffic() as mode:
        e = torch.zeros(3)
        e[0] = 1.0
        torch.as_tensor([0.3, 0.6])
        bool(e.any())
    assert mode.seen == {"aten.copy_.default", "aten.lift_fresh.default",
                         "aten._local_scalar_dense.default"}


# ------------------------------------------------------------- on the card

_CASES = {
    # cell, the stage's solver arguments (None: the cell's own), batch
    "box_qp": ("box_qp.admm_train", None, None),
    "markowitz_fast": ("markowitz.rescue_train", None, None),
    "markowitz_rescue": ("markowitz.rescue_train", "rescue_args", 64),
    "lml": ("lml.ipm_train", None, None),
}


def _polish_case(case, device, seed):
    """(polish, inputs) of one cell's polish at the cell's settings and
    batch: the layer's assembled data for a fresh draw, and the base
    solver's iterates (the same solver with no polish steps)."""
    name, stage, batch = _CASES[case]
    cell = load_cell(name)
    cfg = cell.config
    layer = _layer(cell, device)
    args = (dict(cfg[stage]) if stage
            else dict(cfg["solver_args"], **cell.mix.get("solver_args", {})))
    settings = _settings_from_args(layer._base_settings, args)
    gen = torch.Generator(device=device).manual_seed(seed)
    B = batch or cfg["batch"]
    params = cell.config_module().instances(cfg, gen, B, device)
    with torch.no_grad(), full_f32():
        _, ws, _, _ = layer.solve_and_state(
            *params, solver_args=dict(args, refine_steps=0))
        p_ext = layer._stack_params(params, B, [True] * len(params))
        P, q, A, b, _ = layer._assemble(p_ext)
    polish = make_refiner(
        layer.prog.dims, layer.prog.n, settings.refine_steps,
        schur_iters=settings.schur_iters, cg_iters=settings.cg_iters,
        p_diag_full=layer._p_diag_full, p_diag_only=layer._p_diag_only,
        kkt_mode=settings.kkt_mode)
    return polish, (ws.x, ws.y, ws.s, P, q, A, b)


def _bitwise(a, b):
    return all(torch.equal(u.view(torch.int32), v.view(torch.int32))
               for u, v in zip(a, b))


def _call(polish, args):
    with torch.no_grad(), full_f32():
        return polish(*args)


def _eager(polish, args):
    with torch.no_grad(), full_f32():
        return polish.fn(*args)


@pytest.mark.card
@pytest.mark.parametrize("case", list(_CASES))
def test_replay_equals_the_eager_polish_bitwise(card, case):
    polish, args = _polish_case(case, card, 11)
    want = _eager(polish, args)
    with profiling.recording(card) as rec:
        first = _call(polish, args)   # captures; the eager warm-up's answer
        second = _call(polish, args)  # replays
    torch.cuda.synchronize()
    assert rec.counts == {"polish_calls": 2, "polish_graph_replays": 1}
    assert _bitwise(first, want) and _bitwise(second, want)
    assert all(torch.isfinite(t).all() for t in second)


@pytest.mark.card
def test_a_key_is_captured_once_and_a_new_shape_adds_one(card):
    """Every call but the first of a key replays."""
    polish, args = _polish_case("box_qp", card, 12)
    half = tuple(t[: t.shape[0] // 2].contiguous() for t in args)
    with profiling.recording(card) as rec:
        for _ in range(3):
            _call(polish, args)
        _call(polish, half)
        _call(polish, half)
        _call(polish, args)
    assert rec.counts == {"polish_calls": 6, "polish_graph_replays": 4}
    assert len(polish.graphs) == 2


@pytest.mark.card
@pytest.mark.parametrize("case", ["box_qp", "markowitz_rescue"])
def test_replay_on_new_inputs_gives_their_eager_answer(card, case):
    polish, args = _polish_case(case, card, 13)
    _, other = _polish_case(case, card, 14)
    _call(polish, args)
    with profiling.recording(card) as rec:
        got = _call(polish, other)
    assert rec.counts == {"polish_calls": 1, "polish_graph_replays": 1}
    assert _bitwise(got, _eager(polish, other))


@pytest.mark.card
def test_returned_tensors_outlive_the_next_replay(card):
    polish, args = _polish_case("markowitz_fast", card, 15)
    _, other = _polish_case("markowitz_fast", card, 16)
    _call(polish, args)
    kept = _call(polish, args)
    copy = tuple(t.clone() for t in kept)
    _call(polish, other)
    torch.cuda.synchronize()
    assert _bitwise(kept, copy)
    assert not _bitwise(kept, _eager(polish, other))
