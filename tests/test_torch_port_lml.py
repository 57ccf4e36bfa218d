"""The LML projection layer of the port's model zoo against its closed form.

`models.zoo.lml(n, k)` is the Limited Multi-Label projection (Amos,
Koltun and Kolter 2019): argmax x'y + sum H(y) + sum H(1 - y) s.t.
1'y = k. Canonicalised it is two exponential cones per coordinate and
one equality row, so `solve_method="ipm"` takes the primal-dual form
with nonsymmetric scalings. The port's answers and gradients are held
to the benchmark's plain reference (cvxbench/reference/lml_top5.py:
y = sigmoid(x + nu) with nu bisected to the last bit, the gradient by
the implicit function theorem), which imports nothing of either
package, so no JAX runs here. Also: the sparse route refuses the IPM at
n = 100 as the JAX package does, the f32 IPM stops a lane that jams
(its merit no longer falls) well before ipm_max_iters, and the
solver's spans and counters (utils/profiling.py) record when asked and
cost nothing otherwise.
"""

import pytest
import torch

from cvxbench.reference import lml_top5 as ref
from cvxpylayers_tpu_torch.models import zoo
from cvxpylayers_tpu_torch.utils import problem_summary, profiling

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

# the benchmark configuration's solver settings (cvxbench/configs/
# lml_top5.json)
_F32 = {"solve_method": "ipm", "assembly": "dense", "eps_abs": 1e-4,
        "eps_rel": 1e-4, "ipm_eps_abs": 1e-5, "refine_steps": 3,
        "cg_iters": 70}
# f64 at the package's default tolerances (eps 1e-8, polish of 10 steps)
_F64 = {"solve_method": "ipm"}


def _logits(seed, B, n, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return 2.0 * torch.randn(B, n, generator=g, dtype=dtype)


@pytest.fixture(scope="module")
def small():
    """n = 10, k = 3, B = 4 in f64: the layer, x, ybar and the port's
    outputs, statuses, counts and gradient."""
    layer = zoo.lml(10, 3, device="cpu")
    x = _logits(1, 4, 10).requires_grad_()
    ybar = torch.randn(4, 10, generator=torch.Generator().manual_seed(2),
                       dtype=torch.float64)
    (y,), status, iters = layer.solve_with_info(x, solver_args=_F64)
    (y * ybar).sum().backward()
    return layer, x.detach(), ybar, y.detach(), status, iters, x.grad


@pytest.fixture(scope="module")
def small32():
    """The same lanes in f32 at the benchmark's settings."""
    layer = zoo.lml(10, 3, device="cpu")
    x = _logits(1, 4, 10, torch.float32).requires_grad_()
    ybar = torch.randn(4, 10, generator=torch.Generator().manual_seed(2))
    (y,), status, iters = layer.solve_with_info(x, solver_args=_F32)
    (y * ybar).sum().backward()
    return x.detach(), ybar, y.detach(), status, x.grad


def test_program_is_two_exp_cones_a_coordinate():
    s = problem_summary(zoo.lml(100, 5, device="cpu"))
    assert s["dims"]["exp"] == 200 and s["dims"]["zero"] == 1
    assert s["dims"]["nonneg"] == 0 and s["n"] == 300
    assert s["m"] == 601 and s["n_param"] == 100


def test_f64_lanes_are_solved(small):
    *_, status, iters, _ = small
    assert (status == 0).all()
    assert (iters < 100).all()


def test_f64_outputs_match_the_closed_form(small):
    _, x, _, y, *_ = small
    ys, _, ok = ref.solve(x, 3.0)
    assert ok.all()
    # the polish drives the KKT residuals to ~1e-10 at eps 1e-8; y moves
    # with them by at most the inverse curvature 1/(y(1-y)) <= 1e2 here
    assert (y - ys).abs().max() < 1e-7


def test_f64_gradients_match_the_implicit_function_theorem(small):
    _, x, ybar, y, *_, grad = small
    ys, _, _ = ref.solve(x, 3.0)
    want = ref.vjp(ys, ybar)
    # the adjoint's solve is exact in f64 (LU); what is left is the
    # forward's 1e-7-level error carried through d = y (1 - y)
    assert torch.allclose(grad, want, rtol=1e-6, atol=1e-7)


def test_f32_lanes_are_solved_within_eps(small32):
    x, _, y, status, _ = small32
    assert (status == 0).all()
    ys, _, _ = ref.solve(x, 3.0)
    # SOLVED certifies KKT residuals within eps 1e-4 (abs + rel); the
    # outputs then lie within that of the optimum, and the sum within it
    # of k
    assert (y.double() - ys).abs().max() < 1e-4
    assert (y.double().sum(-1) - 3.0).abs().max() < 1e-4


def test_f32_gradients_track_the_closed_form(small32):
    x, ybar, _, _, grad = small32
    ys, _, _ = ref.solve(x, 3.0)
    want = ref.vjp(ys, ybar.double())
    # the adjoint's CG reaches f32 rounding (~3e-7 of the largest
    # gradient); 1e-4 of it leaves room and still fails the control's
    # TF32-rounded sums (4e-5 median on the benchmark's lanes)
    err = (grad.double() - want).abs().amax(-1) / want.abs().amax(-1)
    assert err.max() < 1e-4


def test_one_lane_at_cifar100_width():
    layer = zoo.lml(100, 5, device="cpu")
    x = _logits(3, 1, 100, torch.float32)
    (y,), status, _ = layer.solve_with_info(x, solver_args=_F32)
    assert int(status[0]) == 0
    ys, _, _ = ref.solve(x, 5.0)
    assert (y.double() - ys).abs().max() < 1e-4


def test_auto_assembly_refuses_the_ipm_at_n100():
    layer = zoo.lml(100, 5, device="cpu")
    args = dict(_F32, assembly="auto")
    # m n = 601 * 300 is above the dense limit (2^16): the sparse route,
    # which takes ADMM and PDHG only, as in the JAX package
    with pytest.raises(ValueError, match="dense assembly"):
        layer.solve_with_info(_logits(4, 1, 100, torch.float32),
                              solver_args=args)


def _jammed_lane(dtype):
    """The 41st logit vector of the benchmark traffic's first 64 rows at
    B=16 under seed 2^31 + 7 (each step draws x, then ybar): its IPM
    presses the dual of one exp block against its boundary at mu ~1e-2."""
    g = torch.Generator().manual_seed(2 ** 31 + 7)
    for _ in range(2):
        torch.randn(16, 100, generator=g)
        torch.randn(16, 100, generator=g)
    x = 2.0 * torch.randn(16, 100, generator=g)
    return x[8:9].to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_jammed_lane_stops_and_the_polish_solves_it(dtype):
    layer = zoo.lml(100, 5, device="cpu")
    x = _jammed_lane(dtype)
    args = dict(_F32, ipm_max_iters=40)
    with profiling.recording() as rec:
        (y,), status, iters = layer.solve_with_info(x, solver_args=args)
    # from trip 8 on the merit stays at 1.15e-2 and the steps shrink to
    # ~1e-6: f64 stops three trips after they fall under 1e-6, f32 three
    # trips after the merit stops falling (it straddled 1e-6 and ran to
    # the cap under the step rule alone)
    assert int(iters[0]) < 20 and rec.counts["ipm_trips"] == int(iters[0])
    assert int(status[0]) == 0
    ys, _, _ = ref.solve(x, 5.0)
    assert (y.double() - ys).abs().max() < 1e-4


def test_counters_count_trips_and_eigh(small):
    layer, x, *_ = small
    with profiling.recording() as rec:
        (_,), _, iters = layer.solve_with_info(x, solver_args=_F64)
    # the loop runs until its slowest lane stops; one eigh of the exp
    # blocks' barrier Hessians each trip (build_T)
    assert rec.counts["ipm_trips"] == int(iters.max())
    assert rec.counts["eigh"] == rec.counts["ipm_trips"]


def test_spans_open_in_a_recording():
    layer = zoo.lml(10, 3, device="cpu")
    x = _logits(5, 2, 10).requires_grad_()
    with profiling.recording() as outer, profiling.recording() as inner:
        (y,), _, _ = layer.solve_with_info(x, solver_args=_F64)
        y.sum().backward()
    spans = {"ipm.iteration", "ipm.scaling", "ipm.kkt_factor",
             "ipm.kkt_solve", "ipm.step_length", "polish", "adjoint"}
    for rec in (outer, inner):
        ms = rec.span_ms()
        assert spans <= set(ms) and all(v >= 0 for v in ms.values())
        assert ms["ipm.scaling"] <= ms["ipm.iteration"]
    assert outer.counts == inner.counts


def test_spans_show_in_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    layer = zoo.lml(10, 3, device="cpu")
    # one trip and one polish step open every forward span; the raw
    # events, since key_averages() takes seconds on a CPU trace
    short = dict(_F64, ipm_max_iters=1, refine_steps=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        layer.solve_with_info(_logits(6, 2, 10), solver_args=short)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"cvxpylayers.ipm.iteration", "cvxpylayers.ipm.scaling",
            "cvxpylayers.ipm.kkt_factor", "cvxpylayers.ipm.kkt_solve",
            "cvxpylayers.ipm.step_length", "cvxpylayers.polish"} <= names


def test_nothing_is_kept_when_off():
    # no recording and no profiler: a span is one shared null context and
    # a count goes nowhere
    assert profiling.span("ipm.scaling") is profiling.span("polish")
    profiling.count("ipm_trips")
    with profiling.recording() as rec:
        pass
    assert rec.counts == {} and rec.marks == []
