"""The port's model zoo and profiling utilities against the reference's.

Every factory of cvxpylayers_tpu_torch/models/zoo.py is held to its
counterpart in cvxpylayers_tpu/models/zoo.py: the stuffed cone programs
are equal field for field (maps to 1e-14, tests/_port_programs.py), and
the port's layer on the CPU in f64 meets the closed form or independent
oracle that tests/test_models.py holds the reference to, at the same
tolerances. `box_qp` and `sparsemax` are also solved by both packages on
the same seeded inputs: outputs and gradients agree within 1e-6 (_ATOL,
as tests/test_torch_port_layer.py). The profiling tests hold
utils/profiling.py to tests/test_profiling.py's contracts on torch: a
PhaseTimer accumulates, a trace_annotation shows by name in a CPU
torch.profiler trace, and problem_summary equals the reference's dict.
Every factory builds on the card unless asked for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import scipy.special
import torch
from _port_programs import assert_same_program

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu import models as jmodels
from cvxpylayers_tpu.utils.profiling import problem_summary as j_summary
from cvxpylayers_tpu_torch import models
from cvxpylayers_tpu_torch.utils import (
    PhaseTimer,
    problem_summary,
    trace_annotation,
)

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-6
# the exp-cone layers by the interior-point method: the same answer as
# ADMM within the tolerances below, several times faster on the CPU
_IPM = {"solve_method": "ipm"}


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def simplex_projection(v):
    n = v.size
    u = np.sort(v)[::-1]
    css = np.cumsum(u) - 1
    ks = np.arange(1, n + 1)
    rho = np.max(ks[u - css / ks > 0])
    tau = css[rho - 1] / rho
    return np.maximum(v - tau, 0)


def _slsqp(x, cons, bounds=None, x0=None):
    return scipy.optimize.minimize(
        lambda z: 0.5 * np.sum((z - x) ** 2),
        np.zeros_like(x) if x0 is None else x0, constraints=cons,
        bounds=bounds, method="SLSQP",
        options={"ftol": 1e-14, "maxiter": 300}).x


# ----------------------------------------------------- closed forms, by layer


def _relu(layer, r):
    x = r.standard_normal(6)
    xt = _t(x).requires_grad_()
    (y,) = layer(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.maximum(x, 0),
                               atol=1e-7)
    J = torch.autograd.functional.jacobian(lambda v: layer(v)[0], _t(x))
    np.testing.assert_allclose(J.numpy(), np.diag((x > 0).astype(float)),
                               atol=1e-6)


def _sigmoid(layer, r):
    x = r.standard_normal(5)
    (y,) = layer(_t(x), solver_args=_IPM)
    np.testing.assert_allclose(y.numpy(), scipy.special.expit(x), atol=1e-6)


def _softmax(layer, r):
    x = r.standard_normal(5)
    (y,) = layer(_t(x), solver_args=_IPM)
    np.testing.assert_allclose(y.numpy(), scipy.special.softmax(x),
                               atol=1e-6)


def _sparsemax(layer, r):
    X = r.standard_normal((9, 7)) * 2
    (Y,) = layer(_t(X))
    for i in range(9):  # the batched zoo
        np.testing.assert_allclose(Y[i].numpy(), simplex_projection(X[i]),
                                   atol=1e-6)


def _csoftmax(layer, r):
    # u=0.3 caps the largest weights: the KKT form is min(u, e^(x+nu))
    x = r.standard_normal(6) * 2
    (y,) = layer(_t(x), solver_args=_IPM)
    nu = scipy.optimize.brentq(
        lambda t: np.minimum(0.3, np.exp(x + t - 1)).sum() - 1, -50, 50)
    np.testing.assert_allclose(y.numpy(), np.minimum(0.3, np.exp(x + nu - 1)),
                               atol=1e-6)


def _csparsemax(layer, r):
    x = r.standard_normal(6) * 3
    (y,) = layer(_t(x))
    y = y.numpy()
    assert abs(y.sum() - 1) < 1e-6
    assert np.all(y <= 0.3 + 1e-7) and np.all(y >= -1e-7)
    ref = _slsqp(x, [{"type": "eq", "fun": lambda z: z.sum() - 1},
                     {"type": "ineq", "fun": lambda z: z},
                     {"type": "ineq", "fun": lambda z: 0.3 - z}],
                 x0=np.ones(6) / 6)
    np.testing.assert_allclose(y, ref, atol=1e-5)


def _lml(layer, r):
    x = r.standard_normal(6)
    (y,) = layer(_t(x), solver_args=_IPM)
    y = y.numpy()
    assert abs(y.sum() - 2) < 1e-6
    nu = scipy.optimize.brentq(
        lambda t: scipy.special.expit(x + t).sum() - 2, -50, 50)
    np.testing.assert_allclose(y, scipy.special.expit(x + nu), atol=1e-6)


def _box_qp(layer, r):
    x = r.standard_normal(5)
    G = r.standard_normal((3, 5))
    h = np.abs(r.standard_normal(3)) + 0.5
    (y,) = layer(_t(x), _t(G), _t(h))
    ref = _slsqp(x, [{"type": "ineq", "fun": lambda z: h - G @ z}],
                 bounds=[(0, 1)] * 5, x0=np.clip(x, 0, 1))
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-5)


def _ellipsoid(layer, r):
    x = r.standard_normal(4) * 3
    A = np.eye(4) * 0.5 + 0.05 * r.standard_normal((4, 4))
    b = 0.1 * r.standard_normal(4)
    (y,) = layer(_t(x), _t(A), _t(b))
    y = y.numpy()
    assert np.linalg.norm(A @ y + b) <= 1 + 1e-7
    ref = _slsqp(x, [{"type": "ineq",
                      "fun": lambda z: 1 - np.linalg.norm(A @ z + b)}])
    np.testing.assert_allclose(y, ref, atol=1e-4)


def _markowitz(layer, r):
    mu = _t(r.standard_normal(6) * 0.1).requires_grad_()
    F = _t(r.standard_normal((6, 6)) / np.sqrt(6))
    (w,) = layer(mu, F)
    w_np = w.detach().numpy()
    assert abs(w_np.sum() - 1) < 1e-6 and np.all(w_np >= -1e-7)
    (w ** 2).sum().backward()
    assert torch.isfinite(mu.grad).all()


def _logistic(layer, r):
    X = r.standard_normal((12, 3))
    yv = r.choice([-1.0, 1.0], 12)
    Xy = -yv[:, None] * X
    (beta,) = layer(_t(Xy), solver_args=_IPM)

    def obj(b):
        return np.sum(np.logaddexp(0, Xy @ b)) + 1e-1 * np.sum(b ** 2)

    ref = scipy.optimize.minimize(obj, np.zeros(3), method="BFGS",
                                  options={"gtol": 1e-12}).x
    np.testing.assert_allclose(beta.numpy(), ref, atol=1e-5)


# (name, factory arguments, closed-form check)
ZOO = [
    ("relu", (6,), {}, _relu),
    ("sigmoid", (5,), {}, _sigmoid),
    ("softmax", (5,), {}, _softmax),
    ("sparsemax", (7,), {}, _sparsemax),
    ("csoftmax", (6,), {"u": 0.3}, _csoftmax),
    ("csparsemax", (6,), {"u": 0.3}, _csparsemax),
    ("lml", (6, 2), {}, _lml),
    ("box_qp", (5, 3), {}, _box_qp),
    ("ellipsoid_projection", (4,), {}, _ellipsoid),
    ("markowitz", (6,), {"gamma": 0.5}, _markowitz),
    ("logistic_regression_layer", (3, 12), {"reg": 1e-1}, _logistic),
]


@pytest.mark.parametrize("name,args,kw,check", ZOO, ids=[z[0] for z in ZOO])
def test_factory_matches_reference_program_and_closed_form(name, args, kw,
                                                           check):
    """The factory's stuffed program equals the reference factory's, and
    the port's layer meets the closed form on the CPU in f64."""
    if not torch.cuda.is_available():
        # device=None means the card: without CUDA the factory raises
        # and never falls back to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(models, name)(*args, **kw)
    layer = getattr(models, name)(*args, device="cpu", **kw)
    assert layer.device == torch.device("cpu")
    assert_same_program(layer.prog,
                        getattr(jmodels, name)(*args, **kw).prog)
    check(layer, np.random.default_rng(11))


def _jax_and_port(name, args, params, grad_of):
    """Outputs and d sum(out^2) / d params[grad_of] of both packages'
    zoo layer on the same f64 inputs."""
    jl = getattr(jmodels, name)(*args)
    pl = getattr(models, name)(*args, device="cpu")
    jp = [jnp.asarray(p) for p in params]

    def jloss(v):
        q = list(jp)
        q[grad_of] = v
        return jnp.sum(jl(*q)[0] ** 2)

    (jout,) = jl(*jp)
    jgrad = jax.jit(jax.grad(jloss))(jp[grad_of])
    tp = [_t(p) for p in params]
    tp[grad_of].requires_grad_()
    (pout,) = pl(*tp)
    (pout ** 2).sum().backward()
    return (np.asarray(jout), np.asarray(jgrad),
            pout.detach().numpy(), tp[grad_of].grad.numpy())


def test_box_qp_outputs_and_gradients_match_reference_zoo_layer():
    r = np.random.default_rng(5)
    params = [r.standard_normal((3, 5)), r.standard_normal((3, 3, 5)) * 0.3,
              np.abs(r.standard_normal((3, 3))) + 1.0]
    jout, jgrad, pout, pgrad = _jax_and_port("box_qp", (5, 3), params, 1)
    np.testing.assert_allclose(pout, jout, atol=_ATOL)
    np.testing.assert_allclose(pgrad, jgrad, atol=_ATOL)


def test_sparsemax_outputs_and_gradients_match_reference_zoo_layer():
    """The direct call takes the shared constant-P/A route in both
    packages."""
    r = np.random.default_rng(6)
    params = [r.standard_normal((4, 7)) * 2]
    jout, jgrad, pout, pgrad = _jax_and_port("sparsemax", (7,), params, 0)
    np.testing.assert_allclose(pout, jout, atol=_ATOL)
    np.testing.assert_allclose(pgrad, jgrad, atol=_ATOL)


def _simplex(mod, **kw):
    x = mod.Variable(3)
    v = mod.Parameter(3)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [mod.sum(x) == 1, x >= 0])
    return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)


def test_phase_timer_accumulates():
    t = PhaseTimer()
    layer = _simplex(ct, device="cpu")
    vv = _t(np.ones(3))
    with t.phase("solve"):
        layer(vv)
    out = []
    with t.phase("solve", block_on=out):
        out.extend(layer(vv))
    with t.phase("backward", block_on={"x": out, "none": None}):
        pass
    assert t.counts == {"solve": 2, "backward": 1}
    assert t.totals["solve"] > 0
    assert "solve:" in t.summary() and "over 2 calls" in t.summary()


def test_trace_annotation_names_a_profiler_range():
    """The annotation is a record_function range: it shows by name among
    a CPU torch.profiler trace's events, around the layer's operators."""
    from torch.profiler import ProfilerActivity, profile

    layer = _simplex(ct, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_annotation("solve-region"):
            layer(_t(np.ones(3)))
    names = [e.key for e in prof.key_averages()]
    assert "solve-region" in names
    assert len(names) > 10  # the solve's own operators beside it


def test_problem_summary_equals_reference():
    def gp_layer(mod, **kw):
        x = mod.Variable(pos=True)
        y = mod.Variable(pos=True)
        a = mod.Parameter(pos=True)
        prob = mod.Problem(mod.Minimize(x * y), [a / (x * y) <= 1,
                                                 x >= y ** 0.5])
        return mod.CvxpyLayer(prob, parameters=[a], variables=[x, y],
                              gp=True, **kw)

    for build, gp in ((_simplex, False), (gp_layer, True)):
        s = problem_summary(build(ct, device="cpu"))
        assert s == j_summary(build(cj))
        assert s["gp"] is gp
    s = problem_summary(_simplex(ct, device="cpu"))
    assert s["n"] == 3 and s["dims"]["zero"] == 1
    assert s["dims"]["nonneg"] == 3 and s["nnz_A"] > 0
