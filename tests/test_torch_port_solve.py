"""The port's plain solve (Problem.solve) against the reference's.

layer/cvxpylayer.py::solve_problem builds one layer per (gp flag,
device), cached on the problem, solves the parameters' current values
once through `solve_values` (the per-instance solve with the canonical
objective 0.5 x'Px + q'x + offset computed outside the solve's autograd
rule) and fills `problem.status` (cvxpy's strings), `problem.value`
(negated for Maximize, exp'd under gp, +-inf on infeasible and unbounded
problems), `solver_stats`, `Variable.value` and `DualVariable.value`.
The contracts are those of tests/test_problem_solve.py, on the port with
device="cpu"; where the reference's solve is cheap to compile (the
polyhedral, SOC and PSD programs), the same problem built in both DSLs
from the same seeded values is solved by both packages and the values,
variables and duals agree within 1e-8 at f64. The default device is the
card: without one, Problem.solve() raises and never falls back to the
CPU.
"""

import numpy as np
import pytest
import scipy.optimize
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu_torch.solver.settings import MAX_ITERS

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_ATOL = 1e-8
_R = np.random.default_rng(11)
_C4 = _R.standard_normal(4)
_CONE_V = _R.standard_normal(3) * 2
_CONE_M = _R.standard_normal((3, 3))


def _lp(pk):
    x = pk.Variable(4)
    c = pk.Parameter(4)
    c.value = _C4
    return pk.Problem(pk.Minimize(c @ x), [x >= -1, x <= 1]), x, c


def _qp(pk):
    y = pk.Variable(3)
    t = np.array([0.3, -0.7, 2.0])
    con = y <= 1
    return pk.Problem(pk.Minimize(pk.sum_squares(y - t)), [con]), y, con


def _cone_duals(pk):
    """An SOC and a PSD constraint, whose duals come back in parts of the
    constraint's shapes: the t-part (), the x-part (3,), the 3x3 matrix."""
    x = pk.Variable(3)
    X = pk.Variable((3, 3))
    v = pk.Parameter(3)
    M = pk.Parameter((3, 3))
    v.value, M.value = _CONE_V, _CONE_M
    soc = pk.SOC(pk.Constant(1.0), x)
    psd = X >> 0
    prob = pk.Problem(
        pk.Minimize(pk.sum_squares(x - v) + pk.sum_squares(X - M)),
        [soc, psd, pk.trace(X) <= 1.0])
    return prob, (x, X), [soc, psd]


def _assert_close(got, want, atol=_ATOL):
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_lp_matches_linprog_and_reference():
    prob, x, c = _lp(ct)
    val = prob.solve(device="cpu")
    ref = scipy.optimize.linprog(c.value, bounds=[(-1, 1)] * 4)
    np.testing.assert_allclose(val, ref.fun, atol=1e-8)
    np.testing.assert_allclose(x.value, ref.x, atol=1e-7)
    assert prob.status == "optimal" and prob.value == val
    rprob, rx, _ = _lp(cj)
    _assert_close(val, rprob.solve())
    _assert_close(x.value, rx.value)
    for con, rcon in zip(prob.constraints, rprob.constraints):
        _assert_close(con.dual_variables[0].value,
                      rcon.dual_variables[0].value)


def test_zero_parameter_qp_and_duals():
    prob, y, con = _qp(ct)
    t = np.array([0.3, -0.7, 2.0])
    val = prob.solve(device="cpu")
    want = np.clip(t, None, 1.0)
    np.testing.assert_allclose(val, ((want - t) ** 2).sum(), atol=1e-9)
    np.testing.assert_allclose(y.value, want, atol=1e-8)
    # KKT: active rows carry dual 2 (t - 1)
    np.testing.assert_allclose(con.dual_value, np.maximum(2 * (t - 1), 0),
                               atol=1e-7)
    rprob, ry, rcon = _qp(cj)
    _assert_close(val, rprob.solve())
    _assert_close(y.value, ry.value)
    _assert_close(con.dual_value, rcon.dual_value)


def test_cone_duals_fill_dual_values_in_their_shapes():
    """solve_problem fills every DualVariable.value from the recovered
    outputs: the SOC t-part is a scalar, its x-part and the PSD matrix
    have the constraint's shapes, all equal to the reference's."""
    prob, (x, X), cons = _cone_duals(ct)
    val = prob.solve(device="cpu")
    rprob, (rx, rX), rcons = _cone_duals(cj)
    rval = rprob.solve()
    assert prob.status == rprob.status == "optimal"
    _assert_close(val, rval)
    _assert_close(x.value, rx.value)
    _assert_close(X.value, rX.value)
    shapes = []
    for con, rcon in zip(cons, rcons):
        for d, rd in zip(con.dual_variables, rcon.dual_variables):
            shapes.append(np.shape(d.value))
            _assert_close(d.value, rd.value)
    assert shapes == [(), (3,), (3, 3)]
    assert isinstance(x.value, np.ndarray)


def test_maximize_and_cached_resolve():
    x = ct.Variable(4)
    c = ct.Parameter(4)
    prob = ct.Problem(ct.Maximize(c @ x), [x >= -1, x <= 1])
    c.value = np.abs(_R.standard_normal(4))
    np.testing.assert_allclose(prob.solve(device="cpu"), c.value.sum(),
                               atol=1e-7)
    (layer, _, _), = prob._solve_layers.values()
    c.value = np.abs(_R.standard_normal(4)) + 1.0
    # the re-solve reuses the cached canonicalization and solver
    np.testing.assert_allclose(prob.solve(device=torch.device("cpu")),
                               c.value.sum(), atol=1e-7)
    assert len(prob._solve_layers) == 1
    assert next(iter(prob._solve_layers.values()))[0] is layer
    np.testing.assert_allclose(x.value, np.ones(4), atol=1e-7)


def test_socp():
    v = _R.standard_normal(5) * 2
    x = ct.Variable(5)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(x - v)),
                      [ct.norm(x, 2) <= 1.0])
    prob.solve(device="cpu")
    np.testing.assert_allclose(x.value, v / max(np.linalg.norm(v), 1.0),
                               atol=1e-7)
    assert prob.status == "optimal"


def test_infeasible_and_unbounded():
    z = ct.Variable(2)
    pi = ct.Problem(ct.Minimize(ct.sum(z)), [z >= 1, z <= 0])
    assert pi.solve(device="cpu") == float("inf")
    assert pi.status == "infeasible"
    assert z.value is None
    assert pi.constraints[0].dual_value is None
    pu = ct.Problem(ct.Minimize(ct.sum(z)), [z <= 0])
    assert pu.solve(device="cpu") == float("-inf")
    assert pu.status == "unbounded"


def test_maximize_infeasible_and_unbounded_signs():
    """Under Maximize an infeasible problem is worth -inf and an
    unbounded one +inf (cvxpy's convention)."""
    z = ct.Variable(2)
    pi = ct.Problem(ct.Maximize(ct.sum(z)), [z >= 1, z <= 0])
    assert pi.solve(device="cpu") == float("-inf")
    assert pi.status == "infeasible"
    pu = ct.Problem(ct.Maximize(ct.sum(z)), [z >= 0])
    assert pu.solve(device="cpu") == float("inf")
    assert pu.status == "unbounded"


def test_gp():
    xg = ct.Variable((), pos=True)
    yg = ct.Variable((), pos=True)
    prob = ct.Problem(ct.Minimize(xg * yg + 1.0 / (xg * yg)),
                      [xg * yg <= 2.0, xg >= 0.5])
    val = prob.solve(gp=True, device="cpu")
    # min t + 1/t over reachable t = x*y: optimum at t = 1
    np.testing.assert_allclose(val, 2.0, atol=1e-6)
    np.testing.assert_allclose(float(xg.value) * float(yg.value), 1.0,
                               atol=1e-6)
    assert prob.status == "optimal"


def test_missing_parameter_value_raises():
    x = ct.Variable(2)
    c = ct.Parameter(2)
    prob = ct.Problem(ct.Minimize(c @ x), [x >= 0, x <= 1])
    with pytest.raises(ValueError, match="has no value"):
        prob.solve(device="cpu")


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    """Without `device`, Problem.solve targets CUDA; on a machine without
    it the call raises before building anything, and caches nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob, x, _ = _lp(ct)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prob.solve()
    assert x.value is None and prob.status is None
    assert not getattr(prob, "_solve_layers", {})


def test_cache_is_keyed_by_gp_flag_and_device():
    """A problem that is both DCP and DGP keeps one layer per gp flag;
    the same device, named two ways, reuses its layer."""
    x = ct.Variable((), pos=True)
    prob = ct.Problem(ct.Minimize(x), [x >= 2.0])
    np.testing.assert_allclose(prob.solve(device="cpu"), 2.0, atol=1e-7)
    np.testing.assert_allclose(prob.solve(gp=True, device="cpu"), 2.0,
                               atol=1e-6)
    prob.solve(gp=True, device=torch.device("cpu"))
    assert sorted(prob._solve_layers) == [
        (False, torch.device("cpu")), (True, torch.device("cpu"))]
    assert [layer.gp for layer, _, _ in prob._solve_layers.values()] == [
        False, True]


def test_solver_stats_and_solver_args():
    """solver_stats carries the iteration count, a positive solve time
    and the solver's name; solver_args reach the layer: the IPM gives the
    same value, and one ADMM iteration without polish ends
    "optimal_inaccurate" with the values still filled."""
    prob, x, _ = _lp(ct)
    val = prob.solve(device="cpu")
    stats = prob.solver_stats
    assert stats.solver_name == "cvxpylayers_tpu_torch"
    assert isinstance(stats.num_iters, int) and stats.num_iters > 0
    assert stats.solve_time > 0
    np.testing.assert_allclose(
        prob.solve(solver_args={"solve_method": "ipm"}, device="cpu"), val,
        atol=1e-8)
    short = prob.solve(solver_args={"max_iters": 1, "epoch": 1,
                                    "refine_steps": 0}, device="cpu")
    assert prob.status == "optimal_inaccurate" and np.isfinite(short)
    assert x.value is not None and x.value.shape == (4,)
    from cvxpylayers_tpu_torch.layer.cvxpylayer import _STATUS_STRINGS
    assert _STATUS_STRINGS[MAX_ITERS] == "optimal_inaccurate"


def test_solve_values_objective_is_differentiable():
    """solve_values returns the canonical objective (the offset
    included) as plain differentiable torch, unbatched; its gradient in
    the cost vector of an LP is the solution."""
    x = ct.Variable(3)
    c = ct.Parameter(3)
    prob = ct.Problem(ct.Minimize(c @ x + 2.5), [x >= -1, x <= 1])
    layer = ct.CvxpyLayer(prob, parameters=[c], variables=[x], device="cpu")
    cv = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64,
                      requires_grad=True)
    (xs,), status, iters, pobj = layer.solve_values(cv)
    assert int(status) == 0 and pobj.shape == () and xs.shape == (3,)
    np.testing.assert_allclose(pobj.item(), -3.5 + 2.5, atol=1e-8)
    pobj.backward()
    np.testing.assert_allclose(cv.grad.numpy(), [-1.0, 1.0, -1.0],
                               atol=1e-7)
    with pytest.raises(ValueError, match="unbatched"):
        layer.solve_values(cv.detach()[None])
