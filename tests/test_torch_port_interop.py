"""The port's cvxpy interop shim against the reference's: the mechanics.

cvxpy is not installed here, so, as tests/test_interop_stub.py does for
the reference, `tests/_cvxpy_stub.py` stands in for it under
`sys.modules["cvxpy"]` (through monkeypatch; the shim imports cvxpy
lazily, inside its functions). The same stub problem goes through both
packages' `convert_problem`, and the two converted problems stuff into
equal cone programs field for field (maps to 1e-14,
tests/_port_programs.py): no solve and no compile is needed for that.
These tests cover the conversion's mechanics (leaf attributes, the atom
dispatch, constraints, per-part duals, InteropError) and the layer's
acceptance of a cvxpy Problem; tests/test_torch_port_interop_cases.py
holds the converted layers to closed forms.
"""

import importlib
import sys

import numpy as np
import pytest
import torch
from _port_programs import assert_same_program

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.canon import cvxpy_interop as j_interop
from cvxpylayers_tpu.canon import stuff as j_stuff
from cvxpylayers_tpu_torch.canon import cvxpy_interop as interop
from cvxpylayers_tpu_torch.canon import stuff

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

try:
    import cvxpy as _real_cvxpy  # noqa: F401

    HAVE_REAL = True
except ImportError:
    HAVE_REAL = False


@pytest.fixture
def cp(monkeypatch):
    """The stub as `cvxpy` (skipped when the real one exists)."""
    if HAVE_REAL:
        pytest.skip("real cvxpy installed; the stub stands in for it only")
    stub = importlib.import_module("_cvxpy_stub")
    monkeypatch.setitem(sys.modules, "cvxpy", stub)
    yield stub


def assert_converts_like_reference(prob, params, variables):
    """Both packages convert `prob`; their programs stuff equal. Returns
    the port's (native, params, variables)."""
    out = interop.convert_problem(prob, params, variables)
    ref = j_interop.convert_problem(prob, params, variables)
    assert_same_program(stuff(out[0], out[1]), j_stuff(ref[0], ref[1]))
    assert [type(v).__name__ for v in out[2]] == [
        type(v).__name__ for v in ref[2]]
    return out


def test_is_cvxpy_problem(cp):
    x = cp.Variable(2)
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x)), [x >= 0])
    assert interop.is_cvxpy_problem(prob)
    assert not interop.is_cvxpy_problem(object())


def test_have_cvxpy_follows_the_import(monkeypatch):
    """cvxpy is imported when the shim runs, not when it is imported: a
    None entry in sys.modules makes `import cvxpy` raise ImportError."""
    monkeypatch.setitem(sys.modules, "cvxpy", None)
    assert not interop.have_cvxpy()
    assert not interop.is_cvxpy_problem(object())
    monkeypatch.setitem(sys.modules, "cvxpy",
                        importlib.import_module("_cvxpy_stub"))
    assert interop.have_cvxpy()


def test_leaf_attributes_carry_over(cp):
    x = cp.Variable(3, nonneg=True)
    S = cp.Variable((2, 2), symmetric=True)
    t = cp.Parameter(3, name="theta", pos=True)
    prob = cp.Problem(
        cp.Minimize(cp.sum_squares(x - t) + cp.trace(S)), [S >> 0]
    )
    native, (nt,), (nx, nS) = assert_converts_like_reference(
        prob, [t], [x, S])
    assert isinstance(nx, ct.Variable) and isinstance(nt, ct.Parameter)
    assert nx.nonneg and nS.symmetric
    assert nt.name == "theta" and nt.pos
    assert isinstance(native, ct.Problem) and native.is_dcp()


def test_unknown_atom_raises(cp):
    class frobnicate(cp.Expression):  # noqa: N801 — fake atom
        pass

    x = cp.Variable(2)
    prob = cp.Problem(cp.Minimize(frobnicate([x])))
    with pytest.raises(interop.InteropError, match="frobnicate"):
        interop.convert_problem(prob, [], [x])
    assert issubclass(interop.InteropError, ValueError)


def test_unknown_constraint_raises(cp):
    class Frobnicated(cp.Constraint):  # fake constraint kind
        pass

    x = cp.Variable(2)
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x)), [Frobnicated([x])])
    with pytest.raises(interop.InteropError, match="Frobnicated"):
        interop.convert_problem(prob, [], [x])


def test_soc_and_expcone_constraints_convert(cp):
    x = cp.Variable(3)
    t = cp.Variable()
    u = cp.Variable()
    prob = cp.Problem(
        cp.Minimize(t),
        [cp.SOC(t, x), cp.ExpCone(t, u, t + 1.0)],
    )
    native, _, _ = assert_converts_like_reference(prob, [], [t])
    kinds = [type(c).__name__ for c in native.constraints]
    assert "SOC" in kinds[0]
    assert any("Exp" in k for k in kinds)


def test_per_part_dual_variable_mapping(cp):
    x = cp.Variable(3)
    t = cp.Parameter(3)
    soc = cp.SOC(cp.sum(x), x)
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x - t)), [soc])
    native, _, n_vars = assert_converts_like_reference(
        prob, [t], [x, soc.dual_variables[0], soc.dual_variables[1]]
    )
    nat_con = native.constraints[0]
    assert n_vars[1] is nat_con.dual_variables[0]
    assert n_vars[2] is nat_con.dual_variables[1]
    # and the layer returns both parts in their shapes
    layer = ct.CvxpyLayer(prob, parameters=[t],
                          variables=[x, soc.dual_variables[0],
                                     soc.dual_variables[1]], device="cpu")
    xs, d0, d1 = layer(torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64))
    assert xs.shape == (3,) and d0.shape == () and d1.shape == (3,)


def test_constraint_in_variables_requests_its_dual(cp):
    x = cp.Variable(4)
    v = cp.Parameter(4)
    eq = cp.sum(x) == 1
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x - v)), [eq, x >= 0])
    native, _, (nx, nu) = assert_converts_like_reference(prob, [v], [x, eq])
    assert nu is native.constraints[0].dual_variables[0]


def test_bad_variables_entry_raises(cp):
    x = cp.Variable(2)
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x)), [x >= 0])
    with pytest.raises(interop.InteropError, match="variables entries"):
        interop.convert_problem(prob, [], [x, cp.Constant(np.ones(2))])
    with pytest.raises(interop.InteropError, match="not a cvxpy Problem"):
        interop.convert_problem(object(), [], [x])


def test_layer_accepts_a_cvxpy_problem_on_the_card_by_default(cp):
    """CvxpyLayer converts a cvxpy Problem, as the reference's layer
    does; the default device is the card (RuntimeError without CUDA, no
    fallback), device='cpu' runs here, and anything that is neither
    Problem raises ValueError."""
    x = cp.Variable(3)
    v = cp.Parameter(3)
    prob = cp.Problem(cp.Minimize(cp.sum_squares(x - v)),
                      [cp.sum(x) == 1, x >= 0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ct.CvxpyLayer(prob, parameters=[v], variables=[x])
    layer = ct.CvxpyLayer(prob, parameters=[v], variables=[x], device="cpu")
    ref = cj.CvxpyLayer(prob, parameters=[v], variables=[x])
    assert_same_program(layer.prog, ref.prog)
    assert all(isinstance(p, ct.Parameter) for p in layer.parameters)
    (xs,) = layer(torch.tensor([0.2, 0.5, 0.9], dtype=torch.float64))
    np.testing.assert_allclose(xs.numpy(), [0.0, 0.3, 0.7], atol=1e-7)
    with pytest.raises(ValueError, match="cvxpy Problem"):
        ct.CvxpyLayer(object(), parameters=[], variables=[x], device="cpu")


def test_maximize_and_affine_nodes_convert_like_reference(cp):
    """Maximize, matmul by a constant matrix, transpose, division,
    reshape, hstack/vstack and Zero/NonNeg constraints."""
    x = cp.Variable(4)
    y = cp.Variable(2)
    c = cp.Parameter(4)
    M = np.arange(8.0).reshape(2, 4) / 8.0
    obj = c @ x - cp.sum_squares(x) / 2.0 - cp.sum_squares(
        cp.reshape(cp.hstack([x[:2], y]), (2, 2)).T @ np.ones(2))
    prob = cp.Problem(cp.Maximize(obj), [
        cp.Zero(M @ x - y), cp.NonNeg(1.0 - x),
        cp.vstack([x[:2], y]) <= 3.0,
    ])
    native, _, _ = assert_converts_like_reference(prob, [c], [x, y])
    assert isinstance(native.objective, ct.Maximize)


def test_nonlinear_atoms_convert_like_reference(cp):
    x = cp.Variable(3)
    p = cp.Parameter(3)
    obj = (cp.sum(cp.exp(x)) - cp.sum(cp.log(x + 4.0))
           + cp.sum(cp.square(x - p)) + cp.sum(cp.abs(x))
           + cp.sum(cp.pos(x)) + cp.sum(cp.neg(x))
           + cp.log_sum_exp(x) + cp.sum(cp.power(x, 4))
           + cp.quad_form(x, np.eye(3) * 2.0)
           + cp.sum(cp.maximum(x, -1.0)) - cp.sum(cp.minimum(x, 1.0))
           + cp.norm(x, 1) + cp.norm(x, "inf") + cp.norm(x, 2)
           + cp.sum(cp.huber(x, 0.5)) + cp.quad_over_lin(x, 2.0)
           - cp.sum(cp.entr(x + 4.0)) + cp.sum(cp.logistic(x)))
    assert_converts_like_reference(cp.Problem(cp.Minimize(obj)), [p], [x])


def test_gp_problem_through_the_shim_matches_reference(cp):
    """A geometric program handed over as a cvxpy Problem: the log-space
    program the port's layer stuffs equals the reference layer's."""
    x = cp.Variable(pos=True)
    y = cp.Variable(pos=True)
    a = cp.Parameter(pos=True)
    prob = cp.Problem(cp.Minimize(x * y + cp.power(x, -1.0)),
                      [a * x <= y, y <= 4.0])
    layer = ct.CvxpyLayer(prob, parameters=[a], variables=[x, y], gp=True,
                          device="cpu")
    ref = cj.CvxpyLayer(prob, parameters=[a], variables=[x, y], gp=True)
    assert_same_program(layer.prog, ref.prog)
    xs, ys = layer(torch.tensor(0.5, dtype=torch.float64),
                   solver_args={"solve_method": "ipm"})
    # y = a x is active: min a x^2 + 1/x at x = (2a)^(-1/3)
    np.testing.assert_allclose(float(xs), 1.0, atol=1e-5)
    np.testing.assert_allclose(float(ys), 0.5, atol=1e-5)
