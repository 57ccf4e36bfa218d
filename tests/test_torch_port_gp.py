"""The port's geometric programs (gp=True) against the reference.

canon/dgp.py (Dgp2Dcp, is_dgp) and expressions/atoms/gp.py are copies of
the reference's numpy modules: a gp layer rewrites its problem in log
space (log of positive variables, of parameters used multiplicatively;
exponents enter raw), then stuffs it as any convex program. The layer
logs the marked parameters before the parameter-affine maps and returns
exp of the log-space variables.

The contracts are those of tests/test_gp.py and tests/test_atoms_dgp.py:
- `is_dgp` and the gp layer's refusals agree with the reference's over
  the same expressions;
- each GP atom's log-space program equals the reference's exactly (the
  stuffed maps compared entry for entry: numpy, no solve);
- the atoms' numeric values equal the reference's;
- bench.py's GP layer (the reference's test_basic_gp problem) at B=4
  with bench.py's solver settings: outputs within 1e-8 and gradients of
  a seeded weighting within 1e-6 of the reference's, at f64 (one jitted
  reference value-and-gradient, ~25 s of compile);
- the atom layers solve to their closed forms on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from _port_programs import assert_same_program

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_R = np.random.default_rng(11)
_A34 = _R.standard_normal((3, 4))
_POS33 = np.abs(_R.standard_normal((3, 3))) + 0.1
_EIG33 = np.abs(_R.standard_normal((3, 3)))
_EIG33 = 0.5 * _EIG33 / np.max(np.abs(np.linalg.eigvals(_EIG33)))
# bench.py's row 5 settings (_tuned_args with its extras)
_BENCH_ARGS = {"eps_abs": 1e-4, "eps_rel": 1e-4, "admm_eps_abs": 1e-3,
               "admm_eps_rel": 1e-3, "max_iters": 300, "epoch": 100,
               "refine_steps": 4, "cg_iters": 15}
_IPM = {"solve_method": "ipm"}


def _bench_gp(pk):
    """bench.py's GP row: min 1/(xyz) s.t. a(xy + xz + yz) <= b,
    x >= y^c."""
    x, y, z = (pk.Variable((), pos=True) for _ in range(3))
    a = pk.Parameter((), pos=True)
    b = pk.Parameter((), pos=True)
    c = pk.Parameter(())
    prob = pk.Problem(pk.Minimize(1.0 / (x * y * z)),
                      [a * (x * y + x * z + y * z) <= b, x >= y ** c])
    return prob, [a, b, c], [x, y, z]


def _prod(pk):
    x = pk.Variable(4, pos=True)
    s = pk.Parameter((), pos=True)
    return (pk.Problem(pk.Maximize(pk.prod(x)), [pk.sum(x) <= s]), [s],
            [x])


def _gmatmul(pk):
    x = pk.Variable(4, pos=True)
    p = pk.Parameter(4, pos=True)
    return (pk.Problem(pk.Minimize(pk.sum(pk.gmatmul(_A34, x))), [x == p]),
            [p], [x])


def _one_minus_pos(pk):
    x = pk.Variable((), pos=True)
    p = pk.Parameter((), pos=True)
    return (pk.Problem(pk.Maximize(pk.one_minus_pos(x)), [x >= p]), [p],
            [x])


def _pf_eigenvalue(pk):
    X = pk.Variable((3, 3), pos=True)
    pA = pk.Parameter((3, 3), pos=True)
    return (pk.Problem(pk.Minimize(pk.pf_eigenvalue(X)), [X >= pA]), [pA],
            [X])


def _eye_minus_inv(pk):
    X = pk.Variable((3, 3), pos=True)
    pA = pk.Parameter((3, 3), pos=True)
    return (pk.Problem(pk.Minimize(pk.sum(pk.eye_minus_inv(X))),
                       [X == pA]), [pA], [X])


def _xexp(pk):
    x = pk.Variable((), pos=True)
    p = pk.Parameter((), pos=True)
    return pk.Problem(pk.Minimize(pk.xexp(x)), [x >= p]), [p], [x]


def _log(pk):
    x = pk.Variable((), pos=True)
    p = pk.Parameter((), pos=True)
    return pk.Problem(pk.Maximize(pk.log(x)), [x <= p]), [p], [x]


def _norm2(pk):
    x = pk.Variable(3, pos=True)
    p = pk.Parameter(3, pos=True)
    return pk.Problem(pk.Minimize(pk.norm(x, 2)), [x >= p]), [p], [x]


def _posynomial(pk):
    """A quotient, a sum of monomials (log-sum-exp in log space), a
    parameter exponent and a raw parameter in one program."""
    x = pk.Variable(2, pos=True)
    a = pk.Parameter((), pos=True)
    c = pk.Parameter(())
    prob = pk.Problem(
        pk.Minimize(x[0] / x[1] + 2.0 * x[1] ** c + x[0] * x[1]),
        [a * x[0] >= 1.0, x[1] <= 3.0])
    return prob, [a, c], [x]


_PROGRAMS = {
    "bench_gp": _bench_gp, "prod": _prod, "gmatmul": _gmatmul,
    "one_minus_pos": _one_minus_pos, "pf_eigenvalue": _pf_eigenvalue,
    "eye_minus_inv": _eye_minus_inv, "xexp": _xexp, "log": _log,
    "norm2": _norm2, "posynomial": _posynomial,
}


def _layer(pk, build, **kw):
    prob, params, variables = build(pk)
    return pk.CvxpyLayer(prob, parameters=params, variables=variables,
                         gp=True, **kw)


@pytest.mark.parametrize("name", list(_PROGRAMS))
def test_log_space_program_equals_reference(name):
    """The gp layer's stuffed log-space program: dims, sparsity and the
    parameter-affine maps entry for entry, the parameters' log mask and
    the output kinds."""
    tl = _layer(ct, _PROGRAMS[name], device="cpu")
    rl = _layer(cj, _PROGRAMS[name])
    assert_same_program(tl.prog, rl.prog)
    assert tl._gp_log_mask == rl._gp_log_mask
    assert [o[0] for o in tl._outputs] == [o[0] for o in rl._outputs]


def _dgp_cases(pk):
    x = pk.Variable((), pos=True)
    y = pk.Variable((), pos=True)
    v = pk.Variable(3, pos=True)
    a = pk.Parameter((), pos=True)
    c = pk.Parameter(())
    return {
        "monomial_ratio": (pk.Problem(pk.Minimize(1.0 / (x * y)),
                                      [a * (x + y) <= 1.0]), True),
        "subtraction": (pk.Problem(pk.Minimize(x - y)), False),
        "param_exponent": (pk.Problem(pk.Minimize(x ** c + y)), True),
        "negative_constant": (pk.Problem(pk.Minimize(x), [x >= -1.0]),
                              False),
        "prod_sum": (pk.Problem(pk.Maximize(pk.prod(v)),
                                [pk.sum(v) <= a]), True),
        "max_posynomial": (pk.Problem(pk.Maximize(x + y), [x * y <= 1.0]),
                           False),
        "one_minus_pos": (pk.Problem(pk.Maximize(pk.one_minus_pos(x)),
                                     [x >= a]), True),
        "log_of_sum": (pk.Problem(pk.Maximize(pk.log(x)), [x <= a]), True),
    }


def test_is_dgp_and_refusals_agree_with_reference():
    """Problem.is_dgp over the same problems in both packages, and the gp
    layer's refusals: a variable without pos=True, a non-DGP problem."""
    tcases, rcases = _dgp_cases(ct), _dgp_cases(cj)
    for key, (prob, want) in tcases.items():
        assert prob.is_dgp() == rcases[key][0].is_dgp() == want, key
    for pk, kw in ((ct, {"device": "cpu"}), (cj, {})):
        x = pk.Variable(())
        a = pk.Parameter((), pos=True)
        with pytest.raises(ValueError, match="DGP|pos"):
            pk.CvxpyLayer(pk.Problem(pk.Minimize(a * x), [x >= 1.0]),
                          parameters=[a], variables=[x], gp=True, **kw)
        xp = pk.Variable((), pos=True)
        yp = pk.Variable((), pos=True)
        with pytest.raises(ValueError, match="DGP"):
            pk.CvxpyLayer(pk.Problem(pk.Minimize(xp - yp)), parameters=[],
                          variables=[xp], gp=True, **kw)


def test_gp_atom_values_equal_reference():
    """The GP atoms' numeric values (numpy on the host) in both
    packages, and gmatmul's and eye_minus_inv's closed forms."""
    xv = np.array([2.0, 0.7, 1.3, 0.4])
    got, want = ({
        "gmatmul": pk.gmatmul(_A34, pk.Constant(xv)).value,
        "eye_minus_inv": pk.eye_minus_inv(pk.Constant(_EIG33)).value,
        "prod": pk.prod(pk.Constant(xv)).value,
        "one_minus_pos": pk.one_minus_pos(pk.Constant(xv / 3.0)).value,
        "pf_eigenvalue": pk.pf_eigenvalue(pk.Constant(_POS33)).value,
    } for pk in (ct, cj))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-12,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(got["gmatmul"], np.exp(_A34 @ np.log(xv)),
                               rtol=1e-12)
    np.testing.assert_allclose(got["eye_minus_inv"],
                               np.linalg.inv(np.eye(3) - _EIG33),
                               rtol=1e-12)


@pytest.fixture(scope="module")
def bench_ref():
    """bench.py's GP layer at B=4 in the reference: one jitted value-and-
    gradient of a seeded weighting of x, y and z."""
    r = np.random.default_rng(0)
    B = 4
    arrs = [np.abs(r.standard_normal(B)) + 1.0,
            np.abs(r.standard_normal(B)) + 3.0, r.uniform(0.3, 0.9, B)]
    weights = [r.standard_normal(B) for _ in range(3)]
    rl = _layer(cj, _bench_gp)

    def loss(*params):
        outs = rl(*params, solver_args=_BENCH_ARGS)
        return sum(jnp.sum(jnp.asarray(w) * o)
                   for w, o in zip(weights, outs)), outs

    grads, outs = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in arrs))
    return (arrs, weights, [np.asarray(o) for o in outs],
            [np.asarray(g) for g in grads])


def test_bench_gp_layer_matches_reference(bench_ref):
    arrs, weights, want, want_g = bench_ref
    layer = _layer(ct, _bench_gp, device="cpu")
    params = [torch.tensor(a, requires_grad=True) for a in arrs]
    outs, status, _ = layer.solve_with_info(*params,
                                            solver_args=_BENCH_ARGS)
    assert (status == 0).all()
    for got, ref in zip(outs, want):
        assert tuple(got.shape) == ref.shape == (4,)
        assert (got > 0).all()
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-8,
                                   rtol=0)
    sum((torch.as_tensor(w) * o).sum() for w, o in zip(weights, outs)
        ).backward()
    for p, ref in zip(params, want_g):
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-6, rtol=0)


def test_prod_on_the_simplex_and_its_gradient():
    """max prod(x) s.t. sum(x) <= s: x_i = s/n, so d sum(x)/ds = 1 (by
    the IPM and its adjoint)."""
    layer = _layer(ct, _prod, device="cpu")
    s = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    (xs,) = layer(s, solver_args=_IPM)
    np.testing.assert_allclose(xs.detach().numpy(), np.full(4, 0.5),
                               atol=1e-5)
    xs.sum().backward()
    np.testing.assert_allclose(s.grad.item(), 1.0, atol=1e-4)


def test_atom_layers_solve_to_their_closed_forms():
    """test_atoms_dgp.py's pinned and log-log layers on the port: the
    solution is the pinned or bounding parameter, and pf(X) at X = A is
    A's Perron-Frobenius eigenvalue. By the IPM (its primal-dual form on
    these exp-cone programs: 10-23 iterations, 3-10x faster here than
    ADMM's 50-650)."""
    pv = np.abs(_R.standard_normal(4)) + 0.5
    cases = (
        (_gmatmul, pv, pv, 1e-6),
        (_one_minus_pos, np.float64(0.3), 0.3, 1e-6),
        (_eye_minus_inv, _EIG33, _EIG33, 1e-4),
        (_xexp, np.float64(1.7), 1.7, 1e-5),
        (_log, np.float64(3.0), 3.0, 1e-5),
        (_norm2, np.array([1.0, 2.0, 0.5]), np.array([1.0, 2.0, 0.5]),
         1e-5),
    )
    for build, arg, want, rtol in cases:
        layer = _layer(ct, build, device="cpu")
        (xs,) = layer(torch.tensor(arg), solver_args=_IPM)
        np.testing.assert_allclose(xs.numpy(), want, rtol=rtol,
                                   atol=1e-6, err_msg=build.__name__)
    (Xs,) = _layer(ct, _pf_eigenvalue, device="cpu")(torch.tensor(_POS33),
                                                     solver_args=_IPM)
    np.testing.assert_allclose(
        np.max(np.real(np.linalg.eigvals(Xs.numpy()))),
        np.max(np.real(np.linalg.eigvals(_POS33))), rtol=1e-5)
