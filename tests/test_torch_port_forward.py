"""The port's forward-mode derivative and its f32 spectral KKT solve,
against the reference.

The f32 spectral-Schur KKT solve (solver/kkt.py, kkt_mode="spectral")
first: on one general-cone structure with m > MASKED_MAX_DIM rows (an SOC
block and 170 nonneg rows, n = 30, a nearly rank-deficient P as in the
Markowitz rows), both packages' f32 solves are held against the f64 solve
of the same system in both directions. The reference factors the saddle
matrix S by Cholesky above that size and applies it by two triangular
solves; an explicit f32 inverse of S, which the port formed at every
size, carries a backward error about cond(S) times larger: there the
median over 16 lanes of the port's error over the reference's was 12
(J) and 12.5 (J'). It must be at most 2: the port now applies the two
triangular factors of S^{-1} in turn (1.00 and 1.15; by two triangular
solves, as the reference, 1.01 and 1.11).

Then derivative="forward" (diff/derivative.py, the jvp of the implicit
solve) through CvxpyLayer with torch.autograd.forward_ad dual tensors,
against jax.jvp through the reference layer on the same f64 inputs, on
one structure per base solver (ADMM on a box-QP, the interior-point
method on the same box-QP, PDHG on a box-LP, ADMM on an SOC projection):
statuses equal, outputs and tangents within 1e-6. A stack of JVPs over
the basis tangents of one parameter is held against jax.jacfwd and
against the port's own reverse-mode Jacobian. As in the reference, each
setting has one rule: a backward pass through a forward-mode solve
raises (the reference's custom_jvp cannot be transposed under jax.grad)
and so does a forward-mode pass through the default adjoint solve.

Reference configurations compiled: the spectral solve at f64 and f32,
four layer JVPs, one jacfwd, one failing jax.grad trace.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.solver.kkt import make_kkt_solver as j_kkt_solver
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.diff.derivative import make_diff_solver
from cvxpylayers_tpu_torch.solver.kkt import make_kkt_solver as t_kkt_solver
from cvxpylayers_tpu_torch.solver.settings import SOLVED
from cvxpylayers_tpu_torch.solver.settings import SolverSettings as TSettings

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

_B = 3
_ATOL = 1e-6


# ---------------------------------------------------- F3: spectral solve

_F3_N, _F3_NONNEG, _F3_SOC, _F3_ACTIVE, _F3_B = 30, 170, 11, 25, 16


@functools.lru_cache(maxsize=None)
def _f3_solves():
    """Both packages' spectral solves of one batch of KKT systems at
    m = 181 > 160, in f64 and f32, J and J': {(pkg, dtype, transpose):
    (B, n+m)}."""
    n, nn, soc = _F3_N, _F3_NONNEG, _F3_SOC
    m = nn + soc
    r = np.random.default_rng(0)
    F = r.standard_normal((_F3_B, 3, n))
    # a nearly rank-deficient P, as the Markowitz rows' P
    P = np.einsum("bki,bkj->bij", F, F) + 1e-4 * np.eye(n)
    A = r.standard_normal((_F3_B, m, n))
    x = r.standard_normal((_F3_B, n))
    # most nonneg rows inactive (w > 0), 25 active, the SOC block mixed
    w = r.standard_normal((_F3_B, m))
    w[:, :nn] = np.abs(w[:, :nn])
    w[:, :_F3_ACTIVE] *= -1
    rhs = r.standard_normal((_F3_B, n + m))
    q = np.zeros((_F3_B, n))
    b = np.zeros((_F3_B, m))
    args = (x, w, P, q, A, b, rhs)
    kw = dict(kkt_mode="spectral", p_diag_full=True, p_diag_only=False)
    js = j_kkt_solver(JDims(nonneg=nn, soc=(soc,)), n, **kw)
    ts = t_kkt_solver(TDims(nonneg=nn, soc=(soc,)), n, **kw)
    ref = jax.jit(jax.vmap(lambda *a: (js(*a, transpose=False),
                                       js(*a, transpose=True))))
    out = {}
    for dt, jdt, tdt in (("f64", jnp.float64, torch.float64),
                         ("f32", jnp.float32, torch.float32)):
        rj = ref(*(jnp.asarray(a, jdt) for a in args))
        for tr in (False, True):
            out["ref", dt, tr] = np.asarray(rj[int(tr)], np.float64)
            out["port", dt, tr] = ts(
                *(torch.as_tensor(a, dtype=tdt) for a in args),
                transpose=tr).double().numpy()
    return out


@pytest.mark.parametrize("transpose", [False, True], ids=["J", "Jt"])
def test_f32_spectral_solve_above_masked_dim_is_as_accurate_as_reference(
        transpose):
    out = _f3_solves()
    exact = out["ref", "f64", transpose]
    # at f64 both packages factor by Cholesky: the same solve
    np.testing.assert_allclose(out["port", "f64", transpose], exact,
                               atol=1e-9 * np.abs(exact).max(), rtol=0)
    scale = np.abs(exact).max(axis=1)
    err_ref = np.abs(out["ref", "f32", transpose] - exact).max(axis=1) / scale
    err_port = np.abs(out["port", "f32", transpose] - exact).max(axis=1) \
        / scale
    assert np.isfinite(err_port).all()
    # the port's f32 error is at most twice the reference's, lane by lane
    # in the median (rounding noise moves single lanes either way)
    assert np.median(err_port / err_ref) <= 2.0


# ------------------------------------------------------------- layers


def box_qp(mod, **kw):
    x = mod.Variable(4)
    v = mod.Parameter(4)
    G = mod.Parameter((3, 4))
    h = mod.Parameter(3)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [G @ x <= h, x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v, G, h], variables=[x], **kw)


def box_lp(mod, **kw):
    x = mod.Variable(4)
    v = mod.Parameter(4)
    G = mod.Parameter((3, 4))
    h = mod.Parameter(3)
    prob = mod.Problem(mod.Minimize(v @ x), [G @ x <= h, x >= 0, x <= 1])
    return mod.CvxpyLayer(prob, parameters=[v, G, h], variables=[x], **kw)


def ball(mod, **kw):
    # the projection onto the unit ball and the nonneg orthant: an SOC
    x = mod.Variable(4)
    v = mod.Parameter(4)
    prob = mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                       [mod.norm(x, 2) <= 1, x >= 0])
    return mod.CvxpyLayer(prob, parameters=[v], variables=[x], **kw)


def _box_values(seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((_B, 4)), r.standard_normal((_B, 3, 4)),
            np.abs(r.standard_normal((_B, 3))) + 0.5]


def _ball_values(seed):
    return [np.random.default_rng(seed).standard_normal((_B, 4))]


_JVP_CASES = {
    "box_qp-admm": (box_qp, _box_values, {}),
    "box_qp-ipm": (box_qp, _box_values, {"solve_method": "ipm"}),
    "box_lp-pdhg": (box_lp, _box_values, {"solve_method": "pdhg"}),
    "ball-admm": (ball, _ball_values, {}),
}


def _port_jvp(layer, vals, tangents, args):
    """(outputs, tangents, status) of one forward-mode layer call."""
    with fwAD.dual_level():
        duals = [fwAD.make_dual(torch.as_tensor(a), torch.as_tensor(t))
                 for a, t in zip(vals, tangents)]
        (x,), status, _ = layer.solve_with_info(*duals, solver_args=args)
        x, dx = fwAD.unpack_dual(x)
    return x.numpy(), dx.numpy(), status.numpy()


@pytest.mark.parametrize("case", sorted(_JVP_CASES))
def test_layer_jvp_matches_reference(case):
    build, values, extra = _JVP_CASES[case]
    args = dict(extra, derivative="forward")
    vals = values(1)
    r = np.random.default_rng(2)
    tangents = [r.standard_normal(a.shape) for a in vals]
    jl = build(cj)

    def f(*p):
        (x,), status, _ = jl.solve_with_info(*p, solver_args=args)
        return x, status

    (xj, sj), (dxj, _) = jax.jvp(f, tuple(jnp.asarray(a) for a in vals),
                                 tuple(jnp.asarray(t) for t in tangents))
    x, dx, status = _port_jvp(build(ct, device="cpu"), vals, tangents, args)
    np.testing.assert_array_equal(status, np.asarray(sj))
    assert (status == SOLVED).all()
    np.testing.assert_allclose(x, np.asarray(xj), atol=_ATOL, rtol=0)
    np.testing.assert_allclose(dx, np.asarray(dxj), atol=_ATOL, rtol=0)
    assert np.abs(dx).max() > 1e-2  # the tangent is not trivially zero


def _jvp_stack(layer, vals, which, args):
    """The Jacobian of lane 0's x with respect to parameter `which` as a
    stack of JVPs along its basis tangents, (dim x, dim p)."""
    p0 = [torch.as_tensor(a[:1]) for a in vals]
    size = p0[which][0].numel()
    cols = []
    for k in range(size):
        t = [torch.zeros_like(p) for p in p0]
        t[which].view(-1)[k] = 1.0
        with fwAD.dual_level():
            duals = [fwAD.make_dual(p, d) for p, d in zip(p0, t)]
            (x,), _, _ = layer.solve_with_info(*duals, solver_args=args)
            cols.append(fwAD.unpack_dual(x).tangent[0])
    return torch.stack(cols, dim=1).numpy()


def test_jvp_stack_matches_reference_jacfwd():
    vals = _box_values(3)
    args = {"derivative": "forward"}
    jl = box_qp(cj)
    rest = [jnp.asarray(a[0]) for a in vals[1:]]
    jac = jax.jacfwd(lambda v: jl.solve_with_info(
        v, *rest, solver_args=args)[0][0])(jnp.asarray(vals[0][0]))
    stack = _jvp_stack(box_qp(ct, device="cpu"), vals, 0, args)
    np.testing.assert_allclose(stack, np.asarray(jac), atol=_ATOL, rtol=0)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["v", "G", "h"])
def test_jvp_stack_matches_reverse_mode_jacobian(which):
    # the forward rule's J^{-1} and the adjoint's J^{-T}: the same
    # Jacobian, column by column and row by row
    vals = _box_values(6)
    # lane 0: one row of G x <= h binds and two coordinates are free, so
    # v, G and h all move x
    vals[2] = 0.3 * vals[2]
    layer = box_qp(ct, device="cpu")
    stack = _jvp_stack(layer, vals, which, {"derivative": "forward"})
    p0 = [torch.as_tensor(a[:1]) for a in vals]
    rows = []
    for i in range(4):
        p = [t.clone().requires_grad_(k == which) for k, t in enumerate(p0)]
        (x,), _, _ = layer.solve_with_info(*p)
        x[0, i].backward()
        rows.append(p[which].grad[0].reshape(-1))
    np.testing.assert_allclose(stack, torch.stack(rows).numpy(), atol=_ATOL,
                               rtol=0)
    assert np.abs(stack).max() > 1e-2


def test_torch_func_jvp_equals_forward_ad():
    # the Function's setup_context form: torch.func.jvp takes the same rule
    vals = [torch.as_tensor(a) for a in _box_values(5)]
    r = np.random.default_rng(6)
    tangents = [torch.as_tensor(r.standard_normal(tuple(a.shape)))
                for a in vals]
    layer = box_qp(ct, device="cpu")
    args = {"derivative": "forward"}
    x, dx = torch.func.jvp(lambda *p: layer(*p, solver_args=args)[0],
                           tuple(vals), tuple(tangents))
    x2, dx2, _ = _port_jvp(layer, vals, tangents, args)
    np.testing.assert_array_equal(x.numpy(), x2)
    np.testing.assert_array_equal(dx.numpy(), dx2)


def test_backward_through_forward_rule_raises_as_the_reference():
    vals = _box_values(7)
    args = {"derivative": "forward"}
    jl = box_qp(cj)
    rest = [jnp.asarray(a) for a in vals[1:]]
    # the reference's custom_jvp rule cannot be transposed
    with pytest.raises(Exception):
        jax.grad(lambda v: jl(v, *rest, solver_args=args)[0].sum())(
            jnp.asarray(vals[0]))
    layer = box_qp(ct, device="cpu")
    v = torch.as_tensor(vals[0]).requires_grad_()
    (x,) = layer(v, *(torch.as_tensor(a) for a in vals[1:]),
                 solver_args=args)
    with pytest.raises(RuntimeError, match="forward-mode rule only"):
        x.sum().backward()


def test_forward_mode_through_adjoint_rule_raises_as_the_reference():
    vals = _box_values(8)
    jl = box_qp(cj)
    with pytest.raises(TypeError, match="custom_vjp"):
        jax.jvp(lambda *p: jl(*p)[0],
                tuple(jnp.asarray(a) for a in vals),
                tuple(jnp.ones_like(jnp.asarray(a)) for a in vals))
    with pytest.raises(RuntimeError, match="derivative='forward'"):
        _port_jvp(box_qp(ct, device="cpu"), vals,
                  [np.ones_like(a) for a in vals], {})


# ------------------------------------------------------ the rule itself


def _qp_data(B, seed):
    """min 0.5|x|^2 + q'x over -1 <= x <= 1 (n = 3, 6 nonneg rows): x is
    the clipped -q."""
    r = np.random.default_rng(seed)
    P = torch.eye(3, dtype=torch.float64).repeat(B, 1, 1)
    q = torch.as_tensor(r.standard_normal((B, 3)) * 1.5)
    A = torch.cat([torch.eye(3), -torch.eye(3)]).double().repeat(B, 1, 1)
    b = torch.ones(B, 6, dtype=torch.float64)
    return P, q, A, b


def _rule_jvp(solve, data, tangents, warm=None):
    z = [torch.zeros_like(data[1]), torch.zeros_like(data[3])]
    start = warm or [z[0], z[1], z[1]]
    with fwAD.dual_level():
        args = [fwAD.make_dual(d, t) if t is not None else d
                for d, t in zip(list(data) + start, tangents)]
        x, y, s, status, _ = solve(*args)
        return ([fwAD.unpack_dual(o) for o in (x, y, s)], status)


def test_nonfinite_tangent_lane_gets_zero_and_others_keep_theirs():
    solve = make_diff_solver(TDims(nonneg=6), 3,
                             TSettings(derivative="forward"))
    data = _qp_data(2, 9)
    dq = torch.ones(2, 3, dtype=torch.float64)
    clean, st = _rule_jvp(solve, data, [None, dq] + [None] * 5)
    dq_bad = dq.clone()
    dq_bad[0, 1] = float("nan")
    bad, _ = _rule_jvp(solve, data, [None, dq_bad] + [None] * 5)
    assert st.tolist() == [SOLVED, SOLVED]
    for (_, t_bad), (_, t_ok) in zip(bad, clean):
        assert (t_bad[0] == 0).all()
        np.testing.assert_array_equal(t_bad[1].numpy(), t_ok[1].numpy())
    # the clipped -q: the tangent is -dq on the free coordinates
    x = clean[0][0]
    free = x.abs() < 1 - 1e-6
    np.testing.assert_allclose(clean[0][1][free].numpy(), -1.0, atol=1e-8)
    np.testing.assert_allclose(clean[0][1][~free].numpy(), 0.0, atol=1e-8)


def test_warm_start_tangents_are_ignored():
    solve = make_diff_solver(TDims(nonneg=6), 3,
                             TSettings(derivative="forward"))
    data = _qp_data(2, 10)
    r = np.random.default_rng(11)
    t = [torch.as_tensor(r.standard_normal(tuple(d.shape))) for d in data]
    warm_t = [torch.as_tensor(r.standard_normal(s)) for s in
              ((2, 3), (2, 6), (2, 6))]
    base, _ = _rule_jvp(solve, data, t + [None] * 3)
    with_warm, _ = _rule_jvp(solve, data, t + warm_t)
    for (_, a), (_, b_) in zip(base, with_warm):
        np.testing.assert_array_equal(a.numpy(), b_.numpy())


def test_f32_jvp_agrees_with_f64():
    # one refinement pass in f32, as the adjoint takes
    vals = _box_values(12)
    r = np.random.default_rng(13)
    tangents = [r.standard_normal(a.shape) for a in vals]
    layer = box_qp(ct, device="cpu")
    args = {"derivative": "forward", "eps_abs": 1e-6, "eps_rel": 1e-6}
    _, d64, s64 = _port_jvp(layer, vals, tangents, args)
    _, d32, s32 = _port_jvp(
        layer, [a.astype(np.float32) for a in vals],
        [t.astype(np.float32) for t in tangents], args)
    both = (s64 == SOLVED) & (s32 == SOLVED)
    assert both.sum() >= 2
    scale = np.abs(d64).max()
    assert np.abs(d32 - d64)[both].max() <= 1e-3 * scale
