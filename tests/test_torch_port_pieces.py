"""Small parts of the port against the reference's, one at a time.

What the solvers and the canonicalizer stand on: the cone-block row
groups and the Ruiz equilibration of the ADMM set-up, the sparse inner
join and the TensorRep algebra behind every parameter-affine map, the
host evaluation of a stuffed program, and the TF32 pin. Each goes through
the reference's function and the port's on the same numpy-seeded inputs;
the TensorRep results are also held to the numpy formula they stand for.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cvxpylayers_tpu as cj
import cvxpylayers_tpu_torch as ct
from cvxpylayers_tpu.canon import stuffer as j_stuffer
from cvxpylayers_tpu.canon.tensor_rep import TensorRep as JRep
from cvxpylayers_tpu.cones.dims import ConeDims as JDims
from cvxpylayers_tpu.solver import admm as j_admm
from cvxpylayers_tpu_torch.canon import stuffer as t_stuffer
from cvxpylayers_tpu_torch.canon.tensor_rep import TensorRep as TRep
from cvxpylayers_tpu_torch.canon.tensor_rep import join_pairs
from cvxpylayers_tpu_torch.cones.dims import ConeDims as TDims
from cvxpylayers_tpu_torch.solver import admm as t_admm
from cvxpylayers_tpu_torch.utils.precision import full_f32

# tiny tensors: more threads only contend with the other test workers
torch.set_num_threads(1)

# ------------------------------------------------------- the ADMM set-up

_DIMS = [
    dict(zero=2, nonneg=3),
    dict(nonneg=2, soc=(3, 2), exp=1),
    dict(zero=1, psd=(2, 3), pow3=(0.4,)),
]


@pytest.mark.parametrize("kw", _DIMS, ids=["polyhedral", "soc-exp", "psd-pow"])
def test_cone_row_groups_match_reference(kw):
    gj, nj = j_admm._cone_row_groups(JDims(**kw))
    gt, nt = t_admm._cone_row_groups(TDims(**kw))
    assert nt == nj
    np.testing.assert_array_equal(gt, np.asarray(gj))
    # one group per zero and nonneg row, one per block of the other cones
    assert gt.size == TDims(**kw).total and gt.max() == nt - 1
    assert (np.diff(gt) >= 0).all()


@pytest.mark.parametrize("n_zero,iters", [(0, 10), (2, 3)])
def test_ruiz_equilibration_matches_reference(n_zero, iters):
    B, n, m = 3, 4, 6
    r = np.random.default_rng(30 + n_zero + iters)
    L = r.standard_normal((B, n, n))
    P = L @ L.transpose(0, 2, 1)
    A = r.standard_normal((B, m, n)) * np.exp(r.standard_normal((B, m, 1)))
    A[:, 1] = 0.0  # an empty row keeps its scale
    q, b = r.standard_normal((B, n)), r.standard_normal((B, m))
    gid, ng = t_admm._cone_row_groups(TDims(zero=n_zero, nonneg=m - n_zero))
    want = jax.jit(jax.vmap(functools.partial(
        j_admm._ruiz_equilibrate, group_ids=gid, n_groups=ng, iters=iters)))(
            *(jnp.asarray(a) for a in (P, A, q, b)))
    got = t_admm._ruiz_equilibrate(
        *(torch.as_tensor(a) for a in (P, A, q, b)), gid, ng, iters)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-13,
                                   rtol=1e-13)
    # the scalings reproduce the scaled data from the original
    Ps, As, qs, bs, D, E, c = (g.numpy() for g in got)
    np.testing.assert_allclose(
        Ps, c[:, None, None] * D[:, :, None] * P * D[:, None, :], atol=1e-12)
    np.testing.assert_allclose(
        As, E[:, :, None] * A * D[:, None, :], atol=1e-12)
    np.testing.assert_allclose(qs, c[:, None] * D * q, atol=1e-12)
    np.testing.assert_allclose(bs, E * b, atol=1e-12)
    if iters > 1:  # equilibrated: every nonempty row's largest entry near 1
        rows = np.abs(As).max(axis=2)
        assert 0.3 < rows[:, 2:].min() and rows.max() < 3.0


# ---------------------------------------------- the canonicalizer's algebra


@pytest.mark.parametrize("sizes", [(40, 60, 7), (5, 0, 3)],
                         ids=["duplicates", "empty-side"])
def test_join_pairs_matches_brute_force(sizes):
    na, nb, hi = sizes
    r = np.random.default_rng(na)
    ka, kb = r.integers(0, hi, na), r.integers(0, hi, nb)
    ia, ib = join_pairs(ka, kb)
    assert ia.dtype == np.int64 and ib.dtype == np.int64
    got = sorted(zip(ia.tolist(), ib.tolist()))
    want = sorted((i, j) for i in range(na) for j in range(nb)
                  if ka[i] == kb[j])
    assert got == want
    assert (np.diff(ia) >= 0).all()  # grouped by the left index


_NX, _NP = 5, 7  # variable and parameter slots ahead of the constant slot


def _rep_cases(Rep):
    """The same op sequences on either package's TensorRep, each with the
    numpy formula it stands for (x, p are the variable and parameter
    vectors)."""
    r = np.random.default_rng(40)
    c3, c6 = r.standard_normal(3), r.standard_normal(6)
    L = sp.random(4, 3, density=0.6, random_state=1, format="csr")
    x3 = Rep.variable(3, 1)        # x[1:4]
    x6 = Rep.variable(5, 0).apply_linear(
        sp.eye(6, 5, format="csr"))  # (x[0:5], 0) as a 6-vector
    p3 = Rep.parameter(3, 2)       # p[2:5]
    p6 = Rep.parameter(6, 0)       # p[0:6] as a (2, 3) or (3, 2) matrix
    p1 = Rep.parameter(1, 6)       # p[6]
    pad = lambda x: np.r_[x[0:5], 0.0]  # noqa: E731
    return {
        "affine": (
            (x3 + Rep.constant(c3)).scale(2.5) + p3.neg(),
            lambda x, p: 2.5 * (x[1:4] + c3) - p[2:5]),
        "apply_linear": (
            (x3 + p3).apply_linear(L),
            lambda x, p: L @ (x[1:4] + p[2:5])),
        "param_matmul_left": (
            (p6 + Rep.constant(c6)).param_matmul_left((2, 3), x3, (3, 1)),
            lambda x, p: (p[0:6] + c6).reshape(2, 3) @ x[1:4]),
        "param_matmul_right": (
            p6.param_matmul_right((3, 2), x6, (2, 3)),
            lambda x, p: (pad(x).reshape(2, 3)
                          @ p[0:6].reshape(3, 2)).reshape(-1)),
        "param_elemwise_and_scalar": (
            p3.param_elemwise(x3 + Rep.constant(c3))
            + p1.param_scalar_mul(x3),
            lambda x, p: p[2:5] * (x[1:4] + c3) + p[6] * x[1:4]),
    }


@pytest.mark.parametrize("op", ["affine", "apply_linear",
                                "param_matmul_left", "param_matmul_right",
                                "param_elemwise_and_scalar"])
def test_tensor_rep_operations_carry_across(op):
    rep_j, _ = _rep_cases(JRep)[op]
    rep_t, formula = _rep_cases(TRep)[op]
    r = np.random.default_rng(41)
    x, p = r.standard_normal(_NX), r.standard_normal(_NP)
    x_ext, p_ext = np.r_[x, 1.0], np.r_[p, 1.0]
    got = rep_t.eval(x_ext, p_ext)
    assert rep_t.n_rows == rep_j.n_rows == got.size
    np.testing.assert_allclose(got, rep_j.eval(x_ext, p_ext), atol=1e-13)
    np.testing.assert_allclose(got, formula(x, p), atol=1e-13)
    assert rep_t.is_param_free() == rep_j.is_param_free()
    assert rep_t.is_var_free() == rep_j.is_var_free()


def test_tensor_rep_refuses_what_is_not_affine():
    x3, p3 = TRep.variable(3, 0), TRep.parameter(3, 0)
    with pytest.raises(ValueError, match="must not involve variables"):
        x3.param_elemwise(x3)
    with pytest.raises(ValueError, match="two parameter-dependent"):
        p3.param_elemwise(p3)
    with pytest.raises(ValueError, match="row mismatch"):
        x3 + TRep.variable(2, 0)


def _box_qp(mod):
    x, v = mod.Variable(4), mod.Parameter(4)
    G, h = mod.Parameter((2, 4)), mod.Parameter(2)
    return (mod.Problem(mod.Minimize(mod.sum_squares(x - v)),
                        [G @ x <= h, x >= 0, x <= 1]), [v, G, h])


def _lad(mod):
    x, A, b = mod.Variable(2), mod.Parameter((3, 2)), mod.Parameter(3)
    return (mod.Problem(mod.Minimize(mod.norm(A @ x - b, 1)), [x >= 0]),
            [A, b])


@pytest.mark.parametrize("build", [_box_qp, _lad], ids=["box_qp", "lad"])
def test_stuffed_program_evaluates_the_same_on_the_host(build):
    prog_j = j_stuffer.stuff(*build(cj))
    prog_t = t_stuffer.stuff(*build(ct))
    assert (prog_t.n, prog_t.m) == (prog_j.n, prog_j.m)
    assert prog_t.A_is_constant == prog_j.A_is_constant
    assert prog_t.P_is_constant == prog_j.P_is_constant
    r = np.random.default_rng(42)
    vals = [r.standard_normal(p.shape) for p in build(ct)[1]]
    want = j_stuffer.eval_data(prog_j, vals)
    got = t_stuffer.eval_data(prog_t, vals)
    assert len(got) == len(want) == 5  # A, b, q, the constant of q, P
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-13)


# ------------------------------------------------------------ the TF32 pin


def test_full_f32_pins_tf32_off_and_restores():
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        for outer in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = outer
            with full_f32():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is outer
            with pytest.raises(ZeroDivisionError):
                with full_f32():
                    1 / 0
            assert torch.backends.cuda.matmul.allow_tf32 is outer
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
