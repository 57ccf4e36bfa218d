"""Exact comparison of two stuffed cone programs, one from each package.

Used by the port's tests of the geometric-program and structured atoms:
the port's `stuff()` output must equal the reference's field for field,
with the same cone dims, the same fixed sparsity, the same parameter-
affine maps entry for entry (to 1e-14), and the same variable and dual
layout.
Numpy and scipy only; no solve.
"""

from dataclasses import astuple

import numpy as np


def _layout(info):
    return sorted((tuple(sorted(vars(v).items(), key=lambda kv: kv[0]))
                   for v in info.values()), key=repr)


def assert_same_program(prog_t, prog_j):
    """Every field of the port's ConeProgram equals the reference's."""
    assert astuple(prog_t.dims) == astuple(prog_j.dims)
    assert (prog_t.n, prog_t.m, prog_t.n_param) == (
        prog_j.n, prog_j.m, prog_j.n_param)
    assert prog_t.maximize == prog_j.maximize
    assert prog_t.objective_offset_exact == prog_j.objective_offset_exact
    for name in ("A_rows", "A_cols", "b_rows", "P_rows", "P_cols"):
        np.testing.assert_array_equal(getattr(prog_t, name),
                                      getattr(prog_j, name), err_msg=name)
    for name in ("reduced_A", "reduced_b", "reduced_q", "reduced_P"):
        got, want = getattr(prog_t, name).toarray(), getattr(
            prog_j, name).toarray()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got != 0, want != 0, err_msg=name)
        # the values to the last bits: the reference sums constant
        # products in its native C++ join, the port in scipy, so an
        # entry that adds several terms may differ by an ulp
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14,
                                   err_msg=name)
    assert sorted(prog_t.param_offsets.values()) == sorted(
        prog_j.param_offsets.values())
    assert repr(_layout(prog_t.var_info)) == repr(_layout(prog_j.var_info))
    assert repr(_layout(prog_t.dual_info)) == repr(_layout(prog_j.dual_info))
