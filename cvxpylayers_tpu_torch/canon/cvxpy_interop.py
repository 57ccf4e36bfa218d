"""Optional CVXPY interop shim: convert a real `cvxpy.Problem` into the
port's expression DSL, so `CvxpyLayer(cp_problem, ...)` works wherever
cvxpy happens to be installed.

Counterpart of cvxpylayers_tpu/canon/cvxpy_interop.py, onto this
package's own `expressions`. A pure tree-walk over cvxpy's public
expression DAG; no cvxpy canonicalization machinery is used (the port has
its own canonicalizer). Atom coverage mirrors the DSL's atom set; an
unsupported atom raises InteropError naming it.

cvxpy is imported lazily, inside the functions: this module imports fine
without it, `have_cvxpy()` gates the feature, and a test may put a
stand-in module under `sys.modules["cvxpy"]`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import expressions as ex
from ..expressions import (
    Constant,
    Maximize,
    Minimize,
    Parameter,
    Problem,
    Variable,
)


class InteropError(ValueError):
    pass


def have_cvxpy() -> bool:
    try:
        import cvxpy  # noqa: F401

        return True
    except ImportError:
        return False


def is_cvxpy_problem(obj) -> bool:
    if not have_cvxpy():
        return False
    import cvxpy as cp

    return isinstance(obj, cp.Problem)


class _Converter:
    def __init__(self):
        self.leaf_map: Dict[int, object] = {}  # id(cvxpy leaf) -> native

    # ---------------------------------------------------------- leaves
    def leaf(self, node):
        import cvxpy as cp

        key = id(node)
        if key in self.leaf_map:
            return self.leaf_map[key]
        if isinstance(node, cp.Variable):
            native = Variable(
                node.shape, name=node.name(),
                nonneg=node.attributes.get("nonneg", False),
                nonpos=node.attributes.get("nonpos", False),
                pos=node.attributes.get("pos", False),
                symmetric=node.attributes.get("symmetric", False)
                or node.attributes.get("PSD", False),
                PSD=node.attributes.get("PSD", False),
            )
        elif isinstance(node, cp.Parameter):
            # the DSL's Parameter has no `symmetric` attribute (a
            # symmetric-valued parameter needs no special handling in
            # an affine position); PSD is the structural one
            native = Parameter(
                node.shape, name=node.name(),
                nonneg=node.attributes.get("nonneg", False),
                nonpos=node.attributes.get("nonpos", False),
                pos=node.attributes.get("pos", False),
                PSD=node.attributes.get("PSD", False),
            )
        else:
            raise InteropError(f"unknown cvxpy leaf {type(node).__name__}")
        self.leaf_map[key] = native
        return native

    # ------------------------------------------------------ expressions
    def expr(self, node):
        import cvxpy as cp

        if isinstance(node, (cp.Variable, cp.Parameter)):
            return self.leaf(node)
        if isinstance(node, cp.Constant):
            val = node.value
            if hasattr(val, "toarray"):
                # cvxpy Constants routinely hold scipy.sparse matrices
                # (np.asarray on those yields a useless 0-d object
                # array); densify — the canonicalizer keeps its
                # own fixed-sparsity representation downstream
                val = val.toarray()
            return Constant(np.asarray(val))
        if isinstance(node, (int, float, np.ndarray, np.generic)):
            return Constant(np.asarray(node))

        name = type(node).__name__
        args = node.args
        a = [self.expr(arg) for arg in args]

        # ---- affine structure
        if name == "AddExpression":
            out = a[0]
            for other in a[1:]:
                out = out + other
            return out
        if name == "NegExpression":
            return -a[0]
        if name == "MulExpression":  # matmul
            return a[0] @ a[1]
        if name == "multiply":
            return ex.multiply(a[0], a[1])
        if name == "DivExpression":
            return a[0] / a[1]
        if name == "Promote":
            return a[0] * np.ones(node.shape)
        if name in ("index", "special_index"):
            return a[0][node.key]
        if name == "Sum":
            ax = getattr(node, "axis", None)
            return ex.sum(a[0], axis=ax) if ax is not None else ex.sum(a[0])
        if name == "reshape":
            return ex.reshape(a[0], node.shape)
        if name == "transpose":
            return a[0].T
        if name == "Hstack":
            return ex.hstack(a)
        if name == "Vstack":
            return ex.vstack(a)
        if name == "trace":
            return ex.trace(a[0])
        if name in ("diag", "diag_mat", "diag_vec"):
            return ex.diag(a[0])
        if name in ("cumsum", "Cumsum"):
            ax = getattr(node, "axis", 0)
            return ex.cumsum(a[0], axis=0 if ax is None else int(ax))

        # ---- nonlinear atoms (the DSL's names)
        simple = {
            "abs": ex.abs, "exp": ex.exp, "log": ex.log, "entr": ex.entr,
            "logistic": ex.logistic, "pos": ex.pos, "neg": ex.neg,
            "square": ex.square, "sqrt": ex.sqrt, "inv_pos": ex.inv_pos,
            "lambda_max": ex.lambda_max, "lambda_min": ex.lambda_min,
            "log1p": ex.log1p, "xexp": ex.xexp, "tr_inv": ex.tr_inv,
            "one_minus_pos": ex.one_minus_pos,
            "pf_eigenvalue": ex.pf_eigenvalue,
            "eye_minus_inv": ex.eye_minus_inv,
            "log_normcdf": ex.log_normcdf, "loggamma": ex.loggamma,
            "sigma_max": ex.sigma_max, "log_det": ex.log_det,
            "normNuc": ex.norm_nuc, "norm_nuc": ex.norm_nuc,
        }
        if name in simple:
            return simple[name](a[0])
        if name == "log_sum_exp":
            return ex.log_sum_exp(a[0], axis=getattr(node, "axis", None))
        if name in ("Prod", "prod"):
            if getattr(node, "axis", None) is not None:
                raise InteropError("prod with axis is not supported")
            return ex.prod(a[0])
        if name in ("cummax", "CumMax"):
            ax = getattr(node, "axis", 0)
            return ex.cummax(a[0], axis=0 if ax is None else int(ax))
        if name in ("gmatmul", "GMatMul"):
            A = getattr(node, "A", None)
            if A is None:
                raise InteropError("gmatmul node without constant A")
            Aval = A.value if hasattr(A, "value") else A
            return ex.gmatmul(np.asarray(Aval), a[-1])
        if name in ("sum_largest", "SumLargest"):
            return ex.sum_largest(a[0], node.k)
        if name in ("sum_smallest", "SumSmallest"):
            return ex.sum_smallest(a[0], node.k)
        if name in ("lambda_sum_largest",):
            return ex.lambda_sum_largest(a[0], node.k)
        if name in ("lambda_sum_smallest",):
            return ex.lambda_sum_smallest(a[0], node.k)
        if name in ("dotsort",):
            w = getattr(node, "w", None)
            if w is None and len(args) > 1:
                w = args[1].value if hasattr(args[1], "value") else args[1]
            return ex.dotsort(a[0], np.asarray(w))
        if name in ("upper_tri",):
            return ex.upper_tri(a[0])
        if name in ("vec_to_upper_tri",):
            return ex.vec_to_upper_tri(
                a[0], strict=bool(getattr(node, "strict", False))
            )
        if name in ("harmonic_mean",):
            return ex.harmonic_mean(a[0])
        if name in ("ptp",):
            return ex.ptp(a[0])
        if name == "maximum":
            out = a[0]
            for other in a[1:]:
                out = ex.maximum(out, other)
            return out
        if name == "minimum":
            out = a[0]
            for other in a[1:]:
                out = ex.minimum(out, other)
            return out
        if name in ("max", "Max"):
            return ex.max(a[0], axis=getattr(node, "axis", None))
        if name in ("min", "Min"):
            return ex.min(a[0], axis=getattr(node, "axis", None))
        if name in ("norm1",):
            return ex.pnorm(a[0], 1, axis=getattr(node, "axis", None))
        if name in ("norm_inf",):
            return ex.pnorm(a[0], "inf", axis=getattr(node, "axis", None))
        if name in ("Pnorm", "pnorm", "norm2", "norm"):
            p = getattr(node, "p", 2)
            return ex.pnorm(a[0], p, axis=getattr(node, "axis", None))
        if name == "QuadForm":
            return ex.quad_form(a[0], a[1])
        if name in ("MatrixFrac", "matrix_frac"):
            return ex.matrix_frac(a[0], a[1])
        if name == "sigma_max":
            return ex.sigma_max(a[0])
        if name == "log_det":
            return ex.log_det(a[0])
        if name == "quad_over_lin":
            return ex.quad_over_lin(a[0], a[1])
        if name == "Sum_squares" or name == "sum_squares":
            return ex.sum_squares(a[0])
        if name == "huber":
            return ex.huber(a[0], getattr(node, "M", 1.0))
        if name == "power":
            return ex.power(a[0], node.p)
        if name == "geo_mean":
            p = getattr(node, "p", None)
            return ex.geo_mean(
                a[0], None if p is None else [float(f) for f in p]
            )
        if name == "kl_div":
            return ex.kl_div(a[0], a[1])
        if name == "rel_entr":
            return ex.rel_entr(a[0], a[1])
        if name == "perspective":
            if len(a) < 2:
                raise InteropError("perspective node needs (f, s) args")
            return ex.perspective(a[0], a[1])

        raise InteropError(
            f"cvxpy atom {name!r} has no native counterpart yet"
        )

    # ------------------------------------------------------ constraints
    def constraint(self, con):
        name = type(con).__name__
        if name == "Equality":
            return self.expr(con.args[0]) == self.expr(con.args[1])
        if name == "Inequality":
            return self.expr(con.args[0]) <= self.expr(con.args[1])
        if name == "NonNeg":
            return ex.NonNeg(self.expr(con.args[0]))
        if name == "NonPos":
            return self.expr(con.args[0]) <= 0.0
        if name == "Zero":
            return self.expr(con.args[0]) == 0.0
        if name == "SOC":
            t = self.expr(con.args[0])
            X = self.expr(con.args[1])
            return ex.SOC(t, X)
        if name == "ExpCone":
            return ex.ExpCone(*(self.expr(arg) for arg in con.args))
        if name == "PSD":
            return ex.PSD(self.expr(con.args[0]))
        if name == "PowCone3D":
            return ex.PowCone3D(
                *(self.expr(arg) for arg in con.args[:3]),
                alpha=float(np.asarray(con.args[3].value
                                       if hasattr(con.args[3], "value")
                                       else con.args[3])),
            )
        raise InteropError(
            f"cvxpy constraint {name!r} has no native counterpart yet"
        )


def convert_problem(cp_problem, parameters: Sequence,
                    variables: Sequence) -> Tuple[Problem, List, List]:
    """cvxpy (problem, parameters, variables) -> native equivalents.

    The returned parameter/variable lists are the native twins of the
    given cvxpy leaves, in the same order — pass them straight to
    CvxpyLayer (which also calls this automatically when handed a
    cvxpy Problem)."""
    import cvxpy as cp

    if not isinstance(cp_problem, cp.Problem):
        raise InteropError("not a cvxpy Problem")
    conv = _Converter()
    obj_expr = conv.expr(cp_problem.objective.expr)
    objective = (
        Minimize(obj_expr)
        if isinstance(cp_problem.objective, cp.Minimize)
        else Maximize(obj_expr)
    )
    con_map = {}
    dv_map = {}
    constraints = []
    for c in cp_problem.constraints:
        nc = conv.constraint(c)
        con_map[id(c)] = nc
        # cvxpy exposes per-part dual variables on cone constraints;
        # map them positionally onto the native multi-part duals
        for k, dv in enumerate(getattr(c, "dual_variables", [])):
            if k < len(nc.dual_variables):
                dv_map[id(dv)] = nc.dual_variables[k]
        constraints.append(nc)
    native = Problem(objective, constraints)
    n_params = [conv.leaf(p) for p in parameters]
    n_vars = []
    for v in variables:
        if id(v) in dv_map:
            # a cvxpy per-part dual variable object
            n_vars.append(dv_map[id(v)])
        elif isinstance(v, cp.Variable):
            n_vars.append(conv.leaf(v))
        elif id(v) in con_map:
            # a cvxpy constraint in the variables list requests its dual
            n_vars.append(con_map[id(v)].dual_variables[0])
        else:
            raise InteropError(
                "variables entries must be cvxpy Variables, per-part "
                "dual variables, or problem constraints (for duals)"
            )
    return native, n_params, n_vars
