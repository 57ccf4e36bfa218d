"""CvxpyLayer: the user-facing optimization layer, on torch tensors.

Counterpart of cvxpylayers_tpu/layer/cvxpylayer.py:

    layer = CvxpyLayer(problem, parameters=[A, b], variables=[x])
    (x_star,) = layer(A_val, b_val)            # torch tensors on the card
    x_star.sum().backward()                    # gradients w.r.t. A_val, b_val

The forward is parameter-affine data evaluation (one matmul or an
index_add_), a dense scatter into batched (P, q, A, b), the batched
solve (ADMM, the interior-point method or PDHG, then the Newton polish),
and slice/reshape recovery. Above an m*n of 2^16 (or under
`assembly="sparse"`) the data stay (B, nnz) value tensors of the
stuffer's pattern and the matrix-free route solves them
(solver/matfree.py). Everything but the solve is plain differentiable
torch; the solve carries the implicit-function adjoint
(diff/derivative.py). When P and A depend on no parameter, the default
`shared_setup="auto"` takes the shared-factor route instead: only q and b
are assembled, a batched ADMM with one factor for the whole batch
(solver/shared.py) runs without autograd, and the per-instance polish and
adjoint start from its iterates with the ADMM loop off.

Under `gp=True` the problem is first rewritten in log space
(canon/dgp.py): the layer logs the parameters used multiplicatively and
returns exp of the log-space variables. `solve_problem` (Problem.solve)
is one unbatched call of a layer cached on the problem.

Device contract: the layer runs on `device` ("cuda" unless the caller asks
for another); it raises where CUDA is absent and never falls back to the
CPU. Parameters must already lie on that device (a tensor elsewhere
raises ValueError; nothing is copied silently). The dtype follows the
inputs.

Batching semantics (the reference contract): each parameter may be
passed with its exact shape (unbatched) or with one leading batch
dimension; batched parameters must agree on the batch size; unbatched
ones broadcast; outputs carry the batch dimension iff any input was
batched (batch size 1 is preserved, not squeezed).
"""

from __future__ import annotations

import time
import types
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..canon.stuffer import ConeProgram, stuff
from ..cones.projections import svec_to_sym
from ..diff.derivative import make_diff_solver, make_matfree_diff_solver
from ..expressions.constraints import DualVariable
from ..expressions.leaf import Parameter, Variable
from ..expressions.problem import Problem
from ..solver.matfree import _DENSE_ASSEMBLY_LIMIT, SparseOps
from ..solver.settings import (
    DUAL_INFEASIBLE,
    MAX_ITERS,
    PRIMAL_INFEASIBLE,
    SOLVED,
    SolverSettings,
)
from ..utils.precision import full_f32


class SolverError(RuntimeError):
    """Raised when a solve fails — the analogue of diffcp.SolverError.
    Use solve_with_info() to get statuses as data instead."""


class WarmStart(NamedTuple):
    """Warm-start state: the (x, y, s) iterates, each batched (B, dim).

        ws = None
        for step in range(T):
            (sol,), ws, status, iters = layer.solve_and_state(p, warm_start=ws)
    """

    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor

    @classmethod
    def from_numpy(cls, x, y, s, *, device, dtype) -> "WarmStart":
        """A WarmStart from host arrays, e.g. the reference layer's state
        converted with np.asarray."""
        return cls(*(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                     for a in (x, y, s)))


_SOLVER_ARG_KEYS = {
    "eps": ("eps_abs", "eps_rel"),
    "eps_abs": ("eps_abs",),
    "eps_rel": ("eps_rel",),
    "eps_gap_scale": ("eps_gap_scale",),
    "admm_eps_abs": ("admm_eps_abs",),
    "admm_eps_rel": ("admm_eps_rel",),
    "max_iters": ("max_iters", "ipm_max_iters"),
    "ipm_max_iters": ("ipm_max_iters",),
    "ipm_eps_abs": ("ipm_eps_abs",),
    "ipm_eps": ("ipm_eps_abs",),
    "schur_iters": ("schur_iters",),
    "cg_iters": ("cg_iters",),
    "epoch": ("epoch",),
    "rho": ("rho",),
    "sigma": ("sigma",),
    "alpha": ("alpha",),
    "refine_steps": ("refine_steps",),
    "scaling_iters": ("scaling_iters",),
    "adaptive_rho": ("adaptive_rho",),
    "accel_lookback": ("accel_lookback",),
    "acceleration_lookback": ("accel_lookback",),  # SCS-parity alias
    "solve_method": ("solve_method",),
    "ipm_mode": ("ipm_mode",),
    "ipm_kkt": ("ipm_kkt",),
    "psd_proj": ("psd_proj",),
    "kkt_mode": ("kkt_mode",),
    "derivative": ("derivative",),
    "assembly": ("assembly",),
    "linsys_iters": ("linsys_iters",),
    "matmul_precision": ("matmul_precision",),
    "shared_setup": ("shared_setup",),
}

# choice-valued solver_args and their allowed values
_CHOICES = {
    "solve_method": ("admm", "ipm", "pdhg"),
    "derivative": ("adjoint", "forward"),
    "kkt_mode": ("auto", "spectral", "operator", "pcg"),
    "ipm_mode": ("auto", "hsde", "pd"),
    "ipm_kkt": ("auto", "chol", "qr"),
    "psd_proj": ("auto", "ns", "exact"),
    "assembly": ("auto", "dense", "sparse"),
    "matmul_precision": ("default", "high", "highest"),
    "shared_setup": ("auto", "on", "off"),
}

# dense parameter-affine maps up to this many entries (one matmul is the
# fastest evaluation when the map fits); larger maps switch to gather +
# index_add_ at O(nnz) memory
_DENSE_MAP_LIMIT = 1 << 20


def _make_map_applier(R, device):
    """Build p_ext (B, n_param+1) -> (R @ p_ext')' (B, rows) for a
    scipy.sparse map R, with R's values held on `device`."""
    n_rows = R.shape[0]
    if n_rows == 0:

        def apply_empty(p_ext):
            return p_ext.new_zeros(p_ext.shape[0], 0)

        return apply_empty
    if R.shape[0] * R.shape[1] <= _DENSE_MAP_LIMIT:
        Rt = torch.as_tensor(R.toarray().T.copy(), device=device)

        def apply_dense(p_ext):
            # full f32: TF32 would perturb the problem data itself at
            # ~1e-3 relative, a floor on every downstream accuracy claim
            with full_f32():
                return p_ext @ Rt.to(p_ext.dtype)

        return apply_dense
    coo = R.tocoo()
    rows = torch.as_tensor(coo.row.astype(np.int64), device=device)
    cols = torch.as_tensor(coo.col.astype(np.int64), device=device)
    vals = torch.as_tensor(coo.data, device=device)

    def apply_sparse(p_ext):
        out = p_ext.new_zeros(p_ext.shape[0], n_rows)
        return out.index_add_(1, rows, vals.to(p_ext.dtype) * p_ext[:, cols])

    return apply_sparse


def _settings_from_args(base: SolverSettings, solver_args) -> SolverSettings:
    if not solver_args:
        return base
    kw = {}
    for k, v in solver_args.items():
        if k in _CHOICES:
            choice = str(v).lower()
            if choice not in _CHOICES[k]:
                allowed = ", ".join(repr(c) for c in _CHOICES[k])
                raise ValueError(f"{k} must be one of {allowed}, got {v!r}")
            kw[k] = choice
            continue
        if k not in _SOLVER_ARG_KEYS:
            raise ValueError(f"unknown solver_args key: {k!r}")
        for field in _SOLVER_ARG_KEYS[k]:
            kw[field] = type(getattr(base, field))(v)
    return base.replace(**kw)


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CvxpyLayer runs on CUDA by default and CUDA is not "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class CvxpyLayer:
    def __init__(
        self,
        problem: Problem,
        parameters: Sequence[Parameter],
        variables: Sequence,
        solver=None,
        gp: bool = False,
        verbose: bool = False,
        solver_args: Optional[dict] = None,
        canon_backend=None,
        device=None,
    ):
        del solver, canon_backend  # single native backend; kept for API parity
        if not isinstance(problem, Problem):
            # optional cvxpy interop: accept a real cvxpy.Problem when
            # cvxpy is installed (canon/cvxpy_interop.py)
            from ..canon.cvxpy_interop import (
                convert_problem,
                is_cvxpy_problem,
            )

            if not is_cvxpy_problem(problem):
                raise ValueError(
                    "problem must be a cvxpylayers_tpu_torch Problem (or "
                    "a cvxpy Problem, when cvxpy is installed)"
                )
            problem, parameters, variables = convert_problem(
                problem, parameters, variables
            )
        self.device = _resolve_device(device)
        prob_params = {id(p) for p in problem.parameters()}
        given = {id(p) for p in parameters}
        if prob_params != given:
            raise ValueError(
                "The layer's parameters must be exactly the problem's "
                "parameters."
            )

        self.gp = bool(gp)
        self._gp_log_mask: List[bool] = []
        self._gp_var_map = None
        if self.gp:
            from ..canon.dgp import Dgp2Dcp, DgpError

            transformer = Dgp2Dcp()
            try:
                log_problem = transformer.transform_problem(problem)
            except DgpError as e:
                raise ValueError(f"Problem is not DGP: {e}") from e
            if not log_problem.is_dcp():
                raise ValueError(
                    "Problem is not DGP (log-log transform is not DCP)."
                )
            # remap parameters in user order; untouched params (never used
            # multiplicatively or as exponent) default to logged
            new_params = []
            for p_ in parameters:
                if id(p_) not in transformer.param_map:
                    raise ValueError(
                        f"parameter {p_.name} does not appear in the problem"
                    )
                np_, logged = transformer.param_map[id(p_)]
                new_params.append(np_)
                self._gp_log_mask.append(logged)
            self._gp_var_map = transformer.var_map
            # the transform rebuilt every constraint, in order
            self._gp_constraint_ids = {
                oc.id: nc.id
                for oc, nc in zip(problem.constraints, log_problem.constraints)
            }
            problem = log_problem
            parameters = new_params

        if not problem.is_dcp():
            raise ValueError("Problem must be DCP (disciplined convex).")
        if not problem.is_dpp():
            raise ValueError(
                "Problem must be DPP (disciplined parametrized programming); "
                "parameters may only enter affinely."
            )
        prob_vars = {id(v) for v in problem.variables()}
        prob_cons = {c.id: c for c in problem.constraints}
        self._outputs = []
        for v in variables:
            if isinstance(v, Variable):
                if self.gp:
                    if id(v) not in self._gp_var_map:
                        raise ValueError(f"{v} is not a variable of the problem")
                    self._outputs.append(("gpvar", self._gp_var_map[id(v)]))
                    continue
                if id(v) not in prob_vars:
                    raise ValueError(f"{v} is not a variable of the problem")
                self._outputs.append(("var", v))
            elif isinstance(v, DualVariable):
                cid = v.constraint.id
                if self.gp:
                    cid = self._gp_constraint_ids.get(cid, cid)
                if cid not in prob_cons:
                    raise ValueError(
                        "dual variable does not belong to a problem constraint"
                    )
                self._outputs.append(("dual", prob_cons[cid], v.part))
            else:
                raise ValueError(
                    f"variables must be Variables or DualVariables, got {v!r}"
                )
        if not self._outputs:
            raise ValueError("variables must be a non-empty list")

        self.parameters = list(parameters)
        self.verbose = bool(verbose)
        self.prog: ConeProgram = stuff(problem, self.parameters)
        self._base_settings = _settings_from_args(
            SolverSettings(), solver_args
        )

        p = self.prog
        dev = self.device
        self._A_flat = torch.as_tensor(p.A_rows * p.n + p.A_cols, device=dev)
        self._b_rows = torch.as_tensor(p.b_rows, device=dev)
        self._P_flat = torch.as_tensor(p.P_rows * p.n + p.P_cols, device=dev)
        # parameter-affine maps (nnz x (n_param+1)): dense (one matmul)
        # when small, gather + index_add_ when the dense map would blow up
        self._apply_A = _make_map_applier(p.reduced_A, dev)
        self._apply_b = _make_map_applier(p.reduced_b, dev)
        self._apply_q = _make_map_applier(p.reduced_q, dev)
        self._apply_P = _make_map_applier(p.reduced_P, dev)
        # static: does every variable column carry structural curvature?
        # (decides the f32 KKT route — Schur split needs a full P diag;
        # LPs and epigraph-aux columns without curvature go to CG-normal)
        diag_mask = np.asarray(p.P_rows) == np.asarray(p.P_cols)
        self._p_diag_full = bool(
            p.P_rows.size
            and len(set(np.asarray(p.P_rows)[diag_mask].tolist()))
            == p.n
        )
        # strictly-diagonal P: the f32 Schur split inverts it elementwise
        self._p_diag_only = bool(self._p_diag_full and diag_mask.all())
        # constant-P/A detection (the reference's PA_is_constant): enables
        # the shared-factor setup/solve split (solver/shared.py)
        self._pa_constant = bool(
            p.m > 0 and p.A_is_constant and p.P_is_constant
        )
        self._shared_solvers: Dict[SolverSettings, object] = {}
        self._shared_consts: Dict[torch.dtype, tuple] = {}
        self._solvers: Dict[SolverSettings, object] = {}
        self._sparse_ops: Optional[SparseOps] = None  # on first sparse solve
        # eager warm-start cache (warm_start=True): the last (x, y, s)
        self._warm: Optional[WarmStart] = None

    # ------------------------------------------------------------------ misc

    @property
    def n_outputs(self) -> int:
        return len(self._outputs)

    def _route(self, settings: SolverSettings) -> str:
        """'dense' or 'sparse' per-instance data representation. Dense is
        the faster at bench sizes (n ~ 50-150); sparse is the large-
        instance route (O(nnz) matvecs, no dense (m, n) scatter, no
        factorization: solver/matfree.py)."""
        if settings.assembly != "auto":
            return settings.assembly
        p = self.prog
        if p.m and p.m * p.n > _DENSE_ASSEMBLY_LIMIT:
            return "sparse"
        return "dense"

    def _ops(self) -> SparseOps:
        if self._sparse_ops is None:
            p = self.prog
            self._sparse_ops = SparseOps(p.A_rows, p.A_cols, p.m, p.n,
                                         p.P_rows, p.P_cols)
        return self._sparse_ops

    def _use_shared(self, settings: SolverSettings) -> bool:
        """True when the constant-P/A shared-factor setup/solve split
        applies (solver/shared.py): dense assembly only."""
        if settings.shared_setup == "off":
            return False
        applicable = (
            self._pa_constant
            and settings.solve_method == "admm"
            and settings.accel_lookback == 0
            and self._route(settings) == "dense"
        )
        if settings.shared_setup == "on" and not applicable:
            raise ValueError(
                "shared_setup='on' requires parameter-independent P and"
                " A, solve_method='admm', accel_lookback=0 and the "
                "dense assembly route"
            )
        return applicable

    def _shared_solver(self, settings: SolverSettings):
        if settings not in self._shared_solvers:
            from ..solver.shared import make_shared_admm_solver

            self._shared_solvers[settings] = make_shared_admm_solver(
                self.prog.dims, self.prog.n, settings,
                self.prog.constant_P(), self.prog.constant_A(),
            )
        return self._shared_solvers[settings]

    def _solver(self, settings: SolverSettings):
        if settings not in self._solvers:
            if self._route(settings) == "sparse":
                self._solvers[settings] = make_matfree_diff_solver(
                    self._ops(), self.prog.dims, self.prog.n, settings,
                    p_diag_only=self._p_diag_only,
                )
            else:
                self._solvers[settings] = make_diff_solver(
                    self.prog.dims, self.prog.n, settings,
                    p_diag_full=self._p_diag_full,
                    p_diag_only=self._p_diag_only,
                    p_zero=self.prog.P_rows.size == 0,
                )
        return self._solvers[settings]

    # ------------------------------------------------------------- batching

    def _parse_batch(self, params) -> Tuple[Optional[int], List[bool]]:
        if len(params) != len(self.parameters):
            raise ValueError(
                f"expected {len(self.parameters)} parameters, got {len(params)}"
            )
        batch: Optional[int] = None
        batched_flags = []
        for arr, p in zip(params, self.parameters):
            if not isinstance(arr, torch.Tensor):
                raise TypeError(
                    f"parameter {p.name} must be a torch.Tensor on "
                    f"{self.device}, got {type(arr).__name__}"
                )
            if arr.device != self.device:
                raise ValueError(
                    f"parameter {p.name} is on {arr.device}, the layer on "
                    f"{self.device}; move it there first"
                )
            shape = tuple(arr.shape)
            if shape == p.shape:
                batched_flags.append(False)
            elif len(shape) == len(p.shape) + 1 and shape[1:] == p.shape:
                batched_flags.append(True)
                if batch is None:
                    batch = shape[0]
                elif batch != shape[0]:
                    raise ValueError(
                        f"inconsistent batch sizes: {batch} vs {shape[0]} "
                        f"for parameter {p.name}"
                    )
            else:
                raise ValueError(
                    f"parameter {p.name} expects shape {p.shape} "
                    f"(or batched (B, *{p.shape})), got {shape}"
                )
        return batch, batched_flags

    def _stack_params(self, params, batch, batched_flags) -> torch.Tensor:
        """Build p_ext of shape (B, n_param + 1) (B=1 when unbatched)."""
        B = batch or 1
        if params:
            dtype = params[0].dtype
            for arr in params[1:]:
                dtype = torch.promote_types(dtype, arr.dtype)
        else:
            dtype = torch.float64
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(
                f"parameters must be float32 or float64, got {dtype}"
            )
        cols = []
        log_mask = self._gp_log_mask or [False] * len(self.parameters)
        for arr, p, is_b, lg in zip(params, self.parameters, batched_flags,
                                    log_mask):
            arr = arr.to(dtype)
            if lg:
                arr = torch.log(arr)
            flat = (
                arr.reshape(B, p.size)
                if is_b
                else arr.reshape(p.size).expand(B, p.size)
            )
            cols.append(flat)
        cols.append(torch.ones(B, 1, dtype=dtype, device=self.device))
        return torch.cat(cols, dim=1)

    # -------------------------------------------------------------- forward

    def _assemble(self, p_ext: torch.Tensor):
        """p_ext (B, n_param+1) -> dense batched (P, q, A, b, offset)."""
        prog = self.prog
        B = p_ext.shape[0]
        n, m = prog.n, prog.m
        A = p_ext.new_zeros(B, m * n)
        A[:, self._A_flat] = self._apply_A(p_ext)
        q, b, offset = self._assemble_qb(p_ext)
        P = p_ext.new_zeros(B, n * n)
        if prog.P_rows.size:
            P.index_add_(1, self._P_flat, self._apply_P(p_ext))
        P = P.view(B, n, n)
        if prog.P_rows.size:
            P = 0.5 * (P + P.mT)
        return P.contiguous(), q, A.view(B, m, n), b, offset

    def _assemble_sparse(self, p_ext: torch.Tensor):
        """p_ext (B, n_param+1) -> (P_data, q, A_data, b, offset): the
        static-pattern value tensors of solver/matfree.py, with no dense
        (m, n) or (n, n) scatter, so the per-instance footprint is
        O(nnz)."""
        q, b, offset = self._assemble_qb(p_ext)
        P_data = (self._apply_P(p_ext) if self.prog.P_rows.size
                  else p_ext.new_zeros(p_ext.shape[0], 0))
        return P_data, q, self._apply_A(p_ext), b, offset

    def _assemble_qb(self, p_ext: torch.Tensor):
        """p_ext (B, n_param+1) -> (q, b, offset) only: the shared
        route's assembly (P and A are constants there)."""
        b = p_ext.new_zeros(p_ext.shape[0], self.prog.m)
        b[:, self._b_rows] = self._apply_b(p_ext)
        q_full = self._apply_q(p_ext)
        return q_full[:, :-1].contiguous(), b, q_full[:, -1]

    def _shared_constants(self, dtype: torch.dtype):
        """The constant P (n, n) and A (m, n) on the layer's device."""
        if dtype not in self._shared_consts:
            self._shared_consts[dtype] = tuple(
                torch.as_tensor(a, dtype=dtype, device=self.device)
                for a in (self.prog.constant_P(), self.prog.constant_A())
            )
        return self._shared_consts[dtype]

    def _solve_shared(self, settings, p_ext, x0, y0, s0):
        """The two-phase constant-P/A solve: the shared-factor batched
        ADMM (solver/shared.py) without autograd, then the per-instance
        polish and implicit adjoint with the ADMM loop off
        (max_iters=0), warm-started at the shared phase's iterates. P
        and A enter the polish as constants expanded to the batch (no
        copies, no gradient), so gradients flow to q and b through the
        per-instance implicit-function rule alone."""
        shared = self._shared_solver(settings)
        solver = self._solver(
            settings.replace(max_iters=0, scaling_iters=0))
        q, b, _ = self._assemble_qb(p_ext)
        with torch.no_grad():
            res = shared(q.detach(), b.detach(), x0, y0, s0)
        B = p_ext.shape[0]
        P_c, A_c = self._shared_constants(p_ext.dtype)
        x, y, s, st_in, _ = solver(
            P_c.expand(B, *P_c.shape), q, A_c.expand(B, *A_c.shape), b,
            res.x, res.y, res.s)
        # the polish cannot see infeasibility (it only measures KKT
        # residuals): the shared phase's certificates win
        certified = ((res.status == PRIMAL_INFEASIBLE)
                     | (res.status == DUAL_INFEASIBLE))
        status = torch.where(certified, res.status, st_in)
        return x, y, s, status, res.iters

    def _recover(self, x, y):
        """Batched (B, n) / (B, m) iterates -> the requested outputs, each
        with the batch axis first."""
        outs = []
        prog = self.prog
        B = x.shape[0]
        for entry in self._outputs:
            kind, obj = entry[0], entry[1]
            if kind in ("var", "gpvar"):
                vi = prog.var_info[id(obj)]
                if kind == "var" and vi.symmetric:
                    s = vi.shape[0]
                    d = s * (s + 1) // 2
                    outs.append(svec_to_sym(x[:, vi.offset:vi.offset + d], s))
                    continue
                size = int(np.prod(vi.shape or (1,)))
                sl = x[:, vi.offset:vi.offset + size].reshape(
                    (B,) + tuple(vi.shape))
                # a gp variable is solved for in log space
                outs.append(torch.exp(sl) if kind == "gpvar" else sl)
                continue
            part = entry[2]
            di = prog.dual_info[obj.id]
            sl = y[:, di.offset:di.offset + di.length]
            if di.kind in ("zero", "nonneg") and di.shape is not None:
                outs.append(sl.reshape((B,) + tuple(di.shape)))
            elif di.kind == "psd":
                outs.append(svec_to_sym(sl, di.meta))
            elif di.kind == "soc":
                # part 0 is the scalar t-dual, part 1 the X-shaped dual
                if part == 0:
                    outs.append(sl[:, 0])
                else:
                    outs.append(sl[:, 1:].reshape(
                        (B,) + tuple(obj.args[1].shape)))
            elif di.kind in ("exp", "pow"):
                # rows are interleaved (x_i, y_i, z_i) triples; part
                # selects the x/y/z component, in the argument's shape
                outs.append(sl[:, part::3].reshape(
                    (B,) + tuple(obj.args[0].shape)))
            else:
                outs.append(sl)
        return tuple(outs)

    def __call__(self, *params, solver_args: Optional[dict] = None,
                 warm_start=False):
        """Solve and return the requested variables; raises SolverError
        on failure (solve_with_info / solve_and_state never raise)."""
        outs, _, status, _ = self._solve(params, solver_args, warm_start)
        self._maybe_raise(status)
        return outs

    def solve_with_info(self, *params, solver_args: Optional[dict] = None,
                        warm_start=False):
        """Like __call__ but returns (outs, status, iters) and never
        raises on solver failure."""
        outs, _, status, iters = self._solve(params, solver_args, warm_start)
        return outs, status, iters

    def solve_and_state(self, *params, solver_args: Optional[dict] = None,
                        warm_start=None):
        """Solve and additionally return a WarmStart for the next call.
        Never raises on solver failure."""
        outs, ws, status, iters = self._solve(
            params, solver_args, warm_start if warm_start is not None else False
        )
        return outs, ws, status, iters

    def _solve(self, params, solver_args, warm_start):
        settings = _settings_from_args(self._base_settings, solver_args)
        prog = self.prog
        batch, batched_flags = self._parse_batch(params)
        p_ext = self._stack_params(params, batch, batched_flags)
        B = p_ext.shape[0]
        n, m = prog.n, prog.m
        dtype = p_ext.dtype

        x0 = p_ext.new_zeros(B, n)
        y0 = p_ext.new_zeros(B, m)
        s0 = p_ext.new_zeros(B, m)
        if isinstance(warm_start, WarmStart):
            if tuple(warm_start.x.shape) != (B, n):
                raise ValueError(
                    f"warm_start batch/shape mismatch: expected ({B}, {n}),"
                    f" got {tuple(warm_start.x.shape)}"
                )
            for t in warm_start:
                if t.device != self.device:
                    raise ValueError(
                        f"warm_start is on {t.device}, the layer on "
                        f"{self.device}"
                    )
            x0, y0, s0 = (t.detach().to(dtype) for t in warm_start)
        elif warm_start and self._warm is not None:
            # eager cache: the previous call's solution, if it fits
            if tuple(self._warm.x.shape) == (B, n):
                x0, y0, s0 = (t.to(dtype) for t in self._warm)

        # the assembly records an autograd graph; the solve is one
        # autograd.Function with the implicit adjoint
        def run():
            if self._use_shared(settings):
                return self._solve_shared(settings, p_ext, x0, y0, s0)
            assemble = (self._assemble_sparse
                        if self._route(settings) == "sparse"
                        else self._assemble)
            P, q, A, b, _ = assemble(p_ext)
            return self._solver(settings)(P, q, A, b, x0, y0, s0)

        if settings.matmul_precision != "default":
            with full_f32():
                x, y, s, status, iters = run()
        else:
            x, y, s, status, iters = run()

        if self.verbose:
            st = status.cpu()
            it = iters.cpu()
            print(
                f"cvxpylayers_tpu_torch: solved {int((st == 0).sum())}/"
                f"{st.shape[0]} instances, iters min={int(it.min())} "
                f"max={int(it.max())}, worst status={int(st.max())}"
            )

        next_ws = WarmStart(x=x.detach(), y=y.detach(), s=s.detach())
        if warm_start is True:
            self._warm = next_ws
        outs_b = self._recover(x, y)
        if batch is None:
            outs = tuple(o[0] for o in outs_b)
            st, it = status[0], iters[0]
        else:
            outs = outs_b
            st, it = status, iters
        return outs, next_ws, st, it

    def _maybe_raise(self, status):
        """Raise SolverError on failure (one host read of the statuses;
        tolist also reads a status that torch.func.jvp has wrapped)."""
        st = np.asarray(status.tolist())
        if np.any(st == PRIMAL_INFEASIBLE):
            raise SolverError("Problem is primal infeasible.")
        if np.any(st == DUAL_INFEASIBLE):
            raise SolverError("Problem is unbounded (dual infeasible).")
        if np.any(st == MAX_ITERS):
            raise SolverError(
                "Solver did not reach the requested accuracy "
                "(max_iters). Try increasing max_iters or loosening eps."
            )

    # ----------------------------------------------------- plain-solve path

    def _pobj(self, settings: SolverSettings, p_ext: torch.Tensor):
        """The per-instance solve of p_ext (B, n_param+1) from a cold
        start, with the canonical objective 0.5 x'Px + q'x + offset,
        computed outside the solve's autograd.Function so it stays plain
        differentiable torch. Returns (x, y, status, iters, pobj)."""
        sparse = self._route(settings) == "sparse"
        P, q, A, b, off = (self._assemble_sparse if sparse
                           else self._assemble)(p_ext)
        B = p_ext.shape[0]
        n, m = self.prog.n, self.prog.m
        x, y, _, status, iters = self._solver(settings)(
            P, q, A, b, p_ext.new_zeros(B, n), p_ext.new_zeros(B, m),
            p_ext.new_zeros(B, m))
        # elementwise products and sums: no TF32 matmul in the value
        Px = (self._ops().P_mv(P, x) if sparse
              else (P * x.unsqueeze(-2)).sum(-1))
        pobj = 0.5 * (x * Px).sum(-1) + (q * x).sum(-1) + off
        return x, y, status, iters, pobj

    def solve_values(self, *params, solver_args: Optional[dict] = None):
        """Unbatched solve returning (outs, status, iters, canonical
        objective value). Powers Problem.solve(); never raises on solver
        failure."""
        settings = _settings_from_args(self._base_settings, solver_args)
        batch, flags = self._parse_batch(params)
        if batch is not None:
            raise ValueError("solve_values expects unbatched parameters")
        p_ext = self._stack_params(params, None, flags)
        if settings.matmul_precision != "default":
            with full_f32():
                x, y, status, iters, pobj = self._pobj(settings, p_ext)
        else:
            x, y, status, iters, pobj = self._pobj(settings, p_ext)
        outs = tuple(o[0] for o in self._recover(x, y))
        return outs, status[0], iters[0], pobj[0]


# cvxpy status strings (reference semantics: Problem.solve sets
# problem.status and returns the optimal value)
_STATUS_STRINGS = {
    SOLVED: "optimal",
    MAX_ITERS: "optimal_inaccurate",
    PRIMAL_INFEASIBLE: "infeasible",
    DUAL_INFEASIBLE: "unbounded",
}


def solve_problem(problem, solver_args: Optional[dict] = None,
                  gp: bool = False, device=None):
    """cvxpy-style plain solve: evaluate `Parameter.value`s, solve once
    on `device` (the card by default; it raises where CUDA is absent),
    populate `Variable.value`, `DualVariable.value`, `problem.status`,
    `problem.value` and `problem.solver_stats`; return the optimal value.

    The layer is cached on the problem, one per (gp flag, device), so
    re-solving after changing parameter values reuses the canonicalized
    program and its solver.
    """
    params = problem.parameters()
    for par in params:
        if par.value is None:
            raise ValueError(
                f"parameter {par.name} has no value; set Parameter.value "
                "before Problem.solve()"
            )
    dev = _resolve_device(device)
    cache = getattr(problem, "_solve_layers", None)
    if cache is None:
        cache = {}
        problem._solve_layers = cache
    key = (bool(gp), dev)
    if key not in cache:
        variables = list(problem.variables())
        duals = [d for c in problem.constraints for d in c.dual_variables]
        cache[key] = (
            CvxpyLayer(problem, parameters=params,
                       variables=variables + duals, gp=gp, device=dev),
            variables, duals,
        )
    layer, variables, duals = cache[key]
    # the problem's parameters, in the layer's order (under gp the layer
    # holds log-space copies without values, and logs these itself)
    vals = [torch.as_tensor(par.value, device=dev) for par in params]
    t0 = time.perf_counter()
    outs, status, iters, pobj = layer.solve_values(
        *vals, solver_args=solver_args
    )
    st = int(status)  # a host read: the clock stops after the device's work
    problem.solver_stats = types.SimpleNamespace(
        num_iters=int(iters), solve_time=time.perf_counter() - t0,
        solver_name="cvxpylayers_tpu_torch",
    )
    problem.status = _STATUS_STRINGS.get(st, "solver_error")
    maximize = layer.prog.maximize
    if st in (PRIMAL_INFEASIBLE, DUAL_INFEASIBLE):
        inf = float("inf")
        if st == PRIMAL_INFEASIBLE:
            problem.value = -inf if maximize else inf
        else:
            problem.value = inf if maximize else -inf
        for var in variables:
            var.value = None
        for d in duals:
            d.value = None
        return problem.value
    for var, out in zip(variables, outs[:len(variables)]):
        var.value = out.detach().cpu().numpy()
    for d, out in zip(duals, outs[len(variables):]):
        d.value = out.detach().cpu().numpy()
    val = float(pobj)
    if maximize:
        val = -val
    if gp:
        val = float(np.exp(val))
    problem.value = val
    return val
