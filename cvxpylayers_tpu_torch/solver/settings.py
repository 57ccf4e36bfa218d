"""Solver settings (static — part of the jit cache key)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """ADMM + refinement settings.

    The accuracy contract is two-stage: ADMM converges linearly to
    eps_abs/eps_rel (default 1e-6 — enough to identify the active cone
    faces), then the semismooth-Newton polish (refine_steps) converges
    superlinearly to near machine precision. This replaces tightening
    eps/tol in the reference's native solvers (cvxpylayers
    tests/test_torch.py:787) at a fraction of the iterations.
    """

    eps_abs: float = 1e-8        # final (post-polish) KKT tolerance
    eps_rel: float = 1e-8
    eps_gap_scale: float = 1.0   # multiplier on the duality-gap term of
    # every SOLVED certificate (post-polish and first-order internal
    # stopping). Residual tolerances are unaffected. The escape hatch
    # for the documented f32 limitation on flat-epigraph classes
    # (sum_largest/huber-style degenerate aux intervals): the dual can
    # stay ~1e-3 loose while the primal residuals and the solution are
    # tight, so gap certification at eps 1e-4 fails those lanes on
    # EVERY f32 route (refine.py); set ~10-100 there (or inf to drop
    # the gap term entirely and accept residual-only certification —
    # which bounds nothing at large |x|_1|y|_1 scales, the OT-LP
    # lesson, so prefer a finite scale).
    admm_eps_abs: float = 1e-5   # internal ADMM stopping tolerance: just
    admm_eps_rel: float = 1e-5   # accurate enough for active-set identification
    eps_infeas: float = 1e-9
    max_iters: int = 4000
    epoch: int = 25              # iterations between residual/rho checks
    rho: float = 0.1
    rho_eq_scale: float = 1e3    # rho boost on zero-cone (equality) rows
    rho_min: float = 1e-6
    rho_max: float = 1e6
    adaptive_rho: bool = True
    adaptive_rho_tol: float = 5.0  # update when ratio outside [1/tol, tol]
    adaptive_rho_clamp: float = 10.0  # max per-update change factor
    sigma: float = 1e-6
    alpha: float = 1.6
    accel_lookback: int = 0      # Anderson acceleration history depth
    # for the ADMM fixed-point map (0 = off). Type-II AA on the
    # pre-projection state with residual-growth restarts; the SCS
    # acceleration_lookback role (solver_args accepts either name).
    # Typical useful range 3-10 on slowly-converging (LP/exp-cone)
    # problems; the per-iteration overhead is ~L*d flops + an (L, L)
    # masked-loop solve. Dense-assembly route only (the matrix-free
    # route ignores it).
    scaling_iters: int = 10      # Ruiz equilibration iterations (0 = off)
    solve_method: str = "admm"   # "admm" (+polish), "ipm", or "pdhg"
    # (matvec-only first-order conic-LP solver + polish — the MPAX
    # raPDHG role; requires a structurally zero P)
    ipm_mode: str = "auto"       # IPM formulation: "auto" = the
    # homogeneous self-dual embedding (intrinsic tau/kappa infeasibility
    # certificates, tau-scale-invariant f32 residuals) whenever P is
    # structurally zero, primal-dual otherwise; "hsde" forces the
    # embedding (errors if the problem has a quadratic objective);
    # "pd" forces the primal-dual form
    derivative: str = "adjoint"  # differentiation rule: "adjoint"
    # (custom_vjp; reverse mode — training loops) or "forward"
    # (custom_jvp; enables jax.jvp / jax.jacfwd through the layer, the
    # diffcp `derivative` direction — per-instance solution Jacobians)
    refine_steps: int = 10       # semismooth Newton polish iterations
    ipm_max_iters: int = 100     # IPM iteration cap (IPM iters are ~100x an
    # ADMM iter, so it gets its own knob; solver_args {"max_iters": k}
    # lowers both so user intent is honored on either path)
    ipm_eps_abs: float = 0.0     # internal IPM convergence target
    # (0 = use eps_abs). Like admm_eps, this can be TIGHTER than the
    # final post-polish eps: an IPM that quits exactly at eps can hand
    # the Newton polish a point on the EDGE of its basin on doubly
    # degenerate instances — eps/10 lands inside it (see ipm.py)
    cg_iters: int = 40           # CG budget for the f32 general-cone
    # KKT solve (normal equations; conditioning is squared, so this
    # needs more iterations than schur_iters)
    kkt_mode: str = "auto"       # f32 general-cone KKT strategy:
    # "auto" = CG on the normal equations (matmul-only, fast on TPU),
    # with the H materialized densely inside the measured
    # [DENSE_NORMAL_MIN, DENSE_NORMAL_MAX] KKT-dimension window;
    # "operator" = like auto but never materializes H (matvec-only) —
    # the escape hatch for problems near the window's cliff edges;
    # "pcg" = stale-factor preconditioned CGNR: ONE batched f32 LU +
    # Newton-Schulz-refined explicit inverse per polish, reused as a
    # left preconditioner by every Newton step (6 PCG iterations reach
    # the f32 floor regardless of kappa — the high-accuracy choice for
    # curvature-deficient exp/PSD polishes);
    # "spectral" = the exact spectral-Schur factorization — strictly
    # better directions (e.g. Markowitz-class SOCP solved fraction
    # 0.95 -> 1.0), but each Newton step pays batched cholesky
    # custom-calls that are ~5x slower end-to-end on the current TPU
    # backend; recommended on CPU or when accuracy trumps throughput
    schur_iters: int = 0         # CG budget for the f32 polyhedral Schur
    # KKT solve; 0 = auto (the Schur system's effective dimension is the
    # active-set size and its conditioning is unsquared, so ~15
    # iterations usually reach the f32 floor)
    assembly: str = "auto"       # per-instance data representation:
    # "dense" = scatter into (n, n) P / (m, n) A (fastest at bench sizes,
    # everything batched on the MXU); "sparse" = static-pattern value
    # vectors + matrix-free solves (solver/matfree.py — the large-
    # instance route, O(nnz) per matvec, no factorizations);
    # "auto" = dense until m*n crosses matfree._DENSE_ASSEMBLY_LIMIT
    linsys_iters: int = 10       # matrix-free ADMM x-update CG budget
    # (warm-started at the previous iterate; SCS-indirect-style)
    shared_setup: str = "auto"   # constant-P/A setup/solve split
    # (solver/shared.py — the reference Moreau `PA_is_constant` +
    # setup() amortization, moreau_if.py:237-256): when P and A are
    # parameter-independent, hoist the per-epoch (n, n) factorization
    # out of the batch (ONE shared factor instead of B identical ones;
    # first epoch constant-folded by XLA) and run the ADMM inner loop
    # as shared-operand (B, m) @ (m, n) matmuls, then hand the result
    # to the standard per-instance polish + custom_vjp as a warm start.
    # "auto" = on whenever the stuffer detects constant P and A (dense
    # ADMM route only); "on" = error if not detected; "off" = always
    # use the vmapped per-instance route
    psd_proj: str = "auto"       # PSD projection inside FIRST-ORDER inner
    # loops (ADMM/PDHG iterations only — statuses, infeasibility
    # certificates and the Newton polish always use exact eigh):
    # "auto"/"ns" = matmul-only Newton-Schulz sign approximation (the
    # batched eigh LAPACK custom-call inside the iteration scan is
    # 15x end-to-end on the 16x16-block SDP bench class, r5-measured);
    # "exact" = eigh everywhere (the escape hatch if the smoothed
    # projection parks ADMM outside the polish basin on a problem)
    ipm_kkt: str = "auto"        # f32 IPM condensed-KKT factorization at
    # blocked sizes (n > batched_linalg.MASKED_MAX_DIM): "auto"/"chol" =
    # Jacobi-scaled Cholesky of the normal matrix M'M (one MXU matmul +
    # a bandwidth-bound chol; r5 — killed the blocked-QR that was half
    # the n=500 device time), "qr" = the blocked-WY semi-normal QR of M
    # (error ~ eps*sqrt(cond) instead of eps*cond — the escape hatch if
    # a problem's scaled S is too ill-conditioned for chol + the
    # iterative-refinement pass). Masked (small-n) sizes always use the
    # per-column Householder loop.
    matmul_precision: str = "default"  # "default" | "high" | "highest":
    # wraps the WHOLE solve in jax.default_matmul_precision. On TPU,
    # f32 matmuls feed the MXU bf16 inputs by default, which perturbs
    # problem data and residuals by ~1e-3 relative; the
    # cancellation-critical spots (KKT residual, data assembly, Q
    # construction) are always pinned to "highest" internally, but
    # borderline-degenerate instances can still land in a different
    # polish basin than CPU f32. "highest" makes TPU f32 track CPU f32
    # at a modest matmul slowdown — set it when the last fraction of a
    # percent of solved instances matters more than throughput.

    def replace(self, **kw) -> "SolverSettings":
        return dataclasses.replace(self, **kw)


# Status codes (jit-friendly ints; the eager layer API maps them to
# exceptions mirroring diffcp.SolverError semantics — reference
# tests/test_torch.py:299-316).
SOLVED = 0
MAX_ITERS = 1
PRIMAL_INFEASIBLE = 2
DUAL_INFEASIBLE = 3
