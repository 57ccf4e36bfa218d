"""Plain reference for `optnet_box_qp`: argmin ||y - v||^2 s.t. G y <= h,
0 <= y <= 1, and its gradients.

The program canonicalises the layer into a cone program, solves it by
ADMM or its interior-point method with a Newton polish, and
differentiates the cone program's solution map. This file works from the
problem as written: the inequalities are stacked as A y <= b with
A = [G; -I; I] and b = [h; 0; 1], solved by a primal-dual interior-point
method (Mehrotra's predictor-corrector on the normal equations
(2I + A' diag(lam/s) A) dy = r) from the strictly feasible point y = c 1,
0 < c <= 1/2 (h > 0 for every instance of this configuration), polished
on its active set, and differentiated through its KKT conditions

    2 (y - v) + A' lam = 0,    lam * (A y - b) = 0,

as OptNet does: for a cotangent ybar, solve K' u = [ybar; 0] with
K = [[2I, A'], [diag(lam) A, diag(A y - b)]], and read
dv = 2 u1, dA = -(lam u1' + (lam * u2) y'), db = lam * u2.

Batched plain torch on whatever device the inputs live on; imports
nothing of the program.
"""

from __future__ import annotations

import torch

from cvxbench.reference.numerics import dtype_of, mv, mm, tolerance


def stacked(G: torch.Tensor, h: torch.Tensor):
    """(A, b) of A y <= b: G's rows, then -y <= 0, then y <= 1."""
    B, _, n = G.shape
    eye = torch.eye(n, dtype=G.dtype, device=G.device).expand(B, n, n)
    A = torch.cat([G, -eye, eye], dim=1)
    b = torch.cat([h, G.new_zeros(B, n), G.new_ones(B, n)], dim=1)
    return A, b


def _max_step(x: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Largest a <= 1 (per lane) with x + a dx >= 0."""
    ratio = torch.where(dx < 0, -x / dx.clamp(max=-1e-300), torch.ones_like(x))
    return ratio.amin(-1).clamp(max=1.0)


def solve(v, G, h, precision: str = "float64", max_iters: int = 100):
    """(y, lam, converged) for every lane; lam holds the multipliers of
    A y <= b in stacked()'s row order."""
    dt = dtype_of(precision)
    v, G, h = (t.detach().to(dt) for t in (v, G, h))
    A, b = stacked(G, h)
    At = A.transpose(1, 2).contiguous()
    B, m, n = A.shape
    tol = tolerance(precision)
    scale = 1.0 + torch.maximum(v.abs().amax(-1), h.abs().amax(-1))
    if bool((h <= 0).any()):
        raise ValueError("the interior-point start needs h > 0")
    # y = c 1 with G y <= h / 2 on every row
    row = G.clamp(min=0).sum(-1)
    c = (0.5 * h / row.clamp(min=1e-30)).amin(-1).clamp(max=0.5)
    y = c[:, None].expand(B, n).clone()
    s = b - mv(A, y, precision)
    lam = 1.0 / s
    eye2 = 2.0 * torch.eye(n, dtype=dt, device=v.device)
    done = torch.zeros(B, dtype=torch.bool, device=v.device)
    for _ in range(max_iters):
        rd = 2.0 * (y - v) + mv(At, lam, precision)
        rp = mv(A, y, precision) + s - b
        mu = (s * lam).sum(-1) / m
        res = torch.maximum(rd.abs().amax(-1), rp.abs().amax(-1)) / scale
        done = done | ((res < tol) & (mu < tol))
        if bool(done.all()):
            break
        W = lam / s
        H = eye2 + mm(At * W.unsqueeze(1), A, precision)
        L, info = torch.linalg.cholesky_ex(H)
        ok = info == 0

        def direction(rc):
            r = -rd - mv(At, W * rp + rc / s, precision)
            dy = torch.cholesky_solve(r.unsqueeze(-1), L).squeeze(-1)
            dlam = W * (mv(A, dy, precision) + rp) + rc / s
            ds = (rc - s * dlam) / lam
            return dy, ds, dlam

        dy, ds, dlam = direction(-s * lam)
        a = torch.minimum(_max_step(s, ds), _max_step(lam, dlam))
        mu_aff = ((s + a[:, None] * ds) * (lam + a[:, None] * dlam)).sum(-1) / m
        sigma = (mu_aff / mu).clamp(0.0, 1.0) ** 3
        rc = -s * lam + (sigma * mu)[:, None] - ds * dlam
        dy, ds, dlam = direction(rc)
        a = 0.99 * torch.minimum(_max_step(s, ds), _max_step(lam, dlam))
        go = (~done & ok & torch.isfinite(dy).all(-1))[:, None]
        y = torch.where(go, y + a[:, None] * dy, y)
        s = torch.where(go, s + a[:, None] * ds, s)
        lam = torch.where(go, lam + a[:, None] * dlam, lam)
    y, lam, polished = polish(v, A, b, y, s, lam, precision)
    return y, lam, done | polished


def polish(v, A, b, y, s, lam, precision: str):
    """The interior-point iterate made exact on its active set: rows
    with lam > s hold as equalities, the rest get lam = 0, and
    [[2I, A' M], [M A, I - M]] [y; lam] = [2v; M b] is solved. A lane
    keeps the polished point only where it is optimal (lam >= 0,
    A y <= b, to the working precision's rounding): a weakly active
    row whose multiplier and slack are both near 0 is where an
    interior-point method converges slowest. Returns (y, lam, kept)."""
    B, m, n = A.shape
    M = (lam > s).to(y.dtype)
    K = y.new_zeros(B, n + m, n + m)
    K[:, :n, :n] = 2.0 * torch.eye(n, dtype=y.dtype, device=y.device)
    K[:, :n, n:] = A.transpose(1, 2) * M.unsqueeze(1)
    K[:, n:, :n] = M.unsqueeze(-1) * A
    K[:, n:, n:] = torch.diag_embed(1.0 - M)
    rhs = torch.cat([2.0 * v, M * b], dim=1)
    sol, info = torch.linalg.solve_ex(K, rhs)
    yp, lp = sol[:, :n], sol[:, n:]
    eps = 100.0 * torch.finfo(y.dtype).eps * (1.0 + b.abs().amax(-1))
    ok = ((info == 0) & (lp >= -eps[:, None]).all(-1)
          & (mv(A, yp, precision) - b <= eps[:, None]).all(-1))
    return (torch.where(ok[:, None], yp, y),
            torch.where(ok[:, None], lp.clamp(min=0), lam), ok)


def vjp(v, G, h, y, lam, ybar, precision: str = "float64"):
    """(dv, dG, dh): the gradient of <ybar, y*(v, G, h)> at the solution
    (y, lam) that solve() returned."""
    dt = dtype_of(precision)
    v, G, h, y, lam, ybar = (t.detach().to(dt)
                             for t in (v, G, h, y, lam, ybar))
    A, b = stacked(G, h)
    B, m, n = A.shape
    K = y.new_zeros(B, n + m, n + m)
    K[:, :n, :n] = 2.0 * torch.eye(n, dtype=dt, device=y.device)
    K[:, :n, n:] = A.transpose(1, 2)
    K[:, n:, :n] = lam.unsqueeze(-1) * A
    # a row with both its multiplier and its slack at exactly 0 (a
    # polished lane's degenerate row) is taken as inactive
    slack = (mv(A, y, precision) - b).clamp(max=-torch.finfo(dt).tiny)
    K[:, n:, n:] = torch.diag_embed(slack)
    rhs = torch.cat([ybar, y.new_zeros(B, m)], dim=1)
    u = torch.linalg.solve(K.transpose(1, 2), rhs)
    u1, u2 = u[:, :n], u[:, n:]
    dv = 2.0 * u1
    dA = -(lam.unsqueeze(-1) * u1.unsqueeze(1)
           + (lam * u2).unsqueeze(-1) * y.unsqueeze(1))
    db = lam * u2
    mg = G.shape[1]
    return dv, dA[:, :mg], db[:, :mg]


def solve_and_grad(params, out_bars, config, precision="float64"):
    """The harness's entry: ([y], [dv, dG, dh] or None, converged) for
    the lanes of `params` = [v, G, h]; `out_bars` = [ybar] or None for a
    forward check alone."""
    v, G, h = params
    y, lam, ok = solve(v, G, h, precision)
    grads = None
    if out_bars is not None:
        grads = list(vjp(v, G, h, y, lam, out_bars[0], precision))
    return [y], grads, ok
