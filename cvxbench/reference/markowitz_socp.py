"""Plain reference for `markowitz_socp`: argmax mu'w s.t. ||F w||_2 <= r,
1'w = 1, w >= 0, and its gradients.

The program canonicalises the layer into a cone program with a
second-order cone and solves it by ADMM, with an interior-point rescue of
the lanes ADMM leaves. This file works from the problem as written, with
the risk budget squared (||F w||^2 <= r^2 has the same solutions): a
barrier method from the equal-weight portfolio (strictly feasible, since
||F 1/n|| is far below r for these instances), each centering a damped
Newton descent on

    -t mu'w - sum(log w) - log(r^2 - ||F w||^2)   s.t. 1'w = 1,

with the variables scaled by w so the Newton systems stay well posed
near the boundary, and t raised tenfold until (n + 1) / t is below the
target. Beyond that target the barrier's gradient cancels terms of size
t |mu|, so the point is then polished: Newton's method on the KKT
conditions below with its active set held (w_i = 0 where w_i < lam_i,
the budget an equality where nu > r^2 - ||F w||^2, else nu = 0), kept
where the result is optimal. The gradients come from the KKT conditions in z = (w, lam, nu,
gamma),

    -mu - lam + 2 nu F'F w + gamma 1 = 0,    lam * w = 0,
    nu (||F w||^2 - r^2) = 0,                1'w = 1,

at the multipliers lam = 1 / (t w), nu = 1 / (t (r^2 - ||F w||^2)): for a
cotangent wbar, solve K' u = [wbar; 0; 0; 0] with K the Jacobian in z,
and read dmu = u1 and dF = -2 nu ((F w) u1' + (F u1) w' + u3 (F w) w').

Batched plain torch on whatever device the inputs live on; imports
nothing of the program.
"""

from __future__ import annotations

import torch

from cvxbench.reference.numerics import dtype_of, mm, mv


def solve(mu, F, r: float, precision: str = "float64",
          max_newton: int = 80):
    """(w, lam, nu, gamma, converged) for every lane."""
    dt = dtype_of(precision)
    mu, F = (t.detach().to(dt) for t in (mu, F))
    B, n = mu.shape
    Ft = F.transpose(1, 2).contiguous()
    FtF = mm(Ft, F, precision)
    # as far along the central path as the precision resolves it
    gap_target, newton_tol = ((1e-7, 1e-9) if precision == "float64"
                              else (1e-4, 1e-4))
    w = torch.full_like(mu, 1.0 / n)
    Fw = mv(F, w, precision)
    if bool(((Fw * Fw).sum(-1) >= r * r).any()):
        raise ValueError("the equal-weight portfolio breaks the risk budget: "
                         "the barrier method needs a strictly feasible start")
    done = torch.zeros(B, dtype=torch.bool, device=mu.device)
    t = 1.0
    eye = torch.eye(n, dtype=dt, device=mu.device)
    while True:
        centred = torch.zeros_like(done)
        for _ in range(max_newton):
            Fw = mv(F, w, precision)
            q = r * r - (Fw * Fw).sum(-1)
            FtFw = mv(Ft, Fw, precision)
            g = -t * mu - 1.0 / w + 2.0 * FtFw / q[:, None]
            # scaled by D = diag(w): Hs = D H D, gs = D g, and the budget
            # row 1'D dx = w'dx
            Dg = w * FtFw
            Hs = (eye + 2.0 * w[:, :, None] * FtF * w[:, None, :] / q[:, None, None]
                  + 4.0 * Dg[:, :, None] * Dg[:, None, :] / (q * q)[:, None, None])
            K = torch.zeros(B, n + 1, n + 1, dtype=dt, device=mu.device)
            K[:, :n, :n] = Hs
            K[:, :n, n] = w
            K[:, n, :n] = w
            # the budget row carries its residual, so rounding in the
            # steps never lets 1'w drift from 1
            rhs = torch.cat([-w * g, 1.0 - w.sum(-1, keepdim=True)], dim=1)
            sol, info = torch.linalg.solve_ex(K, rhs)
            dx = sol[:, :n]
            dec = (dx * mv(Hs, dx, precision)).sum(-1).clamp(min=0).sqrt()
            centred = centred | (dec < newton_tol) | (info != 0)
            if bool(centred.all()):
                break
            step = torch.where(dec < 0.25, torch.ones_like(dec),
                               1.0 / (1.0 + dec))
            # the damped step stays inside the domain in exact
            # arithmetic; in a low precision, hold it there by a
            # fraction to the boundary and by halving
            step = torch.minimum(step, 0.9 / (-dx).amax(-1).clamp(min=1e-30))
            for _ in range(40):
                wn = w + (step[:, None] * w) * dx
                Fn = mv(F, wn, precision)
                out = (Fn * Fn).sum(-1) >= r * r
                if not bool(out.any()):
                    break
                step = torch.where(out, 0.5 * step, step)
            go = (~centred & torch.isfinite(dx).all(-1))[:, None]
            w = torch.where(go, wn, w)
        if (n + 1) / t < gap_target:
            done = centred
            break
        t *= 10.0
    Fw = mv(F, w, precision)
    q = r * r - (Fw * Fw).sum(-1)
    lam = 1.0 / (t * w)
    nu = 1.0 / (t * q)
    gamma = (mu + lam - 2.0 * nu[:, None] * mv(Ft, Fw, precision)).mean(-1)
    # the active set read off the barrier point; where its polish is not
    # optimal, the asset nearest to the boundary between held and not
    # held is flipped, then the risk budget's state
    S = w > lam
    R = nu > q
    near = (w.log() - lam.log()).abs().argmin(-1, keepdim=True)
    S_flip = S.clone()
    S_flip.scatter_(-1, near, ~S.gather(-1, near))
    polished = torch.zeros_like(done)
    out = (w, lam, nu, gamma)
    for s_try, r_try in ((S, R), (S_flip, R), (S, ~R)):
        cand = polish(mu, F, FtF, r, w, lam, nu, gamma, s_try, r_try,
                      precision)
        take = cand[4] & ~polished
        out = tuple(torch.where(take.view(-1, *([1] * (o.dim() - 1))), c, o)
                    for c, o in zip(cand[:4], out))
        polished = polished | cand[4]
    w, lam, nu, gamma = out
    return w, lam, nu, gamma, done | polished


def polish(mu, F, FtF, r, w, lam, nu, gamma, S, R, precision: str,
           steps: int = 8):
    """Newton's method on the KKT conditions with an active set held (S:
    the assets held, R: the risk budget binds); a lane's result is
    optimal where w >= 0, lam >= 0, nu >= 0 and ||F w|| <= r hold to the
    working precision's rounding. Returns (w, lam, nu, gamma, optimal),
    the result where optimal and the inputs elsewhere."""
    B, n = w.shape
    S = S.to(w.dtype)
    R = R.to(w.dtype)
    Ft = F.transpose(1, 2)
    wp, nup, gp = w * S, nu * R, gamma.clone()
    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    info = torch.zeros(B, dtype=torch.int32, device=w.device)
    for _ in range(steps):
        Fw = mv(F, wp, precision)
        FtFw = mv(Ft.contiguous(), Fw, precision)
        stat = -mu + 2.0 * nup[:, None] * FtFw + gp[:, None]
        res = torch.cat([
            S * stat + (1.0 - S) * wp,
            (R * ((Fw * Fw).sum(-1) - r * r) + (1.0 - R) * nup)[:, None],
            (wp.sum(-1) - 1.0)[:, None]], dim=1)
        J = w.new_zeros(B, n + 2, n + 2)
        J[:, :n, :n] = (S[:, :, None] * 2.0 * nup[:, None, None] * FtF
                        + torch.diag_embed(1.0 - S))
        J[:, :n, n] = S * 2.0 * FtFw
        J[:, :n, n + 1] = S
        J[:, n, :n] = R[:, None] * 2.0 * FtFw
        J[:, n, n] = 1.0 - R
        J[:, n + 1, :n] = 1.0
        d, info = torch.linalg.solve_ex(J, -res)
        wp = wp + d[:, :n]
        nup = nup + d[:, n]
        gp = gp + d[:, n + 1]
    Fw = mv(F, wp, precision)
    lp = (1.0 - S) * (-mu + 2.0 * nup[:, None] * mv(Ft.contiguous(), Fw,
                                                     precision)
                      + gp[:, None])
    eps = 100.0 * torch.finfo(w.dtype).eps
    ok = ((info == 0) & (wp >= -eps).all(-1) & (lp >= -eps).all(-1)
          & (nup >= -eps) & ((Fw * Fw).sum(-1) <= r * r + eps)
          & torch.isfinite(wp).all(-1))
    keep = ok[:, None]
    return (torch.where(keep, wp.clamp(min=0), w),
            torch.where(keep, lp.clamp(min=0), lam),
            torch.where(ok, nup.clamp(min=0), nu),
            torch.where(ok, gp, gamma), ok)


def vjp(mu, F, r: float, w, lam, nu, gamma, wbar,
        precision: str = "float64"):
    """(dmu, dF): the gradient of <wbar, w*(mu, F)> at the solution that
    solve() returned."""
    dt = dtype_of(precision)
    mu, F, w, lam, nu, wbar = (t.detach().to(dt)
                               for t in (mu, F, w, lam, nu, wbar))
    B, n = w.shape
    Ft = F.transpose(1, 2).contiguous()
    Fw = mv(F, w, precision)
    FtFw = mv(Ft, Fw, precision)
    # an asset (or the budget) with both its multiplier and its slack at
    # exactly 0, as a polished lane's degenerate row has, is taken as
    # inactive
    tiny = torch.finfo(dt).tiny
    g = ((Fw * Fw).sum(-1) - r * r).clamp(max=-tiny)
    N = 2 * n + 2
    K = w.new_zeros(B, N, N)
    K[:, :n, :n] = 2.0 * nu[:, None, None] * mm(Ft, F, precision)
    K[:, :n, n:2 * n] = -torch.eye(n, dtype=dt, device=w.device)
    K[:, :n, 2 * n] = 2.0 * FtFw
    K[:, :n, 2 * n + 1] = 1.0
    K[:, n:2 * n, :n] = torch.diag_embed(lam)
    K[:, n:2 * n, n:2 * n] = torch.diag_embed(w.clamp(min=tiny))
    K[:, 2 * n, :n] = 2.0 * nu[:, None] * FtFw
    K[:, 2 * n, 2 * n] = g
    K[:, 2 * n + 1, :n] = 1.0
    rhs = torch.cat([wbar, w.new_zeros(B, n + 2)], dim=1)
    u = torch.linalg.solve(K.transpose(1, 2), rhs)
    u1, u3 = u[:, :n], u[:, 2 * n]
    Fu1 = mv(F, u1, precision)
    dF = -2.0 * nu[:, None, None] * (
        Fw[:, :, None] * u1[:, None, :] + Fu1[:, :, None] * w[:, None, :]
        + u3[:, None, None] * Fw[:, :, None] * w[:, None, :])
    return u1, dF


def solve_and_grad(params, out_bars, config, precision="float64"):
    """The harness's entry: ([w], [dmu, dF] or None, converged) for the
    lanes of `params` = [mu, F]; `out_bars` = [wbar] or None."""
    mu, F = params
    r = float(config["risk_budget"])
    w, lam, nu, gamma, ok = solve(mu, F, r, precision)
    grads = None
    if out_bars is not None:
        grads = list(vjp(mu, F, r, w, lam, nu, gamma, out_bars[0],
                         precision))
    return [w], grads, ok
