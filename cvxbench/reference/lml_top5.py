"""Plain reference for `lml_top5`: the Limited Multi-Label projection

    y* = argmax_y  x'y + sum_i H(y_i) + sum_i H(1 - y_i)  s.t.  1'y = k,

H(u) = -u log u, and its gradient, in closed form.

The program canonicalises the layer into a cone program with two
exponential cones per coordinate and solves it by an interior-point
method. This file works from the optimality conditions instead: the
objective is separable and strictly concave, so with nu the multiplier
of 1'y = k every coordinate solves x_i - log(y_i / (1 - y_i)) + nu = 0,

    y_i = sigmoid(x_i + nu),   with nu fixed by  sum_i sigmoid(x_i + nu) = k.

The sum is increasing in nu, from 0 to n, so nu is bracketed by
logit(k/n) - max(x) and logit(k/n) - min(x), and bisected until the
bracket's midpoint is one of its ends: the working precision's last
bit. The gradient follows from the implicit function theorem: with
d = y (1 - y), dnu/dx = -d / 1'd, so for a cotangent ybar

    xbar = d * ybar - d (d'ybar) / (1'd).

Every sum over the coordinates is a product with a vector
(reference/numerics.py's `mv`), so the "tf32" control rounds what it
sums to TF32's 10 mantissa bits, as the other references' products are
rounded. Batched plain torch on whatever device the inputs live on;
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from cvxbench.reference.numerics import dtype_of, mv, tolerance


def _dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """Per lane a'b, (B, n) x (B, n) -> (B,), in the working precision."""
    return mv(a.unsqueeze(-2), b, precision).squeeze(-1)


def _sum(v: torch.Tensor, precision: str) -> torch.Tensor:
    """Per lane 1'v, in the working precision."""
    return _dot(v, torch.ones_like(v), precision)


def solve(x: torch.Tensor, k: float, precision: str = "float64",
          max_halvings: int = 2000):
    """(y, nu, converged) for every lane of logits x (B, n)."""
    dt = dtype_of(precision)
    x = x.detach().to(dt)
    n = x.shape[-1]
    if not 0 < k < n:
        raise ValueError(f"k must lie strictly between 0 and n={n}, got {k}")
    base = math.log(k / (n - k))
    lo = base - x.amax(-1)
    hi = base - x.amin(-1)
    for _ in range(max_halvings):
        mid = 0.5 * (lo + hi)
        if not bool(((mid != lo) & (mid != hi)).any()):
            break
        over = _sum(torch.sigmoid(x + mid[:, None]), precision) > k
        hi = torch.where(over, mid, hi)
        lo = torch.where(over, lo, mid)
    nu = 0.5 * (lo + hi)
    y = torch.sigmoid(x + nu[:, None])
    total = _sum(y, precision)
    converged = (torch.isfinite(y).all(-1)
                 & ((total - k).abs() <= tolerance(precision) * k))
    return y, nu, converged


def vjp(y: torch.Tensor, ybar: torch.Tensor, precision: str = "float64"):
    """xbar: the gradient of <ybar, y*(x)> at the solution y."""
    dt = dtype_of(precision)
    y, ybar = y.detach().to(dt), ybar.detach().to(dt)
    d = y * (1.0 - y)
    dy = _dot(d, ybar, precision)
    dd = _sum(d, precision).clamp(min=torch.finfo(dt).tiny)
    return d * ybar - d * (dy / dd)[:, None]


def solve_and_grad(params, out_bars, config, precision="float64"):
    """The harness's entry: ([y], [xbar] or None, converged) for the
    lanes of `params` = [x]; `out_bars` = [ybar] or None."""
    (x,) = params
    y, _, ok = solve(x, float(config["k"]), precision)
    grads = None
    if out_bars is not None:
        grads = [vjp(y, out_bars[0], precision)]
    return [y], grads, ok
