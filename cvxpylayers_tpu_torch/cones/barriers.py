"""Logarithmically-homogeneous self-concordant barriers for the
nonsymmetric cones (Exp, Pow3), used by the interior-point solver.

Counterpart of cvxpylayers_tpu/cones/barriers.py: the standard nu=3
barriers

  exp cone  K = cl{(x, y, z): y > 0, y e^{x/y} <= z}
            f(x,y,z) = -log(y log(z/y) - x) - log y - log z

  pow cone  K = {(x, y, z): x^a y^(1-a) >= |z|, x, y >= 0}
            f(x,y,z) = -log(x^{2a} y^{2(1-a)} - z^2)
                       - (1-a) log x - a log y           (Chares 2009)

with their gradients and Hessians in closed form (the reference takes
them by autodiff of the barrier value; the formulas below are the same
derivatives, term by term). Every function takes a stack of triples
s (..., 3) and returns (...), (..., 3) or (..., 3, 3); a power cone's
`alpha` is a number or a tensor that broadcasts against s[..., 0].

Both barriers satisfy the log-homogeneity identities H(s) s = -g(s) and
s' g(s) = -nu used by the IPM (solver/ipm.py).
"""

from __future__ import annotations

import torch


def _sym3(h00, h01, h02, h11, h12, h22):
    """Stack the six distinct entries of symmetric 3x3 blocks."""
    return torch.stack([
        torch.stack([h00, h01, h02], dim=-1),
        torch.stack([h01, h11, h12], dim=-1),
        torch.stack([h02, h12, h22], dim=-1),
    ], dim=-2)


def exp_barrier(s: torch.Tensor) -> torch.Tensor:
    """Barrier value at interior points of the exp cone, (..., 3)."""
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    psi = y * torch.log(z / y) - x
    return -torch.log(psi) - torch.log(y) - torch.log(z)


def _exp_parts(s):
    """psi = y log(z/y) - x and its gradient d = (-1, log(z/y) - 1, y/z)."""
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    ell = torch.log(z / y)
    psi = y * ell - x
    return x, y, z, psi, (-torch.ones_like(x), ell - 1.0, y / z)


def exp_grad(s: torch.Tensor) -> torch.Tensor:
    """Gradient of exp_barrier: -d/psi - (0, 1/y, 1/z)."""
    _, y, z, psi, (dx, dy, dz) = _exp_parts(s)
    return torch.stack([-dx / psi, -dy / psi - 1.0 / y, -dz / psi - 1.0 / z],
                       dim=-1)


def exp_hess(s: torch.Tensor) -> torch.Tensor:
    """Hessian of exp_barrier: d d'/psi^2 - (Hessian of psi)/psi
    + diag(0, 1/y^2, 1/z^2), where psi's Hessian has yy = -1/y,
    yz = 1/z, zz = -y/z^2 and no x entries."""
    _, y, z, psi, (dx, dy, dz) = _exp_parts(s)
    p2 = psi * psi
    return _sym3(
        dx * dx / p2,
        dx * dy / p2,
        dx * dz / p2,
        dy * dy / p2 + (1.0 / y) / psi + 1.0 / (y * y),
        dy * dz / p2 - (1.0 / z) / psi,
        dz * dz / p2 + (y / (z * z)) / psi + 1.0 / (z * z),
    )


def _pow_parts(s, alpha):
    """u = x^{2a} y^{2(1-a)} - z^2, phi = x^{2a} y^{2(1-a)}, and u's
    gradient (2a phi/x, 2(1-a) phi/y, -2z)."""
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    phi = torch.exp(2.0 * alpha * torch.log(x)
                    + 2.0 * (1.0 - alpha) * torch.log(y))
    u = phi - z * z
    grad = (2.0 * alpha * phi / x, 2.0 * (1.0 - alpha) * phi / y, -2.0 * z)
    return x, y, z, phi, u, grad


def pow_barrier(s: torch.Tensor, alpha) -> torch.Tensor:
    """Barrier value at interior points of the power cone, (..., 3)."""
    x, y, _, _, u, _ = _pow_parts(s, alpha)
    return (-torch.log(u) - (1.0 - alpha) * torch.log(x)
            - alpha * torch.log(y))


def pow_grad(s: torch.Tensor, alpha) -> torch.Tensor:
    """Gradient of pow_barrier: -grad(u)/u - ((1-a)/x, a/y, 0)."""
    x, y, _, _, u, (ux, uy, uz) = _pow_parts(s, alpha)
    return torch.stack([-ux / u - (1.0 - alpha) / x, -uy / u - alpha / y,
                        -uz / u], dim=-1)


def pow_hess(s: torch.Tensor, alpha) -> torch.Tensor:
    """Hessian of pow_barrier: grad(u) grad(u)'/u^2 - (Hessian of u)/u
    + diag((1-a)/x^2, a/y^2, 0), where u's Hessian has
    xx = 2a(2a-1) phi/x^2, xy = 4a(1-a) phi/(xy),
    yy = 2(1-a)(1-2a) phi/y^2, zz = -2."""
    x, y, _, phi, u, (ux, uy, uz) = _pow_parts(s, alpha)
    u2 = u * u
    b = 1.0 - alpha
    uxx = 2.0 * alpha * (2.0 * alpha - 1.0) * phi / (x * x)
    uxy = 4.0 * alpha * b * phi / (x * y)
    uyy = 2.0 * b * (1.0 - 2.0 * alpha) * phi / (y * y)
    return _sym3(
        ux * ux / u2 - uxx / u + b / (x * x),
        ux * uy / u2 - uxy / u,
        ux * uz / u2,
        uy * uy / u2 - uyy / u + alpha / (y * y),
        uy * uz / u2,
        uz * uz / u2 + 2.0 / u,
    )


# Interior points used to (re)initialize nonsymmetric blocks. For the exp
# cone the primal and dual cones differ; both points sit safely inside.
EXP_PRIMAL_INTERIOR = (-1.051383, 0.556409, 1.258967)   # Skajaa-Ye init
EXP_DUAL_INTERIOR = (-1.0, 0.0, 2.0)    # -u e^{v/u} = 1 < e*w = 2e
POW_INTERIOR = (1.0, 1.0, 0.0)          # interior of K and K* alike
