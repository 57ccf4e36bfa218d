"""`optnet_box_qp`: OptNet's box-constrained QP projection layer,

    y* = argmin ||y - v||^2  s.t.  G y <= h,  0 <= y <= 1,

with v, G and h parameters, at the sizes and settings of
configs/optnet_box_qp.json. Built through the program's public DSL.
"""

from __future__ import annotations

import torch


def build_layer(cfg: dict, device):
    """The layer, canonicalised once."""
    import cvxpylayers_tpu_torch as ct

    n, m = cfg["n"], cfg["m_ineq"]
    y = ct.Variable(n)
    v = ct.Parameter(n)
    G = ct.Parameter((m, n))
    h = ct.Parameter(m)
    prob = ct.Problem(ct.Minimize(ct.sum_squares(y - v)),
                      [G @ y <= h, y >= 0, y <= 1])
    return ct.CvxpyLayer(prob, parameters=[v, G, h], variables=[y],
                         device=device)


def instances(cfg: dict, gen: torch.Generator, rows: int, device):
    """[v, G, h] for `rows` instances, drawn from `gen` in three calls:
    v ~ N(0, 1), G ~ 0.3 N(0, 1), h = |N(0, 1)| + 1."""
    n, m = cfg["n"], cfg["m_ineq"]
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    v = torch.randn(rows, n, **kw)
    G = 0.3 * torch.randn(rows, m, n, **kw)
    h = torch.randn(rows, m, **kw).abs() + 1.0
    return [v, G, h]


def output_shapes(cfg: dict, rows: int):
    return [(rows, cfg["n"])]


def optimality(cfg: dict, params, outs, ref_outs) -> dict:
    """Per lane, in float64: the relative suboptimality
    |f(y) - f(y*)| / (1 + f(y*)) of f(y) = ||y - v||^2, and the largest
    violations of G y <= h and of 0 <= y <= 1."""
    v, G, h = (p.double() for p in params)
    y, ys = outs[0].double(), ref_outs[0].double()
    f = ((y - v) ** 2).sum(-1)
    fs = ((ys - v) ** 2).sum(-1)
    Gy = torch.matmul(G, y.unsqueeze(-1)).squeeze(-1)
    return {"sub": (f - fs).abs() / (1.0 + fs),
            "ineq": (Gy - h).amax(-1).clamp(min=0),
            "box": torch.maximum(-y, y - 1.0).amax(-1).clamp(min=0)}
