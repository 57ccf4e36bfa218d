"""`markowitz_socp`: a Markowitz portfolio layer with a risk budget,

    w* = argmax mu'w  s.t.  ||F w||_2 <= r,  1'w = 1,  w >= 0,

with mu and F parameters (a second-order cone), at the sizes and
settings of configs/markowitz_socp.json. Built through the program's
public DSL.
"""

from __future__ import annotations

import math

import torch


def build_layer(cfg: dict, device):
    """The layer, canonicalised once."""
    import cvxpylayers_tpu_torch as ct

    n, k = cfg["n"], cfg["k"]
    w = ct.Variable(n, nonneg=True)
    mu = ct.Parameter(n)
    F = ct.Parameter((k, n))
    prob = ct.Problem(ct.Maximize(mu @ w),
                      [ct.norm(F @ w, 2) <= cfg["risk_budget"],
                       ct.sum(w) == 1])
    return ct.CvxpyLayer(prob, parameters=[mu, F], variables=[w],
                         device=device)


def instances(cfg: dict, gen: torch.Generator, rows: int, device):
    """[mu, F] for `rows` instances, drawn from `gen` in two calls:
    mu ~ 0.1 N(0, 1), F ~ N(0, 1) / sqrt(n)."""
    n, k = cfg["n"], cfg["k"]
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    mu = 0.1 * torch.randn(rows, n, **kw)
    F = torch.randn(rows, k, n, **kw) / math.sqrt(n)
    return [mu, F]


def output_shapes(cfg: dict, rows: int):
    return [(rows, cfg["n"])]


def optimality(cfg: dict, params, outs, ref_outs) -> dict:
    """Per lane, in float64: the suboptimality |mu'w - mu'w*| / max|mu|,
    and the violations of w >= 0, of 1'w = 1 and of ||F w|| <= r."""
    mu, F = (p.double() for p in params)
    w, ws = outs[0].double(), ref_outs[0].double()
    r = float(cfg["risk_budget"])
    risk = torch.matmul(F, w.unsqueeze(-1)).squeeze(-1).norm(dim=-1)
    return {"sub": ((mu * w).sum(-1) - (mu * ws).sum(-1)).abs()
            / mu.abs().amax(-1),
            "sign": (-w).amax(-1).clamp(min=0),
            "budget": (w.sum(-1) - 1.0).abs(),
            "risk": (risk - r).clamp(min=0)}
