"""`lml_top5`: the Limited Multi-Label projection layer (Amos, Koltun
and Kolter 2019) over a classifier's logits,

    y* = argmax_y  x'y + sum_i H(y_i) + sum_i H(1 - y_i)  s.t.  1'y = k,

H(u) = -u log u (so 0 <= y <= 1 is implied), with the logits x the
parameter, at the sizes and settings of configs/lml_top5.json. Built by
the program's model zoo (`models.zoo.lml`), so the cell runs the zoo's
layer.
"""

from __future__ import annotations

import torch


def build_layer(cfg: dict, device):
    """The layer, canonicalised once."""
    from cvxpylayers_tpu_torch.models import zoo

    return zoo.lml(cfg["n"], cfg["k"], device=device)


def instances(cfg: dict, gen: torch.Generator, rows: int, device):
    """[x] for `rows` instances, drawn from `gen` in one call:
    x ~ 2 N(0, 1)."""
    x = 2.0 * torch.randn(rows, cfg["n"], generator=gen, device=device,
                          dtype=torch.float32)
    return [x]


def output_shapes(cfg: dict, rows: int):
    return [(rows, cfg["n"])]


def _objective(x, y):
    """x'y + sum H(y) + sum H(1 - y), with y clamped into [0, 1] for the
    entropies (the bound violation is measured apart)."""
    u = y.clamp(0.0, 1.0)
    return ((x * y).sum(-1) - torch.special.xlogy(u, u).sum(-1)
            - torch.special.xlogy(1.0 - u, 1.0 - u).sum(-1))


def optimality(cfg: dict, params, outs, ref_outs) -> dict:
    """Per lane, in float64: the relative objective gap
    |f(y) - f(y*)| / (1 + |f(y*)|) against the reference's y*, the
    violation |1'y - k| of the equality, and the bound violation
    max(-y, y - 1)."""
    x = params[0].double()
    y, ys = outs[0].double(), ref_outs[0].double()
    f, fs = _objective(x, y), _objective(x, ys)
    return {"sub": (f - fs).abs() / (1.0 + fs.abs()),
            "sum": (y.sum(-1) - float(cfg["k"])).abs(),
            "bound": torch.maximum(-y, y - 1.0).amax(-1).clamp(min=0)}
