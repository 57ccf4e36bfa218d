"""What decides `correct`: the program's answers held against the plain
reference of the cell's configuration.

After the window closes, the reference solves again, in float64 on the
same device, every lane of the steps the run kept (a sample of steps
drawn from the seed), from the same parameter tensors, and
differentiates them itself with the same cotangents. Lanes the program
reports as not SOLVED are failures, counted in `failed`, and not
compared: their answers say they are not answers. A lane that the
reference cannot certify to its own float64 tolerance is not judged
either: whether the reference converges depends on the instance alone,
never on the program's answer. How many such lanes there were is
reported beside the numbers (`ref_unsolved`, and `ref_unsolved_share`
of the SOLVED lanes offered), not compared. The numbers below are
compared, each against its limit in `cells/<cell>.json` (a cell holds
only those that separate its program from its control):

- `kkt_max`: over every compared lane, the worst of the answer's
  suboptimality and its constraint violations, measured in float64 by
  the configuration's `optimality` (see the configuration's module).
  This is well posed on every lane, also where the optimum moves far
  for a small change of the data (two assets of nearly equal return),
  so it may be a maximum: an answer altered, left out or returned
  unsolved shows here.
- `out_max`: the largest gap between an output and the reference's, over
  every compared lane; where the optimum is unique and moves smoothly
  with the data (the box QP's strictly convex objective).
- `out_median`: the median over lanes of that gap.
- `grad_median`: the median over lanes of the largest gap between a
  parameter's gradient and the reference's, over that lane's largest
  reference gradient of the parameter (or 1e-3 of the lane's largest
  gradient of any parameter, where that is larger: a parameter the
  solution does not move with has no scale of its own).

The medians show the precision the program computes in; on a lane
whose optimum is ill-conditioned (the portfolio's flat lanes) both sides
may differ by far more, so there the worst lane's output says nothing of
the program, and `kkt_max` stands in for it.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

def _finite_or_inf(x: torch.Tensor) -> torch.Tensor:
    """A gap that is not a number is no answer: it reads as infinite."""
    return torch.nan_to_num(x, nan=math.inf)


def lane_out_gap(outs: List[torch.Tensor], refs: List[torch.Tensor]):
    """Per lane, the largest |out - ref| over every output."""
    return _finite_or_inf(torch.stack(
        [(o.double() - r.double()).abs().flatten(1).amax(-1)
         for o, r in zip(outs, refs)]).amax(0))


def lane_grad_gap(grads: List[torch.Tensor], refs: List[torch.Tensor]):
    """Per lane, the largest gradient gap over the parameters, each over
    the largest of: the lane's largest reference gradient of that
    parameter, 1e-3 of the lane's largest of any parameter, and 1e-3 of
    the median lane's largest (a lane whose optimum does not move with
    the data, as a portfolio on one asset, has no scale of its own)."""
    scales = [r.double().abs().flatten(1).amax(-1) for r in refs]
    top = torch.stack(scales).amax(0)
    floor = 1e-3 * torch.maximum(top, top.median())
    gaps = []
    for g, r, s in zip(grads, refs, scales):
        den = torch.maximum(s, floor).clamp(min=1e-300)
        gaps.append((g.double() - r.double()).abs().flatten(1).amax(-1) / den)
    return _finite_or_inf(torch.stack(gaps).amax(0))


class Judge:
    """Collects the per-lane numbers of every kept step, then reads the
    cell's numbers against its limits."""

    def __init__(self, cell, block: int = 256):
        self.cell = cell
        self.ref = cell.reference_module()
        self.cfg_mod = cell.config_module()
        self.block = block
        self.kkt: List[torch.Tensor] = []
        self.out: List[torch.Tensor] = []
        self.grad: List[torch.Tensor] = []
        self.parts: Dict[str, List[torch.Tensor]] = {}
        self.ref_ok: List[torch.Tensor] = []
        self.lanes = 0
        self.ref_unsolved = 0

    def add(self, params, outs, status, grads=None, out_bars=None):
        """One kept step: its parameters, the program's outputs, statuses
        and (for a training step) the gradients of sum(out_bars * outs).
        Judged in blocks of lanes, so the reference fits beside nothing
        else."""
        B = status.shape[0]
        for lo in range(0, B, self.block):
            sl = slice(lo, min(B, lo + self.block))
            solved = (status[sl] == 0)
            if not bool(solved.any()):
                continue
            idx = torch.nonzero(solved).flatten() + lo
            p = [t.detach()[idx] for t in params]
            o = [t.detach()[idx] for t in outs]
            bars = None if out_bars is None else [b[idx] for b in out_bars]
            r_outs, r_grads, ok = self.ref.solve_and_grad(
                p, bars, self.cell.config, "float64")
            self.ref_unsolved += int((~ok).sum())
            self.ref_ok.append(ok)
            # a lane the reference could not certify is not judged
            keep = torch.nonzero(ok).flatten()
            p, o = [t[keep] for t in p], [t[keep] for t in o]
            r_outs = [t[keep] for t in r_outs]
            if r_grads is not None:
                r_grads = [t[keep] for t in r_grads]
            idx = idx[keep.to(idx.device)]
            if not idx.numel():
                continue
            parts = self.cfg_mod.optimality(self.cell.config, p, o, r_outs)
            for k, v in parts.items():
                self.parts.setdefault(k, []).append(v)
            self.kkt.append(_finite_or_inf(
                torch.stack(list(parts.values())).amax(0)))
            self.out.append(lane_out_gap(o, r_outs))
            if grads is not None:
                self.grad.append(lane_grad_gap([g[idx] for g in grads],
                                               r_grads))
            self.lanes += int(idx.numel())

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The per-lane readings, for a study of their spread."""
        pieces = [("kkt", self.kkt), ("out", self.out), ("grad", self.grad),
                  ("ref_ok", self.ref_ok)]
        pieces += [("kkt." + k, v) for k, v in self.parts.items()]
        return {k: torch.cat(v).cpu() for k, v in pieces if v}

    def numbers(self) -> Dict[str, Optional[float]]:
        def cat(xs):
            return torch.cat(xs).cpu().tolist() if xs else []
        kkt, out, grad = cat(self.kkt), cat(self.out), cat(self.grad)
        nums = {
            "kkt_max": max(kkt) if kkt else None,
            "out_max": max(out) if out else None,
            "out_median": statistics.median(out) if out else None,
            "grad_median": statistics.median(grad) if grad else None,
        }
        nums = {k: v for k, v in nums.items() if v is not None}
        offered = self.lanes + self.ref_unsolved
        nums["ref_unsolved"] = self.ref_unsolved
        nums["ref_unsolved_share"] = (self.ref_unsolved / offered
                                      if offered else 0.0)
        return nums

    def verdict(self, limits: Dict[str, float]):
        """(correct, checks): every number named in `limits` is present,
        finite and at most its limit, and `no_lanes` (1 where no lane was
        compared) is 0."""
        nums = dict(self.numbers(), no_lanes=int(self.lanes == 0))
        limits = dict(limits, no_lanes=0)
        checks = {}
        ok = True
        for name, limit in limits.items():
            value = nums.get(name)
            checks[name] = {"value": value, "limit": limit}
            if value is None or not math.isfinite(value) or value > limit:
                ok = False
        return ok, checks
