"""Traffic kind `train`: a closed loop of training steps through one layer.

Each step draws a fresh batch of the configuration's `batch` instances
and its cotangents out_bars on the device, from one generator seeded by
`--seed` (so the sequence of instances is fixed by the seed, and no two
steps see the same values or tensors), then starts its clock, calls the
layer's forward entry, and backpropagates sum(out_bars * outs) to the
parameters. The draw is a few calls on the card, outside the step's
own time but inside the window. The forward entry is
`layer.solve_with_info` (it never raises on a lane that did not
converge), or `solve_with_rescue` where the mix has `rescue`. The step
ends in `torch.cuda.synchronize()`.

Mix keys: `solver_args` (over the configuration's), `rescue`
({"capacity": c}), `warm_steps`, `kept_steps`, `profile_steps`.
"""

from __future__ import annotations

import time

import torch

from cvxbench.trace import span


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageLog:
    """Records the fast stage's statuses of every solve_with_rescue call
    (after chip_smoke.py's StageLog: it wraps the layer instance's
    solve_and_state, which solve_with_rescue calls first). Reads only."""

    def __init__(self, layer):
        self.fast = []
        inner = layer.solve_and_state

        def fast(*a, **kw):
            out = inner(*a, **kw)
            self.fast.append(out[-2].detach())
            return out

        layer.solve_and_state = fast


class Workload:
    """The set-up and the steps of one `train` cell."""

    def __init__(self, cell, seed: int, device, clock):
        cfg, mix = cell.config, cell.mix
        self.cell, self.device = cell, device
        self.cm = cell.config_module()
        self.layer = self.cm.build_layer(cfg, device)
        clock.mark("canonicalise")
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.args = dict(cfg["solver_args"], **mix.get("solver_args", {}))
        self.rescue = mix.get("rescue")
        self.stage_log = StageLog(self.layer) if self.rescue else None
        self.solve = self.program
        self.spans = {"fwd": [], "bwd": []}
        self.iters = []

    def program(self, params, out_bars):
        """The timed path: (outs, status, iters), gradients in .grad."""
        if self.rescue:
            from cvxpylayers_tpu_torch import solve_with_rescue

            outs, status, iters = solve_with_rescue(
                self.layer, *params, solver_args=self.args,
                rescue_args=self.cell.config["rescue_args"],
                capacity=self.rescue["capacity"])
        else:
            outs, status, iters = self.layer.solve_with_info(
                *params, solver_args=self.args)
        self.mark_fwd()
        with span("bwd", self.tracing):
            loss = sum((o * w).sum() for o, w in zip(outs, out_bars))
            loss.backward()
        return outs, status, iters

    def mark_fwd(self):
        if self.timing:
            sync(self.device)
            self._t_fwd = time.perf_counter()

    tracing = False   # inside the profiled steps: host spans
    timing = False    # the traced run's unprofiled steps: synchronised spans

    def draw(self):
        """The next batch's parameters (leaves that take gradients) and
        cotangents."""
        cfg, B = self.cell.config, self.cell.config["batch"]
        params = [t.requires_grad_()
                  for t in self.cm.instances(cfg, self.gen, B, self.device)]
        out_bars = [torch.randn(shape, generator=self.gen,
                                device=self.device)
                    for shape in self.cm.output_shapes(cfg, B)]
        return params, out_bars

    def step(self, i: int) -> dict:
        params, out_bars = self.draw()
        t0 = time.perf_counter()
        with span("fwd", self.tracing):
            outs, status, iters = self.solve(params, out_bars)
        sync(self.device)
        t1 = time.perf_counter()
        if self.timing:
            self.spans["fwd"].append(self._t_fwd - t0)
            self.spans["bwd"].append(t1 - self._t_fwd)
            self.iters.append(iters.detach())
        return {"params": params, "out_bars": out_bars, "outs": outs,
                "status": status.detach(), "seconds": t1 - t0}

    def warm(self, steps: int):
        for i in range(steps):
            self.step(i)

    def snapshot(self, rec: dict) -> dict:
        """What the judge needs of a kept step, copied off the step."""
        params = rec["params"]
        return {"params": [p.detach() for p in params],
                "out_bars": rec["out_bars"],
                "outs": [o.detach().clone() for o in rec["outs"]],
                "status": rec["status"].clone(),
                "grads": [p.grad.detach().clone() for p in params]}

    def judge(self, judge, snap: dict):
        judge.add(snap["params"], snap["outs"], snap["status"],
                  snap["grads"], snap["out_bars"])

    def counters(self) -> dict:
        c = {"iters": self.iters}
        if self.stage_log is not None:
            cap = self.rescue["capacity"]
            c["rescue_lanes"] = [int((s != 0).sum().clamp(max=cap))
                                 for s in self.stage_log.fast]
        return c

    def close(self):
        self.layer = None
        self.stage_log = None
