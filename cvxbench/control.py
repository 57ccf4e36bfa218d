"""Readings that a cell's correctness limits are set from, in one process.

    python3 -m cvxbench.control --workload <cell> --seconds <s>
        --program-seeds a,b,... --control-seeds c,d,...
        [--fault-seeds e,f,...] [--dump <file.pt>]

Runs the cell as `cvxbench.run` does (set-up, a short window at the
cell's own load, the judge): with the program on each program seed (the
lower readings); with the control on each control seed (upper
readings); and with each fault below planted in the program on each
fault seed (upper readings of the numbers a fault moves ten times or
more). The control is the plain reference computed in TF32 (every
product's factors rounded to TF32, reference/numerics.py) put in the
program's place, its answers and gradients judged by the same float64
reference. A control lane that the control does not certify to its own
tolerance is reported not SOLVED, as the program reports its own, so
the control's readings are those of answers it stands by, not of solves
that never converged. Prints one JSON line per run; `--dump` saves
every run's per-lane readings. Not part of a benchmark run; it needs the
card, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

CONTROL_PRECISION = "tf32"


def control_patch(precision: str = CONTROL_PRECISION):
    """A patch for run(): the workload's timed path replaced by the
    reference computed in `precision`."""

    def patch(wl):
        ref = wl.cell.reference_module()
        cfg = wl.cell.config

        def solve(params, out_bars):
            outs, grads, ok = ref.solve_and_grad(
                [p.detach() for p in params], out_bars, cfg, precision)
            for p, g in zip(params, grads):
                p.grad = g.to(p.dtype)
            status = (~ok).to(torch.int64)
            iters = torch.zeros_like(status)
            return [o.to(torch.float32) for o in outs], status, iters

        wl.solve = solve
    return patch


# Faults planted where the answer is produced (the layer's solve): each
# maps the batch's outputs to what the broken program would return.

def unchanged(x):
    """The solve returns its starting iterate (zeros) unchanged."""
    return x * 0.0


def half_mean(x):
    """Half of the batch left out, given the mean of the rest."""
    h = x.shape[0] // 2
    rest = x[:h].mean(0, keepdim=True).expand(x.shape[0] - h, *x.shape[1:])
    return torch.cat([x[:h], rest])


def altered(x):
    """The answers of lanes 0 and 1 handed to each other."""
    order = torch.arange(x.shape[0], device=x.device)
    order[0], order[1] = 1, 0
    return x[order]


FAULTS = {"unchanged": unchanged, "half_mean": half_mean,
          "altered": altered}


def fault_patch(alter):
    """A patch for run(): the layer's solve with its outputs passed
    through `alter`; statuses, gradients' path and all else as is."""

    def patch(wl):
        inner = wl.layer._solve

        def broken(params, solver_args, warm_start):
            outs, ws, status, iters = inner(params, solver_args, warm_start)
            return tuple(alter(o) for o in outs), ws, status, iters

        wl.layer._solve = broken
    return patch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cvxbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    from cvxbench.run import SetupClock, run
    from cvxbench.spec import load_cell

    if not torch.cuda.is_available():
        print("cvxbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    plan = [("program", None, args.program_seeds),
            ("control", control_patch(), args.control_seeds)]
    plan += [("fault." + name, fault_patch(alter), args.fault_seeds)
             for name, alter in FAULTS.items()]
    dumps = []
    for mode, patch, seeds in plan:
        for seed in [int(s) for s in seeds.split(",") if s]:
            fields, _, judge = run(cell, seed, args.seconds, False, "cuda",
                                   SetupClock(), patch)
            print(json.dumps({"mode": mode, "seed": seed,
                              "correct": fields["correct"],
                              "steps": fields["steps"],
                              "attempted": fields["attempted"],
                              "failed": fields["failed"],
                              "numbers": fields["numbers"],
                              "metrics": fields["metrics"]}), flush=True)
            dumps.append({"mode": mode, "seed": seed, **judge.arrays()})
    if args.dump:
        torch.save(dumps, args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
