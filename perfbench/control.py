"""The readings that the limits of `correct` are set from: the program's
answers over many seeds (the lower reading) and the control's (the upper),
each judged by the plain reference as a run judges its sampled answers.

    python3 -m perfbench.control --workload <cell> --first-seed <n> \
        [--seeds 12] [--steps 8] [--control-seeds 3]

For each seed it steps through `--steps` steps of the cell's mix by the
run's own path (`perfbench.run._step`) and reads the largest reference
relative residual and the program's own convergence flags. The control is
the same path with the configuration's precision one step lower: every
part of the solve in float32 (`precision: f32`), the program's own f32
path, where the configuration states a float64 outer solve. Prints one
JSON line a seed and a summary last. Needs a CUDA card; the benchmark's
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench import run
from perfbench.harness import spec, system, trace
from perfbench.harness import traffic as mixes
from perfbench.reference import multiphase as reference


def readings(cell: spec.Cell, seeds, steps: int, precision: str,
             device: torch.device, log=print) -> list[dict]:
    """One reading a seed: {seed, precision, relres_max, iters,
    unconverged}."""
    cfg = dict(cell.config, precision=precision)
    cell = spec.Cell(cell.name, cell.chips, cfg, cell.traffic, cell.params,
                     cell.end_to_end, cell.per_layer)
    p, n = system.params(cfg), int(cfg["n"])
    spans = trace.Spans(False, device)
    solver, out = None, []
    for seed in seeds:
        mix = mixes.Traffic(cell.traffic, n, device, seed)
        ctx = run.Context(cell, device, seed, mix)
        if solver is None and not mix.moving:
            solver = system.build(cfg, mix.theta(0), device, spans)
        worst, iters, unconverged = 0.0, [], 0
        for step in range(1, steps + 1):
            theta, b = run.inputs(mix, step, p)
            if mix.moving:
                solver = None
            solver, res = run._step(ctx, system, solver, theta, b, spans)
            del theta, b
            rel = reference.relative_residual(mix.theta(step), p,
                                              mix.rhs(step, p), res.x)
            worst = max(worst, rel if rel == rel else float("inf"))
            iters.append(res.iters)
            unconverged += not res.converged
            del res
        row = dict(seed=seed, precision=precision, relres_max=worst,
                   iters=iters, unconverged=unconverged)
        log(json.dumps(row))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    sound = readings(cell, seeds, args.steps, cell.config["precision"],
                     device)
    ctrl = readings(cell, seeds[:args.control_seeds], args.steps, "f32",
                    device)
    print(json.dumps({
        "workload": args.workload, "device": torch.cuda.get_device_name(0),
        "lower": max(r["relres_max"] for r in sound),
        "upper": min(r["relres_max"] for r in ctrl) if ctrl else None,
        "unconverged": sum(r["unconverged"] for r in sound)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
