"""Run one cell of the benchmark of `mpbp_tpu_torch` on the cards of this
machine and print its result as the last line of standard output.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run: set-up (imports, the card, the kernels from the build directory
inside the checkout, the cell's operator, preconditioner and graph where
its mix builds them once, and one warm-up step of the cell's own shapes);
then a closed loop of solves for `--seconds` seconds, closed at the end
of the cycle of the mix's loads in progress then; then, with `--trace
1`, a few more steps under the profiler and the per-layer readings; then
the check of the window's answers against the plain reference, once the
program's state is freed. `--trace 0` reports the cell's end-to-end
metrics, `--trace 1` its per-layer ones (`BENCHMARK.json`).

Without a CUDA card (or with fewer than the cell asks for), and if JAX or
the JAX package has been loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

T_TORCH = time.perf_counter()

from perfbench.harness import spec, traffic as mixes, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mpbp_tpu")
CHECK_MAX = 8          # the most answers of a window the check reads


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass(eq=False)
class Context:
    """What the metric readers read (`metrics/<name>.py`)."""

    cell: spec.Cell
    device: torch.device
    seed: int
    traffic: mixes.Traffic
    setup_s: float = 0.0
    setup_marks: dict = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    inputs_s: list = dataclasses.field(default_factory=list)
    solves: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    window_spans: list = dataclasses.field(default_factory=list)
    trace: dict | None = None
    solver: object = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step(ctx: Context, system, solver, theta: dict | None,
          b: torch.Tensor, spans):
    """One step of the mix on its inputs: the step's operator, PC and graph
    where the mix moves theta_n, then its solve. Returns (solver, result);
    the caller has dropped its own reference to the last step's solver."""
    if ctx.traffic.moving:
        solver = system.build(ctx.cell.config, theta, ctx.device, spans)
    res = system.solve(ctx.cell.config, solver, b, spans)
    return solver, res


def inputs(mix: mixes.Traffic, step: int,
           params: dict) -> tuple[dict | None, torch.Tensor]:
    """Step `step`'s inputs from the mix: theta_n's planes where the mix
    moves it (else None) and the right-hand side (`params`: the
    operator's scalars)."""
    return (mix.theta(step) if mix.moving else None, mix.rhs(step, params))


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float) -> tuple[dict, dict]:
    """The run of one cell on `device`: (its result line, the context the
    readers read)."""
    from perfbench.harness import check, system

    marks = {"program": time.perf_counter()}
    cfg, prm = cell.config, cell.params
    p = system.params(cfg)
    mix = mixes.Traffic(cell.traffic, int(cfg["n"]), device, seed)
    ctx = Context(cell, device, seed, mix)
    spans = trace.Spans(traced, device)

    solver = None
    if not mix.moving:
        solver = system.build(cfg, mix.theta(0), device, spans)
        _sync(device)
        marks["build"] = time.perf_counter()
    solver, res = _step(ctx, system, solver, *inputs(mix, 0, p), spans)
    del res                                                # the warm-up
    if mix.moving:
        solver = None
    gc.collect()
    gc.freeze()        # what set-up made stays out of every later collection
    _sync(device)
    ctx.setup_s = time.perf_counter() - t_start
    marks["warm-up"] = t_start + ctx.setup_s
    ctx.setup_marks = marks

    # The window: each step's inputs are made first, outside its timed
    # interval; a solve's seconds run from the start of its step (the
    # last step's objects released, where the mix rebuilds) to its synced
    # end, and the window's seconds are the sum of its solves'.
    spans.records.clear()
    samples, share = {}, float(prm["check_share"])
    cycle = int(cell.traffic["loads"])
    step, t0 = 1, time.perf_counter()
    while True:
        g0 = time.perf_counter()
        theta, b = inputs(mix, step, p)
        _sync(device)
        s0 = time.perf_counter()
        ctx.inputs_s.append(s0 - g0)
        if mix.moving:
            solver = None            # the last step's objects go first
            gc.collect()
        solver, res = _step(ctx, system, solver, theta, b, spans)
        _sync(device)
        s1 = time.perf_counter()
        del theta, b
        ctx.solves.append(dict(step=step, seconds=s1 - s0, iters=res.iters,
                               converged=bool(res.converged)))
        if len(samples) < CHECK_MAX and mix.sampled(step, share):
            samples[step] = res.x.cpu()
        del res
        step += 1
        if s1 - t0 >= seconds and (step - 1) % cycle == 0:
            break                    # at the end of a cycle of the loads
    ctx.window_s = sum(r["seconds"] for r in ctx.solves)
    ctx.peak_bytes = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
    ctx.window_spans = list(spans.records)

    if traced:
        # the traced steps' inputs are made before the profiler starts
        steps = range(step, step + int(prm["trace_steps"]))
        made = [inputs(mix, s, p) for s in steps]

        def traced_steps():
            nonlocal solver
            while made:
                theta, b = made.pop(0)
                if mix.moving:
                    solver = None
                    gc.collect()
                solver, res = _step(ctx, system, solver, theta, b, spans)
                del theta, b, res
        ctx.trace = trace.profile(traced_steps, device)
    ctx.solver = solver
    metrics = cell.per_layer if traced else cell.end_to_end
    values = {}
    for m in metrics:
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    ctx.solver = solver = None
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with spans.span("reference"):
        checks, failed = check.check(ctx, samples)
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and bool(samples)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(ctx.peak_bytes)}
    out = {"correct": bool(correct), "attempted": len(ctx.solves),
           "failed": failed, "metrics": values, "device": dev}
    if ctx.trace is not None:
        dev.update(busy_s=ctx.trace["busy_s"], window_s=ctx.trace["window_s"])
        out["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                            "idle_gaps": ctx.trace["idle_gaps"]}
    out["checks"] = checks
    return out, ctx


def host_lines(ctx: Context) -> None:
    """The card, its power limit and the host's cost of a launch, each on
    a line of its own (host speed moves every time here)."""
    dev = ctx.device
    print(f"device: {torch.cuda.get_device_name(dev)} "
          f"count={torch.cuda.device_count()}", flush=True)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"not read ({e})"
    print(f"power.limit: {smi}", flush=True)
    t = torch.zeros(1, device=dev)
    for _ in range(100):
        t.add_(1)
    torch.cuda.synchronize(dev)
    calls, c0 = 2000, time.perf_counter()
    for _ in range(calls):
        t.add_(1)
    us = (time.perf_counter() - c0) / calls * 1e6
    torch.cuda.synchronize(dev)
    print(f"host_us_per_launch: {us}", flush=True)
    s = ctx.solves
    print(f"window: {len(s)} solves, {ctx.window_s} s in all; iterations "
          f"{[r['iters'] for r in s]}; seconds "
          f"{[round(r['seconds'], 4) for r in s]}; setup_s "
          f"{ctx.setup_s}", flush=True)
    print(f"inputs_s (the mix's theta_n and b a step, made outside the "
          f"solves' seconds): mean {sum(ctx.inputs_s) / len(ctx.inputs_s)}, "
          f"max {max(ctx.inputs_s)}", flush=True)
    by = {}
    for name, a, b in ctx.window_spans:
        by.setdefault(name, []).append(round(b - a, 4))
    for name, secs in by.items():
        print(f"span {name}: {secs}", flush=True)
    if ctx.trace is not None:
        print(f"trace: {ctx.trace['kernels']} device activities, idle by "
              f"span {json.dumps(ctx.trace['idle_by_span'])}", flush=True)


def _libraries() -> set[str]:
    """The program's built kernel libraries in its build directory inside
    the checkout (`mpbp_tpu_torch/_build/`)."""
    return {p.name for p in (spec.ROOT / "mpbp_tpu_torch" / "_build").glob(
        "*.so")}


def forbidden_modules() -> list[str]:
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
            f"this machine has {n}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
    t_cuda = time.perf_counter()
    libraries = _libraries()
    out, ctx = run(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    # a run that built kernels (the first of a checkout) has their nvcc
    # builds in its setup_s: say so, so that it is read apart
    built = sorted(_libraries() - libraries)
    checks = out.pop("checks")
    out.update(kernels_built=built, checks=checks)        # checks stay last
    marks = dict(torch=T_TORCH, cuda=t_cuda, **ctx.setup_marks)
    last, phases = T_START, []
    for name, t in marks.items():
        phases.append(f"{name} {t - last:.4f}")
        last = t
    print("setup phases (s): " + ", ".join(phases), flush=True)
    print(f"kernel libraries built by this run: {built or 'none'}",
          flush=True)
    host_lines(ctx)
    found = forbidden_modules()
    if found:
        log(f"perfbench: the process loaded {', '.join(found)}; no result")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
