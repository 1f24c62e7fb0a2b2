"""The program's own trace in a traced run: where the device's idle time
falls among the port's spans (`mpbp_tpu_torch.utils.metrics`), the PC
replay's device time, and the program's counters, for the readers
`krylov.idle_ms_per_iter`, `pc.replay_ms`, `pc.inner_steps`,
`setup.capture_s` and `memory.device_mallocs`.

`read(ctx)` runs once a traced run (memoised on the context), after the
readers the benchmark lists before those: twice the cell's `trace_steps`
further steps with the program's tracing on, through `system.build` /
`system.solve` with the benchmark's own spans off (each of those syncs the
device at both ends). The first `trace_steps` run under torch.profiler
(CPU and CUDA), for the device's idle time; the others without it, for
every other reading, since the profiler's own host cost slows the host-
bound capture and its kernel tracing the replays. All the steps' inputs
are made before the first starts. Where the mix rebuilds every step, one
step runs first untraced, so that each traced step releases the last
step's objects as a step of the window does (the run keeps its own last
solver until its readers are done).

Each idle interval of the device in the profiler's window is split among
the innermost program spans the host was in during it, by overlap: the
host's span ranges and the device's activity share the profiler's clock.
(`trace.reduce` names a gap by where it began; for a blocking read that is
the read, `krylov.read_done`, and not the host work after it that kept the
device waiting.)

Prints one `program trace:` line. Returns None without a CUDA card, in an
untraced run, and where the program has no tracing (a commit before it).
"""

from __future__ import annotations

import bisect
import gc
import json
import statistics
import time

import torch

from perfbench.harness import trace

Stack = tuple[str, ...]          # open spans, outermost first


def segments(ranges: list[tuple[float, float, str]]) -> list[
        tuple[float, float, Stack]]:
    """The host's timeline cut where a range opens or closes: (start, end,
    the open ranges) for every piece inside some range, in order. The
    ranges come from one thread, so they nest; a child that outlasts its
    parent by the clock's rounding is cut at the parent's end."""
    out: list[tuple[float, float, Stack]] = []
    stack: list[tuple[float, str]] = []          # (end, name)
    t = 0.0

    def close_until(until: float) -> None:
        nonlocal t
        while stack and stack[-1][0] <= until:
            end = stack[-1][0]
            if end > t:
                out.append((t, end, tuple(n for _, n in stack)))
            t = end
            stack.pop()

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(a)
        if stack and a > t:
            out.append((t, a, tuple(n for _, n in stack)))
        t = a
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    close_until(float("inf"))
    return out


def split_idle(events, window: tuple[float, float],
               names: set[str]) -> tuple[float, dict[Stack, float]]:
    """(busy seconds, idle seconds by the stack of open program spans) of
    (is_device, name, start, end) events over `window`: the host ranges
    named in `names` make the stacks, every other device event is busy
    (the ranges' own marks on the device's timeline apart), and each idle
    interval is split among the stacks it overlaps; () is no span."""
    w0, w1 = window
    skip = names | set(trace.SPANS) | {trace.WINDOW}
    device, ranges = [], []
    for is_dev, name, a, b in events:
        if is_dev and name not in skip:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b))
        elif not is_dev and name in names:
            ranges.append((a, b, name))
    busy, merged = trace.union_seconds(device)
    pieces = segments(ranges)
    starts = [p[0] for p in pieces]
    idle: dict[Stack, float] = {}
    for g0, g1 in trace.gaps(merged, w0, w1):
        covered = 0.0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(pieces) and pieces[i][0] < g1:
            s0, s1, stack = pieces[i]
            overlap = min(g1, s1) - max(g0, s0)
            if overlap > 0:
                idle[stack] = idle.get(stack, 0.0) + overlap
                covered += overlap
            i += 1
        if g1 - g0 > covered:
            idle[()] = idle.get((), 0.0) + (g1 - g0 - covered)
    return busy, idle


def under(idle: dict[Stack, float], name: str) -> dict[str, float]:
    """Idle seconds inside the outermost `name` spans, by the child span
    the host was in ("self": in `name` itself)."""
    out: dict[str, float] = {}
    for stack, secs in idle.items():
        if name in stack:
            i = stack.index(name)
            child = stack[i + 1] if len(stack) > i + 1 else "self"
            out[child] = out.get(child, 0.0) + secs
    return out


def _profiled(steps, device: torch.device):
    """steps() under torch.profiler inside a WINDOW range: (its events,
    the window's interval), as `trace.profile` takes them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            steps()
            torch.cuda.synchronize(device)
    events = list(trace._events(prof))
    window = [(a, b) for is_dev, name, a, b in events
              if not is_dev and name == trace.WINDOW]
    if not window:
        raise RuntimeError("the profiler recorded no window range")
    return events, window[0]


def _steps(ctx, metrics) -> dict:
    """The traced steps (module docstring): the profiled steps' trace,
    events and window, the others' trace and seconds, and their number."""
    from perfbench import run
    from perfbench.harness import system

    cell, mix = ctx.cell, ctx.traffic
    p = system.params(cell.config)
    spans = trace.Spans(False, ctx.device)
    n = int(cell.params["trace_steps"])
    first = ctx.solves[-1]["step"] + 1 + n       # after the run's own
    solver = ctx.solver
    if mix.moving:
        ctx.solver = solver = None
        gc.collect()
        solver, res = run._step(ctx, system, None,
                                *run.inputs(mix, first, p), spans)
        del res
        first += 1
    made = [run.inputs(mix, s, p) for s in range(first, first + 2 * n)]

    def steps():
        nonlocal solver
        for _ in range(n):
            theta, b = made.pop(0)
            if mix.moving:
                solver = None
                gc.collect()
            solver, res = run._step(ctx, system, solver, theta, b, spans)
            del theta, b, res

    with metrics.tracing() as profiled:
        events, window = _profiled(steps, ctx.device)
    with metrics.tracing() as plain:
        torch.cuda.synchronize(ctx.device)
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize(ctx.device)
        plain_s = time.perf_counter() - t0
    return dict(profiled=profiled, events=events, window=window,
                plain=plain, plain_s=plain_s, steps=n)


def _outer_steps(spans) -> int:
    """`krylov.step` spans directly under an outermost `krylov.solve`."""
    return sum(s.name == "krylov.step" and s.parent is not None
               and spans[s.parent].name == "krylov.solve"
               and spans[s.parent].parent is None for s in spans)


def summary(profiled, busy: float, idle: dict[Stack, float],
            window_s: float, t, plain_s: float, steps: int) -> dict:
    """The readers' numbers and the log line's: the device's idle time
    from the profiled steps (their trace `profiled`, the split of their
    window's idle time), the rest from the steps run without the
    profiler (their trace `t`, their seconds `plain_s`)."""
    profiled_steps = _outer_steps(profiled.spans)
    spans = t.spans
    outer_steps = _outer_steps(spans)
    in_solve = under(idle, "krylov.solve")
    in_capture = under(idle, "graph.capture")
    # a capture runs inside the first step of a solve on a new graph: its
    # idle is setup.capture_s's, not the outer loop's
    loop_idle = sum(in_solve.values()) - sum(
        secs for stack, secs in idle.items()
        if "krylov.solve" in stack and "graph.capture" in stack)
    replay_ms = t.device_ms("pc.replay")
    replays = sum(s.name == "pc.replay" for s in spans)
    captures = [s for s in spans if s.name == "graph.capture"]
    roots = [s for s in spans
             if s.parent is None and "device_allocs" in s.attrs]
    self_s: dict[str, float] = {}
    for s in spans:
        self_s[s.name] = self_s.get(s.name, 0.0) + s.seconds
        if s.parent is not None:
            name = spans[s.parent].name
            self_s[name] = self_s.get(name, 0.0) - s.seconds
    by_innermost: dict[str, float] = {}
    for stack, secs in idle.items():
        name = stack[-1] if stack else "outside"
        by_innermost[name] = by_innermost.get(name, 0.0) + secs
    capture_children: dict[str, float] = {}
    for s in spans:
        if s.parent is not None and spans[s.parent].name == "graph.capture":
            capture_children[s.name] = (capture_children.get(s.name, 0.0)
                                        + s.seconds)
    allocs: dict[str, int] = {}
    for s in spans:
        if "device_allocs" in s.attrs:
            allocs[s.name] = allocs.get(s.name, 0) + s.attrs["device_allocs"]

    def children_share(inside: dict[str, float]):
        total = sum(inside.values())
        return (100.0 * (total - inside.get("self", 0.0)) / total
                if total else None)

    return dict(
        idle_ms_per_iter=(1e3 * loop_idle / profiled_steps
                          if profiled_steps else None),
        replay_ms=statistics.median(replay_ms) if replay_ms else None,
        inner_steps=(t.counters.get("pc.inner_steps", 0) / replays
                     if replays else None),
        capture_s=(sum(s.seconds for s in captures) / steps
                   if captures else None),
        device_mallocs=(sum(s.attrs["device_allocs"] for s in roots) / steps
                        if roots else None),
        log=dict(
            steps=steps, outer_iterations_profiled=profiled_steps,
            ms_an_iteration_profiled=(1e3 * window_s / profiled_steps
                                      if profiled_steps else None),
            outer_iterations=outer_steps,
            ms_an_iteration=(1e3 * plain_s / outer_steps
                             if outer_steps else None),
            window_s=window_s, busy_s=busy, idle_s=sum(idle.values()),
            idle_s_by_span=by_innermost, self_s_by_span=self_s,
            idle_in_krylov_solve=in_solve,
            krylov_solve_idle_on_children_pct=children_share(in_solve),
            idle_in_graph_capture=in_capture,
            graph_capture_idle_on_children_pct=children_share(in_capture),
            captures=len(captures),
            capture_s=[s.seconds for s in captures],
            capture_children_s=capture_children,
            pool_bytes_a_capture=(t.counters.get("graph.pool_bytes", 0)
                                  / len(captures) if captures else None),
            replays=replays,
            replay_ms=dict(median=statistics.median(replay_ms),
                           min=min(replay_ms), max=max(replay_ms))
            if replay_ms else None,
            launches_a_replay=(t.counters.get("pc.launches", 0) / replays
                               if replays else None),
            inner_steps=t.counters.get("pc.inner_steps", 0),
            device_allocs_by_span=allocs))


def _run(ctx) -> dict | None:
    if ctx.device.type != "cuda" or ctx.trace is None:
        return None
    from mpbp_tpu_torch.utils import metrics

    if not hasattr(metrics, "tracing"):
        return None
    got = _steps(ctx, metrics)
    profiled, window = got["profiled"], got["window"]
    busy, idle = split_idle(got["events"], window,
                            {s.name for s in profiled.spans})
    got = summary(profiled, busy, idle, window[1] - window[0],
                  got["plain"], got["plain_s"], got["steps"])
    print("program trace: " + json.dumps(got.pop("log")), flush=True)
    return got


def read(ctx) -> dict | None:
    """The program's trace of the run (module docstring), once."""
    if "program_trace" not in vars(ctx):
        ctx.program_trace = _run(ctx)
    return ctx.program_trace
