"""Per-solve metrics records (port of `mpbp_tpu/utils/metrics.py`):
timings, the nnz/s throughput counter and the residual history as a
JSON-serialisable record; and the port's own spans and counters.

The JAX package's `profiler_trace` wraps `jax.profiler`. The port traces
itself: inside `with tracing() as t:` every layer boundary the block
passes is a span of `t` (name, start and end by `time.perf_counter_ns`,
its parent and its root: every span of one solve or one build shares the
root), counters add up in `t.counters`, and a span that needs device time
records a CUDA event pair on the current stream (`device_time`), resolved
when `t.device_ms` reads it after the work. While a `torch.profiler` is
recording, each span is also a `torch.profiler.record_function` range of
its name, so its host interval sits among the device's kernels on the
profiler's clock. No span synchronises or reads the device: under a
graph capture a host read raises (`solvers/graphs.py`). Entering and
leaving `tracing()` settles the launch tallies that graph replays left
on the device (`ops/_build.settle_deferred`, one read where a replay left
one pending), so that the block's counters hold its own replays. With
tracing off (the default) `span` costs one check of a module global and
returns a shared no-op context: no range, no event, no allocation, no
device call. One thread records at a time.

The spans (children indented) and what reads them (`perfbench/harness/
program_trace.py`, `chip_smoke.py`'s census by region):

  krylov.solve          `gmres.fgmres` / `gmres` / `fgmres_resumable`
    krylov.init         a cycle's initial residual and basis
    krylov.read_done    the host read of `done` before each step
    krylov.step         one outer Arnoldi step: the PC apply, the matvec
      pc.replay         a graphed PC's copy in, replay and copy out; its
                        replay is the `device_time` pair "pc.replay"
    krylov.result       the host's read of the state and back-substitution
  graph.capture         `GraphedApply`'s graph made at its first call
    graph.adopt         a released graph of the same structure taken over:
                        the copy of the new tensors into its apply's
                        (where it happens, none of the four below)
    graph.warmup        the masked warm-up apply
    graph.begin         `torch.cuda.graph`'s entry (sync, cache emptying,
                        capture_begin)
    graph.record        the apply under capture
    graph.end           its exit (capture_end, instantiation)
  operator.assemble     `make_multiphase_operator`
  pc.build              `drivers.make_preconditioner(_mixed)`
    pc.lsc_products     GtG and GtFG, `preconditioners.lsc_products`
    mg.pressure.build, mg.velocity.build   the MG hierarchies
  pc.lsc                an LSC apply, run on the host only eagerly (and in
                        a capture's warm-up and recording: a replay
                        passes none of these)
    pc.f_inner, pc.p_inner   the F-block and pressure-block inner solves
      mg.velocity > mg.velocity.transfer; mg.pressure

Root spans and `graph.capture` carry the caching allocator's counts of
device allocations and frees over the span (attrs `device_allocs`,
`device_frees`; read on the host at its ends, only while tracing).
Counters: `pc.inner_steps`, the IF bodies the replays ran;
`pc.launches`, the kernel-wrapper launches they made (what they add to
`ops/_build.Launches`); `graph.pool_bytes`, the device memory the
captures' recordings reserved for their graphs' pools; `graph.captures`
and `graph.adoptions`, the first calls that captured a graph and those
that took a released one over.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import time

import numpy as np
import torch


@dataclasses.dataclass
class SolveMetrics:
    n: int
    pc: str
    iters: int
    converged: bool
    relres: float
    setup_time_s: float
    solve_time_s: float
    time_per_iter_s: float
    nnz: int
    nnz_per_s: float
    res_history: list

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["res_history"] = [float(x) for x in self.res_history]
        return json.dumps(d)


class Timer:
    """Wall-clock section timer: with Timer() as t: ...; t.elapsed. Work
    queued on a GPU is timed only if the section ends in a
    `torch.cuda.synchronize()` (the solvers' host syncs do that)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.t0
        return False


def collect_solve_metrics(report, nnz: int, setup_time: float,
                          solve_time: float) -> SolveMetrics:
    iters = max(int(report.iters), 1)
    return SolveMetrics(
        n=report.n, pc=report.pc, iters=int(report.iters),
        converged=bool(report.converged), relres=float(report.relres),
        setup_time_s=setup_time, solve_time_s=solve_time,
        time_per_iter_s=solve_time / iters,
        nnz=nnz, nnz_per_s=nnz * iters / max(solve_time, 1e-12),
        res_history=list(np.asarray(report.res_history)),
    )


_trace: "Trace | None" = None      # the trace `tracing()` is recording
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class SpanRecord:
    name: str
    start_ns: int                 # time.perf_counter_ns()
    end_ns: int | None            # None while the span is open
    parent: int | None            # index of the enclosing span in Trace.spans
    root: int                     # index of the outermost enclosing span
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _allocator_calls() -> tuple[int, int] | None:
    """The caching allocator's device allocations and frees so far on the
    current card (a host read of its counters), or None without one."""
    if not torch.cuda.is_initialized():
        return None
    s = torch.cuda.memory_stats()
    if "num_device_alloc" in s:
        return s["num_device_alloc"], s["num_device_free"]
    return s["segment.all.allocated"], s["segment.all.freed"]


class Trace:
    """What one `tracing()` block recorded: `spans` in the order they
    opened, `counters` by name, and the device milliseconds of each
    `device_time` pair (`device_ms`)."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        self._open: list[int] = []
        self._pairs: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._ms: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def _span(self, name: str, attrs: dict):
        parent = self._open[-1] if self._open else None
        i = len(self.spans)
        rec = SpanRecord(name, time.perf_counter_ns(), None, parent,
                         i if parent is None else self.spans[parent].root,
                         attrs)
        self.spans.append(rec)
        self._open.append(i)
        before = (_allocator_calls()
                  if parent is None or name == "graph.capture" else None)
        try:
            with (torch.profiler.record_function(name)
                  if torch.autograd._profiler_enabled() else _OFF):
                yield rec
        finally:
            self._open.pop()
            rec.end_ns = time.perf_counter_ns()
            if before is not None:
                after = _allocator_calls()
                rec.attrs.update(device_allocs=after[0] - before[0],
                                 device_frees=after[1] - before[1])

    @contextlib.contextmanager
    def _timed(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._pairs.append((name, start, end))

    def device_ms(self, name: str) -> list[float]:
        """Device milliseconds of each `device_time(name)` block, in order.
        The pairs recorded since the last read are resolved here (a wait
        on each end event): read the trace after the work."""
        for key, start, end in self._pairs:
            end.synchronize()
            self._ms.setdefault(key, []).append(start.elapsed_time(end))
        self._pairs.clear()
        return list(self._ms.get(name, ()))


def _settle() -> None:
    from mpbp_tpu_torch.ops import _build

    _build.settle_deferred()


@contextlib.contextmanager
def tracing():
    """Record the spans and counters of the block; yields its `Trace`."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a tracing() block is already open")
    _settle()
    _trace = trace = Trace()
    try:
        yield trace
    finally:
        try:
            _settle()
        finally:
            _trace = None


def span(name: str, **attrs):
    """The span `name` of the trace being recorded around the block (its
    record is the `as` target), or, with tracing off, a shared no-op
    context whose target is None."""
    if _trace is None:
        return _OFF
    return _trace._span(name, attrs)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _trace is None:
                return fn(*args, **kwargs)
            with _trace._span(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def device_time(name: str):
    """A CUDA event pair around the block, on the current stream, named
    `name` in the trace being recorded; a no-op with tracing off."""
    if _trace is None:
        return _OFF
    return _trace._timed(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the trace being recorded."""
    if _trace is not None:
        _trace.counters[name] = _trace.counters.get(name, 0) + n
