"""The benchmark's own spans and the reduction of a profiler window.

Spans are host intervals the harness opens around its calls into each
layer of the program (assembly, preconditioner build, graph capture, the
outer FGMRES, the reference). With spans on, each end synchronises the
device, so a span holds its work and no other, and each span is also a
`torch.profiler.record_function` range, by which the device's idle gaps
are placed. With spans off (the measured runs) a span costs nothing.

`profile` runs a callable under `torch.profiler` and reduces its trace:
busy seconds as the union of the device's activity intervals (kernels,
copies and sets on every stream; the bodies of a graph's IF nodes run on
streams of their own, so summed kernel time could count an instant
twice), the window's seconds, the device operations that took most time
by name, and the longest idle gaps, each named by the innermost span the
host was in when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

SPANS = ("setup.assemble", "setup.pc", "setup.capture", "solve.fgmres",
         "reference")
WINDOW = "trace.window"
TOP = 10


class Spans:
    """Host spans: (name, start s, end s) in `records`, when on."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = device
        self.records: list[tuple[str, float, float]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            self._sync()
        self.records.append((name, t0, time.perf_counter()))


def union_seconds(intervals: list[tuple[float, float]]) -> tuple[
        float, list[tuple[float, float]]]:
    """(length of the union, the merged intervals in order)."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def gaps(busy: list[tuple[float, float]], start: float,
         end: float) -> list[tuple[float, float]]:
    """The idle intervals of [start, end] between merged busy intervals."""
    out, t = [], start
    for a, b in busy:
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def _innermost(ranges: list[tuple[float, float, str]], t: float) -> str:
    """The latest-starting range holding t (ranges sorted by start)."""
    starts = [r[0] for r in ranges]
    i = bisect.bisect_right(starts, t)
    while i:
        i -= 1
        if ranges[i][1] >= t:
            return ranges[i][2]
    return "outside"


def _events(prof):
    """(is_device, name, start s, end s) of every event of the trace."""
    from torch.autograd import DeviceType

    kineto = getattr(prof.profiler, "kineto_results", None)
    if kineto is not None:
        for e in kineto.events():
            start = e.start_ns() / 1e9
            yield (e.device_type() == DeviceType.CUDA, e.name(), start,
                   start + e.duration_ns() / 1e9)
        return
    for e in prof.events():
        yield (e.device_type == DeviceType.CUDA, e.name,
               e.time_range.start / 1e6, e.time_range.end / 1e6)


def reduce(events, window: tuple[float, float]) -> dict:
    """busy_s, window_s and the breakdown of (is_device, name, start, end)
    events over `window` (s, on the events' clock)."""
    w0, w1 = window
    device, ranges, by_name = [], [], {}
    for is_dev, name, a, b in events:
        if is_dev and (name in SPANS or name == WINDOW):
            continue        # the ranges' own marks on the device's timeline
        if is_dev:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b))
                by_name[name] = by_name.get(name, 0.0) + (b - a)
        elif name in SPANS:
            ranges.append((a, b, name))
    ranges.sort()
    busy, merged = union_seconds(device)
    idle = sorted(((b - a, _innermost(ranges, a))
                   for a, b in gaps(merged, w0, w1)), reverse=True)
    by_span: dict[str, float] = {}
    for secs, name in idle:
        by_span[name] = by_span.get(name, 0.0) + secs
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy, window_s=w1 - w0, kernels=len(device),
                device_ops=[[name[:160], s] for name, s in top],
                idle_gaps=[[name, s] for s, name in idle[:TOP]],
                idle_by_span=by_span)


def profile(run, device: torch.device) -> dict:
    """run() under torch.profiler inside a WINDOW range, reduced."""
    from torch.profiler import ProfilerActivity, profile as _profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with _profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            run()
            if cuda:
                torch.cuda.synchronize(device)
    events = list(_events(prof))
    window = [(a, b) for is_dev, name, a, b in events
              if not is_dev and name == WINDOW]
    if not window:
        raise RuntimeError("the profiler recorded no window range")
    return reduce(events, window[0])
