"""The port's `jit`: a preconditioner apply captured once as a CUDA graph
and replayed on every later call, with the inner Krylov loops exiting on
the device.

In the JAX package one outer FGMRES iteration, with its whole
preconditioner apply (the nested inner GMRES and CG solves, each a
`lax.while_loop` that stops on the device, the multigrid sweeps, the LSC
glue), is one compiled program (`mpbp_tpu/solvers/gmres.py`
`_fgmres_cycle`). Eager PyTorch launches the same apply as thousands of
kernels from the host, one Python call each. `GraphedApply` records them
once and replays the recording: the host's cost of an apply becomes one
copy in, one replay and one copy out.

`loop` runs the fixed-budget Krylov loops (`solvers/gmres.gmres_fixed`,
`cg_fixed`): step s = 0..m-1 while ~done & (j < m), as `lax.while_loop`
with its static bound m. It runs one of three ways:
  * captured (a `GraphedApply` capture in progress): step s is the body
    of a CUDA-graph IF node (`csrc/graph_cond.cu`) on the predicate
    ~done & (j < m), a () bool on the device computed before the node. A
    replay runs a body only where the loop would have stepped: the
    device-side exit. The node is made in C++ because PyTorch 2.11 has no
    Python API for it. A capture that cannot make the node raises;
  * eager (no capture, on any device, inside `disabled()` too): the
    loop reads `done` once a step and stops, as the `jax.disable_jit()`
    while loop tests its `cond`;
  * masked (inside `masked()`): all m steps run, every update masked past
    done, and nothing is read back: the A/B against the IF graph, and the
    CPU tests' check that the captured arithmetic makes no host read.
The state after a step that did not run is the state after a masked step,
and the solution is back-substituted on the device from it in every
mode, so x, the counts and the census are the same bits in all three.

What capture needs of the apply: it reads nothing back to the host (the
fixed-budget loops, the multigrid cycles, the LSC formula), its input
arrives in one static buffer and every tensor it closes over outlives the
graph (the setup memo of `drivers._solve_setup` holds both). A step body
writes the loop state in place: a tensor it allocates is garbage after a
replay that skipped it. A body is captured on a stream of its own, and
the capture routes this thread's allocations to the graph's pool, so the
bodies' tensors live there as the rest of the apply's do. Under capture
a host read raises; so does a failed launch. A failed capture raises:
nothing falls back to eager on CUDA.

The kernel wrappers count their launches in Python, where a replay does
not pass. Each wrapper's count during capture outside the IF bodies is
added again on every replay. A body's counts are added once for each
replay in which it ran: each predicate is a slot of a device buffer that
the graph tallies at its end, and the tallies are read, once, at the next
read of a count (`ops/_build.Launches`), never inside an apply.

On a CPU tensor the apply runs directly (there is no CPU graph), and
inside `disabled()` it runs eagerly on any device: the counterpart of
`jax.disable_jit()`, for an A/B and for debugging.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.ops import (_build, cuda_dia, cuda_ell, cuda_mg,
                                cuda_stencil)
from mpbp_tpu_torch.utils import metrics

# every kernel wrapper's launch counts
_COUNTERS = (cuda_stencil.LAUNCHES, cuda_dia.LAUNCHES, cuda_ell.LAUNCHES,
             cuda_mg.LAUNCHES)
_disabled = False
_masked = False
_recording: "_Recording | None" = None
_steps = 0             # the budgets of every `loop` so far


@contextlib.contextmanager
def disabled():
    """Run every `GraphedApply` eagerly inside the block."""
    global _disabled
    before, _disabled = _disabled, True
    try:
        yield
    finally:
        _disabled = before


@contextlib.contextmanager
def masked():
    """Run every fixed-budget loop as its masked budget inside the block
    (a `GraphedApply` captured here replays it so)."""
    global _masked
    before, _masked = _masked, True
    try:
        yield
    finally:
        _masked = before


def loop(done: torch.Tensor, j: torch.Tensor, m: int,
         step: Callable[[int], None]) -> None:
    """step(s) for s = 0..m-1 while ~done & (j < m) (module docstring).
    `done` and `j` are the loop state's () tensors, which each step
    updates in place."""
    global _steps
    _steps += m
    if _masked:
        for s in range(m):
            step(s)
    elif done.is_cuda and torch.cuda.is_current_stream_capturing():
        if _recording is None:
            raise RuntimeError("a fixed-budget Krylov loop is captured only "
                               "inside a GraphedApply capture")
        for s in range(m):
            live = _recording.slot()
            torch.logical_and(~done, j < m, out=live)
            with _recording.gate(live):
                step(s)
    else:
        for s in range(m):
            if bool(done):
                break
            step(s)


def _stream_besides(device: torch.device, taken) -> torch.cuda.Stream:
    """A stream of PyTorch's pool that is none of `taken` (raw handles).
    The pool hands out its streams round-robin, so after 32 requests a new
    stream is an old one again: a body stream that is the capture's own
    stream cannot begin a capture of its own (cudaErrorIllegalState)."""
    for _ in range(64):
        stream = torch.cuda.Stream(device)
        if stream.cuda_stream not in taken:
            return stream
    raise RuntimeError("no CUDA stream outside the capture's")


def _snapshot() -> list[dict]:
    return [dict(c) for c in _COUNTERS]


def _minus(a: list[dict], b: list[dict]) -> list[dict]:
    return [{k: x[k] - y.get(k, 0) for k in x if x[k] != y.get(k, 0)}
            for x, y in zip(a, b)]


class _Recording:
    """What one capture records of its IF bodies: each body's predicate
    (a slot of `live`, a bool buffer on the device), its own launches
    (those of the bodies nested in it apart) and, in `ran`, an int64
    tally of the replays in which each body ran. Both buffers are made
    before the capture, `n` slots long: the steps of a masked warm-up."""

    def __init__(self, device: torch.device, body: torch.cuda.Stream,
                 capture: torch.cuda.Stream, n: int):
        self.device = device
        self.capture = capture    # the stream the graph is captured on
        self.streams = [body]     # the body streams, one a nesting depth
        self.depth = 0
        self.live = torch.zeros(n, dtype=torch.bool, device=device)
        self.ran = torch.zeros(n, dtype=torch.int64, device=device)
        self.launches: list[list[dict]] = []
        self.in_bodies = [{} for _ in _COUNTERS]

    def slot(self) -> torch.Tensor:
        k = len(self.launches)
        if k == len(self.live):
            raise RuntimeError(f"the capture gates more than the {k} steps "
                               "of its masked warm-up")
        self.launches.append([{} for _ in _COUNTERS])
        return self.live[k]

    @contextlib.contextmanager
    def gate(self, live: torch.Tensor):
        """Capture the block as the body of an IF node on `live`, the
        latest slot."""
        k = len(self.launches) - 1
        if self.depth == len(self.streams):
            self.streams.append(_stream_besides(
                self.device, {s.cuda_stream
                              for s in (self.capture, *self.streams)}))
        body = self.streams[self.depth]
        before, nested = _snapshot(), [dict(c) for c in self.in_bodies]
        _build.launch("graph_cond", "graph_if_begin", self.device,
                      live.data_ptr(), body.cuda_stream)
        self.depth += 1
        try:
            with torch.cuda.stream(body):
                try:
                    yield
                finally:
                    _build.launch("graph_cond", "graph_if_end", self.device)
        finally:
            self.depth -= 1
        own = _minus(_minus(_snapshot(), before),
                     _minus(self.in_bodies, nested))
        self.launches[k] = own
        for total, d in zip(self.in_bodies, own):
            for name, n in d.items():
                total[name] = total.get(name, 0) + n

    def finish(self) -> None:
        """Captured last: tally this replay's predicates and clear them
        (a body nested in one that did not run leaves its slot 0)."""
        self.ran.add_(self.live)
        self.live.zero_()


class GraphedApply:
    """`apply` (a tensor -> tensor function with no host read) captured as
    a CUDA graph at its first CUDA call and replayed on each later one.

    The first call copies its input into the static buffer, runs `apply`
    once on a side stream as the masked budget (the warm-up: lazy library
    loads and allocator state stay out of the recording, and its steps
    size the IF bodies' buffers; the side stream then takes the bodies),
    captures `apply` on that buffer and replays the graph. Each
    call after it copies its input in, replays and returns a copy of the
    static output (a caller may keep it: the next replay overwrites the
    buffer). The input's shape, dtype and device are fixed by the first
    call; another raises ValueError.

    `gated_steps` is the number of IF bodies in the graph (the budgets of
    its loops), `steps_run` the bodies its replays ran, as of the last
    read of a launch count."""

    def __init__(self, apply: Callable):
        self.apply = apply
        self.graph: torch.cuda.CUDAGraph | None = None
        self._in = self._out = None
        self._launches: list[dict] = []
        self._replay_launches = 0      # those of _launches, summed
        self._bodies: _Recording | None = None
        self._per_body: list[dict] = []
        self.gated_steps = self.steps_run = 0

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if _disabled or v.device.type != "cuda":
            return self.apply(v)
        if self.graph is None:
            self._capture(v)
        elif (v.shape != self._in.shape or v.dtype != self._in.dtype
              or v.device != self._in.device):
            raise ValueError(
                f"graphed apply captured for {tuple(self._in.shape)} "
                f"{self._in.dtype} on {self._in.device}, called with "
                f"{tuple(v.shape)} {v.dtype} on {v.device}")
        with metrics.span("pc.replay"):
            self._in.copy_(v)
            with metrics.device_time("pc.replay"):
                self.graph.replay()
            for counter, added in zip(_COUNTERS, self._launches):
                for k, d in added.items():
                    counter.add(k, d)
            metrics.count("pc.launches", self._replay_launches)
            if self._bodies is not None \
                    and self._settle not in _build.DEFERRED:
                _build.DEFERRED.append(self._settle)
            return self._out.clone()

    @metrics.spanned("graph.capture")
    def _capture(self, v: torch.Tensor) -> None:
        global _recording
        static = v.clone()
        side = torch.cuda.Stream(v.device)
        side.wait_stream(torch.cuda.current_stream(v.device))
        steps = _steps
        with metrics.span("graph.warmup"), torch.cuda.stream(side), \
                masked():
            self.apply(static)
        torch.cuda.current_stream(v.device).wait_stream(side)
        capture = _stream_besides(v.device, {side.cuda_stream})
        rec = _Recording(v.device, side, capture, _steps - steps)
        pool = torch.cuda.graph_pool_handle()
        index = torch.cuda.current_device() if v.device.index is None \
            else v.device.index
        before = _snapshot()
        graph = torch.cuda.CUDAGraph()
        capturing = torch.cuda.graph(graph, pool=pool, stream=capture)
        _recording, routed = rec, False
        try:
            # the entry (a sync, the cache emptied, capture_begin) and the
            # exit (capture_end, the instantiation): spans of their own
            with metrics.span("graph.begin"):
                capturing.__enter__()
            try:
                with metrics.span("graph.record") as recorded:
                    # an IF body is captured on a stream of its own, which
                    # the capture's allocator filter (its stream's capture)
                    # does not route to the graph's pool: route this
                    # thread's instead
                    torch._C._cuda_endAllocateToPool(index, pool)
                    torch._C._cuda_beginAllocateCurrentThreadToPool(index,
                                                                    pool)
                    routed = True
                    reserved = torch.cuda.memory_reserved(index)
                    out = self.apply(static)
                    rec.finish()
            finally:
                with metrics.span("graph.end"):
                    capturing.__exit__(None, None, None)
        finally:
            _recording = None
            if routed:
                torch._C._cuda_releasePool(index, pool)
            # the capture launched nothing: its counts are the replay's
            after = _snapshot()
            for counter, b in zip(_COUNTERS, before):
                counter.update(b)
        if recorded is not None:      # tracing: the pool's bytes
            metrics.count("graph.pool_bytes",
                          torch.cuda.memory_reserved(index) - reserved)
        self._launches = _minus(_minus(after, before), rec.in_bodies)
        self._replay_launches = sum(n for d in self._launches
                                    for n in d.values())
        self.gated_steps = len(rec.launches)
        if rec.launches:
            self._bodies = rec
            keys = [sorted({k for body in rec.launches for k in body[i]})
                    for i in range(len(_COUNTERS))]
            self._per_body = [
                {k: np.array([body[i].get(k, 0) for body in rec.launches])
                 for k in keys[i]} for i in range(len(_COUNTERS))]
        self._in, self._out, self.graph = static, out, graph

    def _settle(self) -> None:
        """Add each IF body's launches times the replays it ran in, and
        clear the tallies: one read of the device."""
        rec = self._bodies
        torch.cuda.synchronize(self._in.device)
        ran = rec.ran[:len(rec.launches)].cpu().numpy()
        rec.ran.zero_()
        self.steps_run += int(ran.sum())
        metrics.count("pc.inner_steps", int(ran.sum()))
        for counter, per in zip(_COUNTERS, self._per_body):
            for k, each in per.items():
                launched = int(ran @ each)
                counter.add(k, launched)
                metrics.count("pc.launches", launched)
