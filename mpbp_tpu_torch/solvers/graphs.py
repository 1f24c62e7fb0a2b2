"""The port's `jit`: a preconditioner apply captured once as a CUDA graph
and replayed on every later call.

In the JAX package one outer FGMRES iteration, with its whole
preconditioner apply (the nested fixed-budget inner GMRES cycles, the
multigrid sweeps, the LSC glue), is one compiled program
(`mpbp_tpu/solvers/gmres.py` `_fgmres_cycle`). Eager PyTorch launches the
same apply as thousands of kernels from the host, one Python call each.
`GraphedApply` records them once and replays the recording: the host's
cost of an apply becomes one copy in, one replay and one copy out.

What capture needs of the apply: it reads nothing back to the host
(`solvers/gmres.gmres_fixed` and `cg_fixed`, the multigrid cycles, the
LSC formula), its input arrives in one static buffer and every tensor it
closes over outlives the graph (the setup memo of `drivers._solve_setup`
holds both). Under capture a host read raises; so does a failed launch.
A failed capture raises: nothing falls back to eager on CUDA.

The kernel wrappers count their launches in Python, where a replay does
not pass: each wrapper's count during capture is added again on every
replay, so the counts stay those of the launches the card ran.

On a CPU tensor the apply runs directly (there is no CPU graph), and
inside `disabled()` it runs eagerly on any device: the counterpart of
`jax.disable_jit()`, for an A/B and for debugging.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from mpbp_tpu_torch.ops import cuda_dia, cuda_ell, cuda_stencil

# every kernel wrapper's launch counts
_COUNTERS = (cuda_stencil.LAUNCHES, cuda_dia.LAUNCHES, cuda_ell.LAUNCHES)
_disabled = False


@contextlib.contextmanager
def disabled():
    """Run every `GraphedApply` eagerly inside the block."""
    global _disabled
    before, _disabled = _disabled, True
    try:
        yield
    finally:
        _disabled = before


def _snapshot() -> list[dict]:
    return [dict(c) for c in _COUNTERS]


class GraphedApply:
    """`apply` (a tensor -> tensor function with no host read) captured as
    a CUDA graph at its first CUDA call and replayed on each later one.

    The first call copies its input into the static buffer, runs `apply`
    once on a side stream (the warm-up: lazy library loads and allocator
    state stay out of the recording), captures `apply` on that buffer and
    replays the graph. Each call after it copies its input in, replays and
    returns a copy of the static output (a caller may keep it: the next
    replay overwrites the buffer). The input's shape, dtype and device are
    fixed by the first call; another raises ValueError."""

    def __init__(self, apply: Callable):
        self.apply = apply
        self.graph: torch.cuda.CUDAGraph | None = None
        self._in = self._out = None
        self._launches: list[dict] = []

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
        self._in.copy_(v)
        self.graph.replay()
        for counter, added in zip(_COUNTERS, self._launches):
            for k, d in added.items():
                counter[k] += d
        return self._out.clone()

    def _capture(self, v: torch.Tensor) -> None:
        static = v.clone()
        side = torch.cuda.Stream(v.device)
        side.wait_stream(torch.cuda.current_stream(v.device))
        with torch.cuda.stream(side):
            self.apply(static)
        torch.cuda.current_stream(v.device).wait_stream(side)
        before = _snapshot()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = self.apply(static)
        finally:
            # the capture launched nothing: its counts are the replay's
            after = _snapshot()
            for counter, b in zip(_COUNTERS, before):
                counter.update(b)
        self._launches = [{k: a[k] - b[k] for k in a if a[k] != b[k]}
                          for a, b in zip(after, before)]
        self._in, self._out, self.graph = static, out, graph

