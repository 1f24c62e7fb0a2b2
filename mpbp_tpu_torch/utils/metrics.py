"""Per-solve metrics records (port of `mpbp_tpu/utils/metrics.py`):
timings, the nnz/s throughput counter and the residual history as a
JSON-serialisable record. The JAX package's `profiler_trace` wraps
`jax.profiler`; the port's device traces are taken with `torch.profiler`
where they are needed (`chip_smoke.py`)."""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np


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
