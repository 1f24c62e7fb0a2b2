"""The outer FGMRES's own trace in a traced run, for the readers
`krylov.orthog_ms`, `krylov.orthog_roofline` and
`memory.krylov_basis_gb`.

`read(ctx)` runs once a traced run (memoised on the context), after the
readers the benchmark lists before those: one more solve, on the run's
own solver where the mix builds once and on one built from a later
step's theta_n where it rebuilds, with the program's tracing on and no
profiler, through `system.solve` with the benchmark's own spans off. It
reads the program's span `krylov.orthogonalize` (the projection of each
outer step off the basis; its attr `basis_rows`), that span's CUDA event
pairs, and the counter `krylov.basis_bytes` (the V and Z bases a cycle
allocates) over the solve's `krylov.init` spans (one a cycle).

The bytes of a projection off s + 1 rows are those of `gmres.
_orthogonalize` as it is written, in full-length vectors of the solve's
5 n^2 unknowns: CGS2 reads the s + 1 basis rows four times (two products
V_j w, two products h V_j), and makes 16 passes over w and its
temporaries besides: w read by the first product (1), w * w reading w
and written, then read by its sum (3), h1 V_j written (1), w - h1 V_j
reading two and writing one (3), the new w read by the second product
(1), h2 V_j written (1), the second update (3) and the new norm, whose
w * w is made and summed as the first (3). So (4 (s + 1) + 16) vectors
a projection, each counted once; at n = 2048
a vector (168 MB in float64) is larger than the card's L2, so every
pass comes from HBM.

Prints one `krylov trace:` line. Returns None without a CUDA card, in an
untraced run, and where the program has no such span or counter (a commit
before them): each reading it cannot make is None.
"""

from __future__ import annotations

import gc
import json
import statistics

import torch

from perfbench.harness import roofline, trace

SPAN = "krylov.orthogonalize"
BASIS_PASSES = 4          # CGS2's reads of each basis row a projection
VECTOR_PASSES = 16        # its passes over w and its temporaries


def _least_s(rows: int, row_bytes: int) -> float:
    """Seconds of one projection off `rows` rows at the HBM rate."""
    return ((BASIS_PASSES * rows + VECTOR_PASSES) * row_bytes
            / roofline.HBM_BYTES_PER_S)


def _run(ctx) -> dict | None:
    if ctx.device.type != "cuda" or ctx.trace is None:
        return None
    from mpbp_tpu_torch.utils import metrics

    if not hasattr(metrics, "tracing"):
        return None
    from perfbench import run
    from perfbench.harness import system

    cell, mix = ctx.cell, ctx.traffic
    p = system.params(cell.config)
    spans = trace.Spans(False, ctx.device)
    # a step past the window's and the program trace's
    step = ctx.solves[-1]["step"] + 2 + 4 * int(cell.params["trace_steps"])
    theta, b = run.inputs(mix, step, p)
    solver = ctx.solver
    if mix.moving or solver is None:
        ctx.solver = solver = None
        gc.collect()
        solver = system.build(cell.config, theta, ctx.device, spans)
    torch.cuda.synchronize(ctx.device)
    with metrics.tracing() as t:
        res = system.solve(cell.config, solver, b, spans)
    ctx.solver = solver
    ms = t.device_ms(SPAN)
    rows = [s.attrs.get("basis_rows") for s in t.spans if s.name == SPAN]
    inits = sum(s.name == "krylov.init" for s in t.spans)
    basis = t.counters.get("krylov.basis_bytes")
    row_bytes = b.numel() * torch.empty((), dtype=solver.dtype).element_size()
    roof, by_rows = None, {}
    if ms and len(ms) == len(rows) and None not in rows:
        roof = 100.0 * sum(map(_least_s, rows, [row_bytes] * len(rows))) \
            / (sum(ms) / 1e3)
        for r, m in zip(rows, ms):
            by_rows.setdefault(r, []).append(m)
    got = dict(orthog_ms=statistics.median(ms) if ms else None,
               orthog_roofline=roof,
               basis_gb=(basis / inits / 1e9 if basis and inits else None))
    print("krylov trace: " + json.dumps(dict(
        got, iterations=res.iters, projections=len(ms),
        orthog_ms_total=sum(ms), row_bytes=row_bytes, cycles=inits,
        # rows: [projections, median ms, the largest share of one, %]
        by_rows={r: [len(v), statistics.median(v),
                     100.0 * _least_s(r, row_bytes) / (min(v) / 1e3)]
                 for r, v in sorted(by_rows.items())})), flush=True)
    return got


def read(ctx) -> dict | None:
    """The outer FGMRES's trace of the run (module docstring), once."""
    if "krylov_trace" not in vars(ctx):
        ctx.krylov_trace = _run(ctx)
    return ctx.krylov_trace
