"""krylov.orthog_ms: device milliseconds of the outer FGMRES's projection
of a step off its basis (CGS2, `gmres._orthogonalize`): the median of the
program's CUDA event pairs `krylov.orthogonalize` over the outer steps of
one more solve of a traced run, run without the profiler
(`harness/krylov_trace.py`)."""

from perfbench.harness import krylov_trace


def read(ctx):
    got = krylov_trace.read(ctx)
    return None if got is None else got["orthog_ms"]
