"""pc.replay_ms: device milliseconds of one replay of the preconditioner's
CUDA graph as the solves run it: the median of the program's CUDA event
pairs around `graph.replay()` (the `pc.replay` pairs of its trace) over
the traced solves run without the profiler, whose kernel tracing slows
the replays (`harness/program_trace.py`)."""

from perfbench.harness import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    return None if got is None else got["replay_ms"]
