"""setup.capture_s: host seconds of the preconditioner's graph capture a
step (the masked warm-up apply, `torch.cuda.graph`'s entry, the recording
and the exit): the program's `graph.capture` spans, with no sync at their
ends, over the traced steps run without the profiler, whose host cost
slows the capture's launches (`harness/program_trace.py`). Nothing to
read where the mix builds once."""

from perfbench.harness import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    return None if got is None else got["capture_s"]
