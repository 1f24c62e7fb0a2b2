"""krylov.idle_ms_per_iter.<part>: device milliseconds idle an outer
FGMRES iteration, from the program's own trace of a traced run
(`harness/program_trace.py`): the device's idle time inside the program's
outermost `krylov.solve` spans, outside a graph capture (which
setup.capture_s reads), over the `krylov.step` spans directly under them.
One reader for every part; each part moves its cells' end-to-end
metric."""

from perfbench.harness import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    return None if got is None else got["idle_ms_per_iter"]
