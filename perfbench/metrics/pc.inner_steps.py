"""pc.inner_steps: the IF bodies (inner Krylov steps) a replay of the
preconditioner's graph ran in the traced solves: the program's counter
`pc.inner_steps` (`GraphedApply.steps_run`'s increase, settled from the
graph's device tallies) over its `pc.replay` spans, in the traced solves
run without the profiler (`harness/program_trace.py`)."""

from perfbench.harness import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    return None if got is None else got["inner_steps"]
