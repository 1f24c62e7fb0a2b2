"""solve_s: the seconds of the window's solves over their number: each
solve from the start of its step to its synced end, its inputs made
before it."""


def read(ctx):
    return ctx.window_s / len(ctx.solves)
