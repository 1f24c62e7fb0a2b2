"""step_s: the seconds of the window's time steps over their number, a
step being the release of the last step's objects, the operator's
assembly from its theta_n planes, the preconditioner's build, its graph's
capture and the solve (its inputs made before it)."""


def read(ctx):
    return ctx.window_s / len(ctx.solves)
