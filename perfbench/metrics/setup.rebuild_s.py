"""setup.rebuild_s: the host seconds a step takes from its theta_n planes
to a preconditioner ready to replay (the spans setup.assemble, setup.pc
and setup.capture, each synced at both ends), the mean over the window's
steps. Nothing to read where the mix builds once."""

_STAGES = ("setup.assemble", "setup.pc", "setup.capture")


def read(ctx):
    steps = sum(name == "setup.assemble" for name, _, _ in ctx.window_spans)
    if not steps:
        return None
    total = sum(t1 - t0 for name, t0, t1 in ctx.window_spans
                if name in _STAGES)
    return total / steps
