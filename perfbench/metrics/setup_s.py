"""setup_s: process start to the first timed solve: imports, the card,
the kernels from the build directory, assembly, preconditioner, capture
and one warm-up step of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
