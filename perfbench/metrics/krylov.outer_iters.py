"""krylov.outer_iters.<part>: the outer FGMRES iterations a solve, the
mean of the program's own count (`KrylovResult.iters`) over the window's
solves (in a mix that rebuilds every step, a time step's solve). One
reader for every part; each part moves its cells' end-to-end metric."""


def read(ctx):
    return sum(r["iters"] for r in ctx.solves) / len(ctx.solves)
