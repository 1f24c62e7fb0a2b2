"""kernel.f_apply_roofline: the velocity block's apply F x (kernel K1,
`ops.cuda_stencil.f_apply`) in f32 at the cell's finest n, through the
port's public call, timed after an L2 flush; the least time its bytes
(7 planes in, 4 out) allow over the time it took, in %."""

from perfbench.harness import kernels


def read(ctx):
    return kernels.roofline_share(ctx, "f_apply")
