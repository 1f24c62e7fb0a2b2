"""kernel.f_sweep_roofline: one damped Jacobi sweep of the velocity
multigrid, x + inv_d (b - F x) (kernel K11, `ops.cuda_mg.f_sweep`), in
f32 at the cell's finest n, through the port's public call, after an L2
flush; the least time its bytes (15 planes in, 4 out) allow over the time
it took, in %."""

from perfbench.harness import kernels


def read(ctx):
    return kernels.roofline_share(ctx, "f_sweep")
