"""The kernel roofline readings: one function of the program timed alone,
in f32 at the cell's finest n, through the port's public call, on the
cell's theta_n planes and operands drawn from the seed."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import roofline, system


def roofline_share(ctx, function: str) -> float | None:
    """100 * least time / measured time of `function` (roofline.PLANES)."""
    if ctx.device.type != "cuda":
        return None
    from mpbp_tpu_torch.ops import cuda_mg, cuda_stencil

    n, dev, f32 = int(ctx.cell.config["n"]), ctx.device, torch.float32
    theta = ctx.traffic.theta(0)
    tn, wnx, wny = (theta[k].to(f32).contiguous()
                    for k in ("cell", "xface_pt", "yface_pt"))
    rng = np.random.default_rng([ctx.seed, 5])

    def draw(low=-1.0, high=1.0):
        return torch.as_tensor(rng.uniform(low, high, (4, n, n)), dtype=f32,
                               device=dev)

    p, h = system.params(ctx.cell.config), 1.0 / n
    x = draw()
    if function == "f_apply":
        def fn():
            return cuda_stencil.f_apply(tn, wnx, wny, x, p, h, h)
    elif function == "f_sweep":
        b, inv_d = draw(), draw(1e-6, 1e-5)

        def fn():
            return cuda_mg.f_sweep(tn, wnx, wny, x, b, inv_d, p, h, h)
    else:
        raise ValueError(f"no roofline for {function!r}")
    secs = roofline.median_seconds(fn, dev)
    nbytes, flops = roofline.work(function, n, f32)
    return 100.0 * roofline.least_seconds(nbytes, flops, f32) / secs
