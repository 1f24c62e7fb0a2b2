"""pc.apply_ms: device milliseconds of one preconditioner apply M(v) as the
solves run it (the replay of its CUDA graph), on a vector drawn from the
seed, after the window: CUDA events, the median of 20."""

import numpy as np
import torch

from perfbench.harness import roofline


def read(ctx):
    solver = ctx.solver
    if ctx.device.type != "cuda" or solver is None or solver.M is None:
        return None
    n = int(ctx.cell.config["n"])
    v = torch.as_tensor(np.random.default_rng([ctx.seed, 4]).standard_normal(
        5 * n * n), dtype=solver.dtype, device=ctx.device)
    secs = roofline.median_seconds(lambda: solver.M(v), ctx.device,
                                   flush=False)
    return secs * 1e3
