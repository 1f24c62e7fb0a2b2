"""What decides `correct`: the window's answers against the plain
reference (`perfbench/reference/`).

Every answer of a solve can be checked on its own: x solves A x = b to the
configuration's guarantee (its `limit_relres`, a few times its `tol`).
The reference works A out again from the step's theta_n planes and takes
the step's right-hand side, both made by the mix's generator from the
seed, never from the program; it reads the program's x only to judge it.
The numbers compared:

  relres_max   the largest ||b - A x|| / ||b|| (float64) over the sampled
               answers, against the configuration's `limit_relres`;
  unconverged  the window's solves that the program itself reported as not
               converged, against 0.
"""

from __future__ import annotations

import math

from perfbench.harness import system
from perfbench.reference import multiphase as reference

# the reading of an answer whose residual is not a finite number
_NOT_FINITE = 1e300


def check(ctx, samples: dict) -> tuple[dict, int]:
    """(checks, failed) of a run's sampled answers {step: x on the host}."""
    cfg, limit = ctx.cell.config, float(ctx.cell.config["limit_relres"])
    p = system.params(cfg)
    worst, over = 0.0, 0
    converged = {r["step"]: r["converged"] for r in ctx.solves}
    for step, x in sorted(samples.items()):
        rel = reference.relative_residual(ctx.traffic.theta(step), p,
                                          ctx.traffic.rhs(step, p),
                                          x.to(ctx.device))
        if not math.isfinite(rel):
            rel = _NOT_FINITE
        worst = max(worst, rel)
        if rel > limit:
            over += converged[step]
    unconverged = sum(not r["converged"] for r in ctx.solves)
    checks = {"relres_max": {"value": worst, "limit": limit},
              "unconverged": {"value": unconverged, "limit": 0}}
    return checks, unconverged + over
