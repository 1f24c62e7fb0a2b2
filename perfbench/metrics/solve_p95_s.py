"""solve_p95_s (and its parts, such as solve_p95_s.step, a time step's):
the 95th percentile (nearest rank) of the seconds of every solve of the
window, each from the start of its step to its synced end."""

import math


def read(ctx):
    times = sorted(r["seconds"] for r in ctx.solves)
    return times[math.ceil(0.95 * len(times)) - 1]
