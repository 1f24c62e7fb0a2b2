"""device.idle_share.<part>: the share of the traced window in which no
operation ran on the device, 1 - (union of its busy intervals) / window,
in %. One reader for every part; each part moves its cells' end-to-end
metric."""


def read(ctx):
    if ctx.device.type != "cuda" or ctx.trace is None \
            or not ctx.trace["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
