"""peak_gb: the device's peak allocation (`torch.cuda.max_memory_allocated`,
reset at process start) over the set-up and the window, in 1e9 bytes."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.device.type == "cuda" else None
