"""memory.device_mallocs: device allocation calls of the caching allocator
a step (`torch.cuda.memory_stats`' `num_device_alloc`) over the program's
root spans (assembly, PC build, the solve with its graph capture) of the
traced steps run without the profiler (`harness/program_trace.py`)."""

from perfbench.harness import program_trace


def read(ctx):
    got = program_trace.read(ctx)
    return None if got is None else got["device_mallocs"]
