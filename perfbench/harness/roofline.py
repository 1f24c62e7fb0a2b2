"""The yardstick of the kernel metrics: the card's published peaks, the
bytes and operations each timed function needs, and the timing of one
call (CUDA events, an L2 flush and a device sleep before each call).

Bytes count each input plane read once and each output plane written
once, from the function a kernel computes, never from how it computes
it: a later kernel that fuses or replaces it is read on the same work.
The least time is the larger of bytes over the HBM rate and operations
over the non-tensor-core rate of the type (NVIDIA's H100 SXM data sheet,
at its 700 W limit); a share is that least time over the measured one.
"""

from __future__ import annotations

import statistics

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

# the planes of (n, n) each function reads and writes
#   f_apply: y = F x on the velocity block; theta_n's cell plane and its
#            two pointwise face planes, x (4 planes) in, y (4) out
#   f_sweep: x + inv_d (b - F x), one damped Jacobi sweep of the velocity
#            multigrid; the three theta planes, x, b and inv_d (4 each)
#            in, the new x (4) out
PLANES = {"f_apply": (7, 4), "f_sweep": (15, 4)}
# operations a grid point: F x's 4 rows (190, the count of the stencil's
# products and sums, an FMA counting 2), and for the sweep a subtraction,
# a product and a sum in each of the 4 rows
FLOP_PER_POINT = {"f_apply": 190, "f_sweep": 190 + 12}


def work(function: str, n: int, dtype: torch.dtype) -> tuple[float, float]:
    """(bytes, operations) one call of `function` at n x n needs."""
    ins, outs = PLANES[function]
    size = torch.empty((), dtype=dtype).element_size()
    return ((ins + outs) * n * n * size, FLOP_PER_POINT[function] * n * n)


def least_seconds(nbytes: float, flops: float, dtype) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype])


_FLUSH: dict = {}


def l2_flush(device: torch.device) -> None:
    """Read four L2's worth of bytes: what the next kernel reads then comes
    from HBM."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _FLUSH:
        l2 = torch.cuda.get_device_properties(idx).L2_cache_size
        _FLUSH[idx] = torch.ones(l2, dtype=torch.float32, device=device)
    _FLUSH[idx].sum()


def median_seconds(fn, device: torch.device, flush: bool = True) -> float:
    """Median device seconds of 20 calls of fn() by CUDA events, after 3
    warm-up calls; each call after an L2 flush (where `flush`) and a ~5 ms
    device sleep, so the events bracket the call's kernels and not the
    host's launch gaps."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush:
            l2_flush(device)
        torch.cuda._sleep(10_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)
