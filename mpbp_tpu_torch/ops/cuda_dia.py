"""Kernel K5/K6, the DIA SpMV: hand-written CUDA for Hopper
(`csrc/sparse_spmv.cu`, entry points dia_spmv_f32/dia_spmv_f64), with its
plain PyTorch version.

Replaces `mpbp_tpu/ops/pallas_dia.py`: `dia_spmv_pallas` (x resident in
VMEM) and `dia_spmv_pallas_streamed` (x streamed in windows past VMEM) are
one kernel here, since the card reads x through its 50 MB L2 and has no
VMEM ceiling to stream around. It computes

    y[i] = sum_k data[k, i] * (i < ncols ? x[(i + off_k) mod ncols] : 0)

for any shape and signed or periodic offsets (the `DIAMatrix.matvec`
convention), one thread per row, so each diagonal's read is coalesced.

On a CPU tensor `dia_spmv` runs the plain version; on a CUDA tensor it
launches the kernel or raises. `LAUNCHES` counts kernel launches only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mpbp_tpu_torch.ops import _build

LAUNCHES = {"dia_spmv": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def dia_spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5/K6 on a `DIAMatrix` A: the `torch.roll` form."""
    nrows, ncols = A.shape
    acc = None
    for k, off in enumerate(A.offsets):
        xs = torch.roll(x, -off) if off else x
        if nrows <= ncols:
            contrib = A.data[k] * xs[:nrows]
        else:
            contrib = A.data[k] * F.pad(xs, (0, nrows - ncols))
        acc = contrib if acc is None else acc + contrib
    if acc is None:
        return torch.zeros(nrows, dtype=x.dtype, device=x.device)
    return acc


def dia_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """K5/K6: y = A @ x for a `DIAMatrix` A. Kernel on CUDA, plain version
    on CPU."""
    nrows, ncols = A.shape
    data = A.data
    if x.dim() != 1 or x.shape[0] != ncols:
        raise ValueError(f"x must be ({ncols},), got {tuple(x.shape)}")
    if tuple(data.shape) != (len(A.offsets), nrows):
        raise ValueError(f"data must be ({len(A.offsets)}, {nrows}), got "
                         f"{tuple(data.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"dtype {x.dtype} not supported (float32/float64)")
    if data.dtype != x.dtype:
        raise TypeError(f"data is {data.dtype}, x is {x.dtype}")
    if data.device != x.device:
        raise ValueError(f"data is on {data.device}, x on {x.device}")
    if x.device.type == "cpu":
        return dia_spmv_reference(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x.device}")
    offs = A.kernel_offsets
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("data and x must be contiguous")
    y = torch.empty(nrows, dtype=x.dtype, device=x.device)
    if nrows == 0:
        return y
    _build.launch("sparse_spmv", f"dia_spmv_{_SUFFIX[x.dtype]}", x.device,
                  data.data_ptr(), offs.data_ptr(), len(A.offsets), nrows,
                  ncols, x.data_ptr(), y.data_ptr())
    LAUNCHES["dia_spmv"] += 1
    return y
