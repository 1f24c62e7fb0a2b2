"""Kernels K1 (F-apply) and K2 (A-apply): hand-written CUDA for Hopper,
with their plain PyTorch versions.

Replaces `mpbp_tpu/ops/pallas_stencil.py`:
  * `f_apply` (K1, entry points f_apply_f32/f_apply_f64) replaces
    `velocity_pallas_apply_planes` / `velocity_pallas_apply`: the flux-form
    velocity block F on stacked (4, n, n) state.
  * `a_apply` (K2, entry points a_apply_f32/a_apply_f64) replaces
    `multiphase_pallas_apply_inkernel_halo`: the full coupled A on stacked
    (5, n, n) state.
Both run `models/fused.velocity_block_math` / `multiphase_apply_math` term
for term, in flux form, from the theta_n cell plane and the two pointwise
face planes; every other coefficient is recomputed in registers.

What bounds them: HBM bytes. K1 reads 7 planes (3 theta + 4 state) and
writes 4; K2 reads 8 and writes 5. At ~120 flops per point against 88 (K1,
f64) to 104 (K2, f64) bytes per point, both sit far below the card's
flop/byte balance. The design answers that the way the TPU kernel did:
one pass, no coefficient planes streamed, each output written once. The
radius-1 neighbour reads (~40 per point) are served by L1/L2, since
adjacent threads of a 32x8 block share them, so DRAM traffic stays near the
13-plane minimum. The TPU kernel's 8-row halo extension, predicated wrap
DMAs and in-lane column roll existed for Mosaic's alignment rules; here a
periodic index (r+dr+n)%n per read does the wrap. Shared-memory tiling,
TMA and wider per-thread work are for later.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise. `LAUNCHES` counts kernel launches only.
"""

from __future__ import annotations

import torch

from mpbp_tpu_torch.models.fused import (multiphase_apply_math,
                                         velocity_block_math)
from mpbp_tpu_torch.ops import _build
from mpbp_tpu_torch.ops.stencil import shift

LAUNCHES = {"f_apply": 0, "a_apply": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def f_apply_reference(tn, wnx, wny, x, params: dict, dx: float,
                      dy: float) -> torch.Tensor:
    """Plain PyTorch K1: F applied to stacked (4, n, n) state."""
    return torch.stack(velocity_block_math(
        shift, tn, wnx, wny, x[0], x[1], x[2], x[3], params, dx, dy))


def a_apply_reference(tn, wnx, wny, x, params: dict, dx: float,
                      dy: float) -> torch.Tensor:
    """Plain PyTorch K2: A applied to stacked (5, n, n) state."""
    return torch.stack(multiphase_apply_math(
        shift, tn, wnx, wny, x[0], x[1], x[2], x[3], x[4], params, dx, dy))


def f_apply(tn, wnx, wny, x, params: dict, dx: float,
            dy: float) -> torch.Tensor:
    """K1: (4, n, n) -> (4, n, n). Kernel on CUDA, plain version on CPU."""
    return _dispatch("f_apply", 4, f_apply_reference,
                     tn, wnx, wny, x, params, dx, dy)


def a_apply(tn, wnx, wny, x, params: dict, dx: float,
            dy: float) -> torch.Tensor:
    """K2: (5, n, n) -> (5, n, n). Kernel on CUDA, plain version on CPU."""
    return _dispatch("a_apply", 5, a_apply_reference,
                     tn, wnx, wny, x, params, dx, dy)


def _check(nf: int, tn, wnx, wny, x) -> None:
    if x.dim() != 3 or x.shape[0] != nf or x.shape[1] != x.shape[2]:
        raise ValueError(f"state must be ({nf}, n, n), got {tuple(x.shape)}")
    n = x.shape[1]
    if n < 1:
        raise ValueError("empty grid")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"dtype {x.dtype} not supported (float32/float64)")
    for name, t in (("tn", tn), ("wnx", wnx), ("wny", wny), ("x", x)):
        if name != "x" and tuple(t.shape) != (n, n):
            raise ValueError(f"{name} must be ({n}, {n}), got "
                             f"{tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, state is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, state on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dispatch(name, nf, reference, tn, wnx, wny, x, params, dx, dy):
    _check(nf, tn, wnx, wny, x)
    if x.device.type == "cpu":
        return reference(tn, wnx, wny, x, params, dx, dy)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    out = torch.empty_like(x)
    _build.launch("fused_stencil", f"{name}_{_SUFFIX[x.dtype]}", x.device,
                  tn.data_ptr(), wnx.data_ptr(), wny.data_ptr(),
                  x.data_ptr(), out.data_ptr(), x.shape[1],
                  float(params["c"]), float(params["d"]), float(params["xi"]),
                  float(params["eta_n"]), float(params["eta_s"]),
                  float(params.get("d_p", 1.0)),
                  float(params.get("d_div", -1.0)), float(dx), float(dy))
    LAUNCHES[name] += 1
    return out
