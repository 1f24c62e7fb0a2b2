"""Kernels K1-K4 (F-apply and three forms of the A-apply): hand-written CUDA
for Hopper, with their plain PyTorch versions.

Replaces `mpbp_tpu/ops/pallas_stencil.py`:
  * `f_apply` (K1, entry points f_apply_f32/f_apply_f64) replaces
    `velocity_pallas_apply_planes` / `velocity_pallas_apply`: the flux-form
    velocity block F on stacked (4, n, n) state.
  * `a_apply` (K2, entry points a_apply_f32/a_apply_f64) replaces
    `multiphase_pallas_apply_inkernel_halo`: the full coupled A on stacked
    (5, n, n) state.
  * `a_apply_band` (K3, entry points a_apply_band_f32/_f64) replaces
    `build_fused_tile_call`: A on a row band of n_loc rows whose +-h halo
    rows arrive already extended, (5, n_loc+2h, n) -> (5, n_loc, n). Rows
    never wrap inside the band (the halo rows may be a neighbour's rows);
    columns wrap, since full rows are present.
  * `a_apply_staged` (K4, entry points a_apply_staged_f32/_f64) replaces
    `multiphase_pallas_apply_pipelined`: K2's function, computed by
    persistent CTAs from 2-D tiles whose (TR+2) x (TC+2) footprints are
    double-buffered in shared memory with cp.async: a CTA issues the next
    tile's reads before it computes the current tile.
All four run `models/fused.velocity_block_math` / `multiphase_apply_math`
term for term, in flux form, from the theta_n cell plane and the two
pointwise face planes; every other coefficient is recomputed in registers.
In `csrc/fused_stencil.cu` that arithmetic is one template over a thread's
3 x (P+2) register windows, so K1-K4 differ at most by FMA contraction.

What bounds them: HBM bytes. K1 reads 7 planes (3 theta + 4 state) and
writes 4; K2-K4 read 8 and write 5. At ~190-250 operations per point
against 88 (K1, f64) to 104 (K2, f64) bytes per point, all sit far below
the card's flop/byte balance. The design answers that the way the TPU
kernels did: one pass, no coefficient planes streamed, each output written
once. K1, K2 and K3 are one kernel body over 4 or 5 planes and a row map
(K1/K2 the periodic grid, K3 the band's extended rows): a thread takes P
points of a row (K1 2; K2 and K3 2 in f32, 1 in f64, where 2 points cost
158 registers), wraps its rows and columns once (no integer modulo per
read) and reads each plane as a 3 x (P+2) register window, two points' own
columns by one 8- or 16-byte load. K4 stages each tile's footprint with its
first column on a 16-byte boundary (`staged_row_stride`), so the tile's
columns copy by 16-byte cp.async and only the two halo columns and the
grid's edge tiles wrap, and computes from register windows read out of the
slot, at K2's points a thread. The TPU's fixed 8-row halo, predicated wrap
DMAs and VMEM row blocks existed for Mosaic's alignment rules: K1/K2 wrap
once per thread, K3 takes any h >= 1, and K4 tiles in 2-D because one full
f64 row of 6 planes at n=2048 is 98 KB.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise. `LAUNCHES` counts kernel launches only.
"""

from __future__ import annotations

import torch

from mpbp_tpu_torch.models.fused import (multiphase_apply_math,
                                         velocity_block_math)
from mpbp_tpu_torch.ops import _build
from mpbp_tpu_torch.ops.stencil import shift

LAUNCHES = _build.Launches(f_apply=0, a_apply=0, a_apply_band=0,
                          a_apply_staged=0)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# K4's default (rows, cols) output tile, per CTA of 512 threads: two slots
# of the 6-plane footprint (`staged_smem_bytes`: 117,504 bytes f32, 228,096
# f64), the fastest tile at n=512 on the H100 in f32 and in f64
STAGED_TILE = (16, 128)
# shared memory one block may opt in to on Hopper (232,448 bytes)
_SMEM_OPTIN_MAX = 227 * 1024


def f_apply_reference(tn, wnx, wny, x, params: dict, dx: float,
                      dy: float) -> torch.Tensor:
    """Plain PyTorch K1: F applied to stacked (4, n, n) state."""
    return torch.stack(velocity_block_math(
        shift, tn, wnx, wny, x[0], x[1], x[2], x[3], params, dx, dy))


def a_apply_reference(tn, wnx, wny, x, params: dict, dx: float,
                      dy: float) -> torch.Tensor:
    """Plain PyTorch K2 (and K4, which computes the same function): A
    applied to stacked (5, n, n) state."""
    return torch.stack(multiphase_apply_math(
        shift, tn, wnx, wny, x[0], x[1], x[2], x[3], x[4], params, dx, dy))


def band_shift(h: int, n_loc: int):
    """The shift on (n_loc+2h, n) extended planes: rows by slicing (no row
    wrap), columns by a periodic roll (`_tile_shift` of
    mpbp_tpu/ops/pallas_stencil.py, with any h)."""

    def sh(x, dr, dc):
        sl = x[h + dr:h + dr + n_loc, :]
        return torch.roll(sl, -dc, dims=1) if dc else sl

    return sh


def a_apply_band_reference(tn_ext, wnx, wny, x_ext, params: dict, dx: float,
                           dy: float, h: int) -> torch.Tensor:
    """Plain PyTorch K3: A on a band, (5, n_loc+2h, n) -> (5, n_loc, n)."""
    sh = band_shift(h, wnx.shape[0])
    return torch.stack(multiphase_apply_math(
        sh, tn_ext, wnx, wny, x_ext[0], x_ext[1], x_ext[2], x_ext[3],
        x_ext[4], params, dx, dy))


def f_apply(tn, wnx, wny, x, params: dict, dx: float,
            dy: float) -> torch.Tensor:
    """K1: (4, n, n) -> (4, n, n). Kernel on CUDA, plain version on CPU."""
    _check(4, tn, wnx, wny, x)
    return _dispatch("f_apply", f_apply_reference, (tn, wnx, wny, x),
                     params, dx, dy, (x.shape[1],), x.shape)


def a_apply(tn, wnx, wny, x, params: dict, dx: float,
            dy: float) -> torch.Tensor:
    """K2: (5, n, n) -> (5, n, n). Kernel on CUDA, plain version on CPU."""
    _check(5, tn, wnx, wny, x)
    return _dispatch("a_apply", a_apply_reference, (tn, wnx, wny, x),
                     params, dx, dy, (x.shape[1],), x.shape)


def a_apply_band(tn_ext, wnx, wny, x_ext, params: dict, dx: float,
                 dy: float, h: int) -> torch.Tensor:
    """K3: A on a row band, (5, n_loc+2h, n) -> (5, n_loc, n), with
    tn_ext (n_loc+2h, n) and wnx/wny (n_loc, n). Band row r reads extended
    rows r+h-1 .. r+h+1. Kernel on CUDA, plain version on CPU."""
    if isinstance(h, bool) or not isinstance(h, int) or h < 1:
        raise ValueError(f"halo h must be an int >= 1, got {h!r}")
    if x_ext.dim() != 3 or x_ext.shape[0] != 5:
        raise ValueError(f"state must be (5, n_loc+2h, n), got "
                         f"{tuple(x_ext.shape)}")
    n_loc, n = x_ext.shape[1] - 2 * h, x_ext.shape[2]
    if n_loc < 1 or n < 1:
        raise ValueError(f"state {tuple(x_ext.shape)} holds no band with "
                         f"h={h}")
    _check_planes(x_ext, (("tn_ext", tn_ext, (n_loc + 2 * h, n)),
                          ("wnx", wnx, (n_loc, n)), ("wny", wny, (n_loc, n))))
    return _dispatch(
        "a_apply_band",
        lambda *a: a_apply_band_reference(*a, h), (tn_ext, wnx, wny, x_ext),
        params, dx, dy, (n_loc, n, h), (5, n_loc, n))


def staged_row_stride(tc: int, dtype: torch.dtype) -> int:
    """Elements a footprint row of K4's shared memory takes for a tile of
    `tc` columns: 16 bytes' worth of elements (the lead) before the tile's
    first column, so it sits on a 16-byte boundary, then the tile's columns
    and a second lead that holds the right halo column and keeps the next
    row aligned (`StagedLayout` in csrc/fused_stencil.cu)."""
    return tc + 2 * (16 // dtype.itemsize)


def staged_smem_bytes(tile, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one K4 CTA: two slots, each (rows+2)
    footprint rows of the 6 staged planes."""
    tr, tc = tile
    return 2 * 6 * (tr + 2) * staged_row_stride(tc, dtype) * dtype.itemsize


def check_tile(tile, dtype: torch.dtype) -> tuple[int, int]:
    """K4's (rows, cols) output tile, validated (None: `STAGED_TILE`):
    cols a multiple of 32 (whole 16-byte copies and whole warps a footprint
    row), and `staged_smem_bytes` within the shared memory one block may
    use."""
    if dtype not in _SUFFIX:
        raise TypeError(f"dtype {dtype} not supported (float32/float64)")
    if tile is None:
        return STAGED_TILE
    try:
        tr, tc = (int(v) for v in tile)
    except (TypeError, ValueError):
        raise ValueError(f"tile must be (rows, cols), got {tile!r}") from None
    if tr < 1 or tc < 32 or tc % 32:
        raise ValueError(f"tile {tile!r}: rows >= 1 and cols a positive "
                         "multiple of 32")
    smem = staged_smem_bytes((tr, tc), dtype)
    if smem > _SMEM_OPTIN_MAX:
        raise ValueError(f"tile {tile!r} needs {smem} B of shared memory in "
                         f"{dtype}; at most {_SMEM_OPTIN_MAX}")
    return tr, tc


def a_apply_staged(tn, wnx, wny, x, params: dict, dx: float, dy: float,
                   tile=None) -> torch.Tensor:
    """K4: K2's (5, n, n) -> (5, n, n) from double-buffered shared-memory
    tiles of shape `tile` (default: STAGED_TILE). Kernel on
    CUDA, plain version (K2's) on CPU."""
    _check(5, tn, wnx, wny, x)
    tr, tc = check_tile(tile, x.dtype)
    return _dispatch("a_apply_staged", a_apply_reference, (tn, wnx, wny, x),
                     params, dx, dy, (x.shape[1], tr, tc), x.shape)


def _check(nf: int, tn, wnx, wny, x) -> None:
    if x.dim() != 3 or x.shape[0] != nf or x.shape[1] != x.shape[2]:
        raise ValueError(f"state must be ({nf}, n, n), got {tuple(x.shape)}")
    n = x.shape[1]
    if n < 1:
        raise ValueError("empty grid")
    _check_planes(x, (("tn", tn, (n, n)), ("wnx", wnx, (n, n)),
                      ("wny", wny, (n, n))))


def _check_planes(x, planes) -> None:
    """x's dtype is a kernel's; each (name, plane, shape) matches it in
    shape, dtype and device; all are contiguous."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"dtype {x.dtype} not supported (float32/float64)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, t, shape in planes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, state is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, state on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dispatch(name, reference, tensors, params, dx, dy, ints, out_shape):
    """The plain version on a CPU tensor; on a CUDA tensor one launch of
    entry point `<name>_<f32|f64>` with (tensors..., out, ints..., the 9
    scalars) and a count."""
    x = tensors[-1]
    if x.device.type == "cpu":
        return reference(*tensors, params, dx, dy)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _build.launch("fused_stencil", f"{name}_{_SUFFIX[x.dtype]}", x.device,
                  *(t.data_ptr() for t in tensors), out.data_ptr(), *ints,
                  float(params["c"]), float(params["d"]), float(params["xi"]),
                  float(params["eta_n"]), float(params["eta_s"]),
                  float(params.get("d_p", 1.0)),
                  float(params.get("d_div", -1.0)), float(dx), float(dy))
    LAUNCHES.add(name)
    return out
