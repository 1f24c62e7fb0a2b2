"""Fused multiphase operator apply: recompute coefficients, don't stream them
(port of `mpbp_tpu/models/fused.py`).

Every coefficient of the multiphase system derives from ONE cell-centred
theta plane by 2-/4-point averages, plus two pointwise face planes for the
mass term. Recomputing those averages in registers turns the apply into an
8-plane-in / 5-plane-out bandwidth problem.

The arithmetic is written once, in `multiphase_apply_math` and
`velocity_block_math`, against an abstract shift `sh(plane, dr, dc)`. The
plain PyTorch versions in `ops/cuda_stencil.py` run it with the periodic
roll; the CUDA kernels in `csrc/fused_stencil.cu` compute the same
expressions term for term at one grid point per thread. The `make_*`
functions here route through the kernel wrappers; `make_fused_apply_kernel`
picks one of the three A-apply kernels (K2, K3 on the row-extended state,
K4), and `make_f_apply_stacked` on a mesh is K3 on a rank's row band.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpbp_tpu_torch.models.multiphase import MultiphaseOperator


def _phase_momentum(sh, T, u, v, p, dx, dy, d_p):
    """Viscous Laplacian + weighted pressure gradient for one phase, from the
    cell theta plane T alone. Returns (Lu, Lv, Gx, Gy)."""
    ix2, iy2, ixy = 1 / dx**2, 1 / dy**2, 1 / (dx * dy)
    idx, idy = 1 / dx, 1 / dy

    T0 = sh(T, 0, 0)
    Tw = sh(T, 0, -1)
    Tu_ = sh(T, -1, 0)
    # node-averaged theta and its needed shifts, rebuilt from T's shifts
    tn = 0.25 * (T0 + Tw + Tu_ + sh(T, -1, -1))
    tnS = 0.25 * (sh(T, 1, 0) + sh(T, 1, -1) + T0 + Tw)
    tnE = 0.25 * (sh(T, 0, 1) + T0 + sh(T, -1, 1) + Tu_)
    tx = 0.5 * (T0 + Tw)
    ty = 0.5 * (T0 + Tu_)

    u0, uE, uW = sh(u, 0, 0), sh(u, 0, 1), sh(u, 0, -1)
    uN, uS, uNE = sh(u, -1, 0), sh(u, 1, 0), sh(u, -1, 1)
    v0, vE, vW = sh(v, 0, 0), sh(v, 0, 1), sh(v, 0, -1)
    vN, vS, vSW = sh(v, -1, 0), sh(v, 1, 0), sh(v, 1, -1)

    # u-momentum row (x-face)
    Lu = (ix2 * (T0 * (uE - u0) - Tw * (u0 - uW))
          + iy2 * (tn * (uN - u0) - tnS * (u0 - uS))
          + ixy * (tn * (v0 - vW) - T0 * (v0 - vS)
                   + Tw * (vW - vSW) - tnS * (vS - vSW)))

    # v-momentum row (y-face)
    Lv = (iy2 * (Tu_ * (vN - v0) - T0 * (v0 - vS))
          + ix2 * (tnE * (vE - v0) - tn * (v0 - vW))
          + ixy * ((tn - T0) * u0 + (T0 - tnE) * uE
                   + (Tu_ - tn) * uN + (tnE - Tu_) * uNE))

    if p is None:
        return Lu, Lv, 0.0, 0.0
    p0, pW, pN = sh(p, 0, 0), sh(p, 0, -1), sh(p, -1, 0)
    Gx = d_p * idx * tx * (p0 - pW)
    Gy = d_p * idy * ty * (pN - p0)
    return Lu, Lv, Gx, Gy


def _phase_divergence(sh, T, u, v, dx, dy):
    """Weighted divergence at cells from the cell theta plane."""
    T0 = sh(T, 0, 0)
    tx = 0.5 * (T0 + sh(T, 0, -1))
    ty = 0.5 * (T0 + sh(T, -1, 0))
    txE = 0.5 * (sh(T, 0, 1) + T0)
    tyS = 0.5 * (T0 + sh(T, 1, 0))
    return ((txE * sh(u, 0, 1) - tx * sh(u, 0, 0)) / dx
            + (ty * sh(v, 0, 0) - tyS * sh(v, 1, 0)) / dy)


def velocity_block_math(sh, Tn, Wnx, Wny, un, vn, us, vs,
                        params: dict, dx: float, dy: float, pr=None):
    """Flux-form velocity-block (F) apply from theta planes under an
    abstract shift; with pr given, the weighted pressure gradient is
    included (the momentum part of the full A-apply).

    The flux form (differences first, then scale) keeps F's near-kernel
    evaluable in f32; the assembled coefficient-plane apply has 26%
    relative error on a constant field at n=128 (measured in the JAX
    package), which would floor every f32 inner F-solve."""
    c, d, xi = params["c"], params["d"], params["xi"]
    eta_n, eta_s = params["eta_n"], params["eta_s"]
    d_p = params.get("d_p", 1.0)

    Tn0 = sh(Tn, 0, 0)
    Ts = 1.0 - Tn  # full plane: shifts of Ts are 1 - shifts of Tn
    Wsx, Wsy = 1.0 - Wnx, 1.0 - Wny

    # drag diagonal xi*t*(1-t) from face-averaged theta (phase-symmetric)
    txn = 0.5 * (Tn0 + sh(Tn, 0, -1))
    tyn = 0.5 * (Tn0 + sh(Tn, -1, 0))
    XIx = xi * txn * (1.0 - txn)
    XIy = xi * tyn * (1.0 - tyn)

    Lun, Lvn, Gxn, Gyn = _phase_momentum(sh, Tn, un, vn, pr, dx, dy, d_p)
    Lus, Lvs, Gxs, Gys = _phase_momentum(sh, Ts, us, vs, pr, dx, dy, d_p)

    un0, vn0 = sh(un, 0, 0), sh(vn, 0, 0)
    us0, vs0 = sh(us, 0, 0), sh(vs, 0, 0)

    out_un = (c * Wnx * un0 - d * XIx * un0 + d * XIx * us0
              + d * eta_n * Lun + Gxn)
    out_vn = (c * Wny * vn0 - d * XIy * vn0 + d * XIy * vs0
              + d * eta_n * Lvn + Gyn)
    out_us = (c * Wsx * us0 - d * XIx * us0 + d * XIx * un0
              + d * eta_s * Lus + Gxs)
    out_vs = (c * Wsy * vs0 - d * XIy * vs0 + d * XIy * vn0
              + d * eta_s * Lvs + Gys)
    return out_un, out_vn, out_us, out_vs


def multiphase_apply_math(sh, Tn, Wnx, Wny, un, vn, us, vs, pr,
                          params: dict, dx: float, dy: float):
    """Complete A-apply from (theta planes, state planes) under an abstract
    shift. Wnx/Wny are pointwise face-theta planes, used at zero offset
    only."""
    d_div = params["d_div"]
    out_un, out_vn, out_us, out_vs = velocity_block_math(
        sh, Tn, Wnx, Wny, un, vn, us, vs, params, dx, dy, pr=pr)
    Ts = 1.0 - Tn
    div = (_phase_divergence(sh, Tn, un, vn, dx, dy)
           + _phase_divergence(sh, Ts, us, vs, dx, dy))
    out_p = d_div * div
    return out_un, out_vn, out_us, out_vs, out_p


def make_fused_apply(op: MultiphaseOperator) -> Callable:
    """Fused A matvec on stacked (5, n, n) tensors through kernel K2
    (`ops.cuda_stencil.a_apply`), reading only theta planes + state."""
    from mpbp_tpu_torch.ops.cuda_stencil import a_apply

    params = dict(op.params)
    dx, dy = op.grid.dx, op.grid.dy
    Tn = op.phase_n.cell
    Wnx, Wny = op.phase_n.xface_pt, op.phase_n.yface_pt

    def mv(vec: torch.Tensor) -> torch.Tensor:
        return a_apply(Tn, Wnx, Wny, vec, params, dx, dy)

    return mv


def _extend_rows(x: torch.Tensor, H: int) -> torch.Tensor:
    """Append periodic wrap rows: (..., n, n) -> (..., n+2H, n)."""
    return torch.cat([x[..., -H:, :], x, x[..., :H, :]], dim=-2)


# the row halo of the `extend` A-apply: the stencil's radius
_EXTEND_H = 1


def make_fused_apply_kernel(op: MultiphaseOperator, halo: str = "inkernel",
                            tile=None) -> Callable:
    """The fused A matvec on stacked (5, n, n) tensors through one of the
    three hand-written A-apply kernels (JAX counterpart:
    `mpbp_tpu.models.fused.make_fused_apply_pallas`):

      'inkernel'  - kernel K2 (`ops.cuda_stencil.a_apply`), periodic reads
                    in the kernel; the same matvec as `make_fused_apply`;
      'extend'    - the periodic wrap rows appended by `torch.cat` before
                    each call (the TPU path's pre-pass, an extra copy of
                    the state per matvec, kept to measure what that copy
                    costs), then kernel K3 (`a_apply_band`: K2's register
                    windows on the extended rows, no row wrap) on the band
                    of all n rows;
      'pipelined' - kernel K4 (`a_apply_staged`): persistent CTAs over 2-D
                    tiles whose footprints are double-buffered in shared
                    memory by 16-byte cp.async, computed from register
                    windows read out of the slot; `tile` = (rows, cols), or
                    None for `ops.cuda_stencil.STAGED_TILE`.

    The TPU's `block_rows` (and its VMEM budget) has no counterpart: only K4
    takes a tile, and K2/K3 refuse one."""
    from mpbp_tpu_torch.ops.cuda_stencil import (a_apply_band,
                                                 a_apply_staged, check_tile)

    if halo not in ("inkernel", "extend", "pipelined"):
        raise ValueError(f"unknown halo {halo!r} "
                         "(inkernel | extend | pipelined)")
    if tile is not None and halo != "pipelined":
        raise ValueError(f"halo={halo!r} takes no tile; only 'pipelined' "
                         "(kernel K4) is tiled")
    if halo == "inkernel":
        return make_fused_apply(op)
    params = dict(op.params)
    dx, dy = op.grid.dx, op.grid.dy
    Tn = op.phase_n.cell
    Wnx, Wny = op.phase_n.xface_pt, op.phase_n.yface_pt

    if halo == "extend":
        H = _EXTEND_H
        Tn_ext = _extend_rows(Tn, H)                # static, built once

        def mv(vec: torch.Tensor) -> torch.Tensor:
            return a_apply_band(Tn_ext, Wnx, Wny, _extend_rows(vec, H),
                                params, dx, dy, H)
    else:
        tile = check_tile(tile, Tn.dtype)

        def mv(vec: torch.Tensor) -> torch.Tensor:
            return a_apply_staged(Tn, Wnx, Wny, vec, params, dx, dy, tile)

    return mv


def make_f_apply(op: MultiphaseOperator) -> Callable:
    """Flux-form matvec for the velocity block F on flat (4 n^2,) vectors,
    through kernel K1 (`ops.cuda_stencil.f_apply`).

    Numerically NOT interchangeable with op.F.apply in f32 (see
    velocity_block_math). This is the inner-solve matvec of the
    preconditioners."""
    return _flat_f(make_f_apply_planes(
        op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt,
        op.params, op.grid.dx, op.grid.dy), op.grid.n)


def make_f_apply_stacked(op: MultiphaseOperator, mesh=None,
                         axis: str = "x") -> Callable:
    """Flux-form F matvec on stacked (4, n, n) velocity tensors, the form
    the sharded path keeps its vectors in. Without a mesh it is kernel K1
    on the whole grid; on a mesh it takes this rank's band (4, n_loc, n)
    and is kernel K3 on the halo-extended band with a zero pressure plane
    (`parallel/pallas_sharded.make_band_apply`)."""
    planes = (op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt,
              op.params, op.grid.dx, op.grid.dy)
    if mesh is None:
        return make_f_apply_planes(*planes)
    from mpbp_tpu_torch.parallel.halo import Ring
    from mpbp_tpu_torch.parallel.pallas_sharded import make_band_apply

    return make_band_apply(*planes, Ring.of(mesh, axis), fields=4)


def _flat_f(stacked_apply: Callable, n: int) -> Callable:
    def mv(vu: torch.Tensor) -> torch.Tensor:
        return stacked_apply(vu.reshape(4, n, n)).reshape(vu.shape)

    return mv


def make_f_apply_planes(Tn, Wnx, Wny, params: dict, dx: float,
                        dy: float) -> Callable:
    """Flux-form F apply on stacked (4, n, n) velocity tensors from explicit
    theta planes, through kernel K1: the per-level matvec/residual of the
    velocity multigrid hierarchy (each level has its own restricted theta).
    The JAX counterpart takes field dicts; the port keeps the four velocity
    fields stacked, which is the kernel's layout."""
    from mpbp_tpu_torch.ops.cuda_stencil import f_apply

    params = dict(params)

    def apply(x: torch.Tensor) -> torch.Tensor:
        return f_apply(Tn, Wnx, Wny, x, params, dx, dy)

    return apply
