"""Each rank's A-apply on its row band through kernel K3 (port of
`mpbp_tpu/parallel/pallas_sharded.py`, the multi-chip form of the fused
apply).

Per matvec, each rank sends its edge rows to both ring neighbours (one
transfer a direction, all fields batched: `halo.Ring.post_halo`), lays
them around its band, and runs ONE K3 launch (`ops/cuda_stencil.
a_apply_band`) on the extended band. Theta never moves at solve time: the
band's theta plane with its +-1 neighbour rows is cut once at setup.

The band F-apply (`make_band_apply(..., fields=4)`, behind
`models/fused.make_f_apply_stacked` on a mesh) is the same K3 launch with
a zero pressure plane: A's velocity rows at p = 0 are F u. The extended
buffer, whose pressure plane stays zero, is allocated once per apply.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpbp_tpu_torch.models.multiphase import MultiphaseOperator
from mpbp_tpu_torch.ops.cuda_stencil import a_apply_band
from mpbp_tpu_torch.parallel.halo import Axis, Ring, axis_size

# the stencil's row radius: the halo K3 is given
_H = 1


def pallas_sharded_supported(op: MultiphaseOperator, mesh,
                             axis: Axis = "x") -> bool:
    """K3's condition: the grid's rows split evenly over the axis, at
    least one row a rank. (The TPU kernel's gate, whole 8-row sublane
    tiles a device, has no counterpart: K3 takes any band.)"""
    n = op.grid.n
    nd = axis_size(mesh, axis)
    return n % nd == 0 and n // nd >= 1


def make_band_apply(Tn: torch.Tensor, Wnx: torch.Tensor, Wny: torch.Tensor,
                    params: dict, dx: float, dy: float, ring: Ring,
                    fields: int = 5) -> Callable:
    """mv(v) on this rank's band of stacked (fields, n_loc, n) state, from
    the replicated theta planes of one grid: the halo exchange, then one K3
    launch. fields=5 is A; fields=4 is F (K3 at p = 0)."""
    n = Tn.shape[0]
    nl = ring.rows(n)
    H = _H
    tn_ext = ring.band_ext(Tn, H)
    wnx, wny = ring.band(Wnx), ring.band(Wny)
    params = dict(params)
    ext = Tn.new_zeros((5, nl + 2 * H, n))

    def mv(v: torch.Tensor) -> torch.Tensor:
        top, bot = ring.post_halo(v, H).wait()
        ext[:fields, :H] = top
        ext[:fields, H:H + nl] = v
        ext[:fields, H + nl:] = bot
        out = a_apply_band(tn_ext, wnx, wny, ext, params, dx, dy, H)
        return out if fields == 5 else out[:fields]

    return mv


def make_fused_apply_pallas_sharded(op: MultiphaseOperator, mesh,
                                    axis: Axis = "x") -> Callable:
    """`mv(v)` on this rank's band (5, n_loc, n) of stacked state: the
    halo exchange and one K3 launch (the TPU's `interpret` and
    `block_rows` have no counterpart)."""
    if not pallas_sharded_supported(op, mesh, axis):
        raise ValueError(f"n={op.grid.n} does not split over the mesh axis "
                         f"{axis!r}")
    return make_band_apply(op.phase_n.cell, op.phase_n.xface_pt,
                           op.phase_n.yface_pt, op.params, op.grid.dx,
                           op.grid.dy, Ring.of(mesh, axis))
