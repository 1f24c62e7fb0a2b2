"""Distributed generic SpMV: the row-band DIA matvec (port of
`mpbp_tpu/parallel/sharded_dia.py`).

`parallel/halo.py` distributes the structured stencil apply; this is the
generic-sparse counterpart. The matrix payload `data` (K, N), the dominant
memory, is split by row band over the mesh axis, and so is x. Two
communication regimes, fixed by the offsets when the matvec is built:

* banded (max |signed offset| <= the band's rows): the halo segments come
  from the two ring neighbours (`halo.Ring.post_halo`), and every diagonal
  is a fixed slice of the extended band;
* global (offsets couple distant bands, e.g. the 5-field saddle-point A,
  whose u<->p couplings sit ~n^2..4n^2 away): x is all-gathered (N values,
  small next to the K*N payload) and each diagonal read from one slice of
  the doubled vector.

Both compute y[i] = sum_k data[k, i] * x[(i + off_k) mod N], as
`ops/dia.DIAMatrix.matvec` on square periodic matrices. Like the JAX
module, this is plain arithmetic, not a kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpbp_tpu_torch.ops.dia import DIAMatrix
from mpbp_tpu_torch.parallel.halo import Axis, Ring


def _signed_offsets(offsets, N: int) -> list[int]:
    """Normalize periodic offsets to the symmetric range [-N/2, N/2)."""
    return [((int(o) + N // 2) % N) - N // 2 for o in offsets]


def shard_dia(A: DIAMatrix, mesh, axis: Axis = "x") -> DIAMatrix:
    """This rank's band of the diagonal payload: data (K, N/P) under the
    global shape (N, N)."""
    return DIAMatrix(A.shape, A.offsets,
                     Ring.of(mesh, axis).band(A.data, dim=-1))


def sharded_dia_matvec(A: DIAMatrix, mesh, axis: Axis = "x") -> Callable:
    """mv(x) -> y for x and y this rank's band of N/P entries. `A` is the
    whole matrix or its band (`shard_dia`): data (K, N) or (K, N/P)."""
    N, ncols = A.shape
    if N != ncols:
        raise ValueError("sharded DIA matvec requires a square matrix")
    ring = Ring.of(mesh, axis)
    L = ring.rows(N)
    data = A.data if A.data.shape[1] == L else ring.band(A.data, dim=-1)
    soffs = _signed_offsets(A.offsets, N)
    halo_lo = max((-s for s in soffs if s < 0), default=0)
    halo_hi = max((s for s in soffs if s > 0), default=0)

    if halo_lo <= L and halo_hi <= L:
        def mv(x: torch.Tensor) -> torch.Tensor:
            before, after = ring.post_halo(x, halo_lo, halo_hi,
                                           dim=0).wait()
            ext = torch.cat([before, x, after])
            acc = None
            for k, s in enumerate(soffs):
                contrib = data[k] * ext[halo_lo + s:halo_lo + s + L]
                acc = contrib if acc is None else acc + contrib
            return acc
        return mv

    base = ring.index * L

    def mv_global(x: torch.Tensor) -> torch.Tensor:
        xg = ring.gather(x, dim=0)
        x2 = torch.cat([xg, xg])
        acc = None
        for k, off in enumerate(A.offsets):
            start = base + int(off) % N
            contrib = data[k] * x2[start:start + L]
            acc = contrib if acc is None else acc + contrib
        return acc

    return mv_global
