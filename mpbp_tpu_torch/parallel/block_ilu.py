"""Sharded incomplete-factorization inner solves: block-Jacobi ILU(0)
(port of `mpbp_tpu/parallel/block_ilu.py`).

Each rank owns a contiguous band of grid rows and factors ONLY the
diagonal block of the operator restricted to its band: the couplings to
other bands are dropped (the classical block-Jacobi / additive-Schwarz
preconditioner). The apply is then one pair of triangular solves a rank
with no communication. Under a flexible outer Krylov method the dropped
couplings only shift iteration counts.

The band-restricted stencil pattern is shift-invariant (dropping the
periodic wrap makes the first and last bands look like the others), so
every rank's factor has the same pattern. The JAX package relies on that
to stack the factors into one `shard_map`; here each rank simply holds its
own factor (`ops/ilu.ILUPreconditioner.ilu0`, the exact level apply).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from mpbp_tpu_torch.ops.ilu import ILUPreconditioner
from mpbp_tpu_torch.ops.sparse import CSRMatrix
from mpbp_tpu_torch.ops.stencil import StencilOperator
from mpbp_tpu_torch.parallel.halo import Ring


def local_block_csr(op: StencilOperator, s: int, n_shards: int,
                    drop_tol: float = 1e-14) -> CSRMatrix:
    """The diagonal block of `op` restricted to band s's grid rows, in
    field-major local ordering idx = f*(nl*n) + r_local*n + c, on the
    operator's device (built on the host in numpy, as the JAX package
    builds it).

    Entries whose column row falls outside the band (periodic wraps
    included) are dropped: the block-Jacobi approximation. Entries at or
    below `drop_tol` are pruned as in `StencilOperator.to_csr`, so one band
    gives the full operator's ILU(0) pattern."""
    if op.out_fields != op.in_fields:
        raise ValueError("square operator required")
    fields: Sequence[str] = op.out_fields
    nr, nc = op.shape_grid
    if nr % n_shards:
        raise ValueError(f"{nr} rows do not split into {n_shards} bands")
    nl = nr // n_shards
    r0 = s * nl
    fidx = {f: i for i, f in enumerate(fields)}

    rows_out, cols_out, vals_out = [], [], []
    R, C = np.meshgrid(np.arange(nl), np.arange(nc), indexing="ij")
    for (of, inf), offmap in op.terms.items():
        fo, fi = fidx[of], fidx[inf]
        for (dr, dc), coef in offmap.items():
            coef_np = np.broadcast_to(coef.detach().cpu().numpy(),
                                      (nr, nc))[r0:r0 + nl, :]
            rg = (r0 + R + dr) % nr                       # wrapped row
            keep = (rg >= r0) & (rg < r0 + nl)
            if not keep.any():
                continue
            keep &= np.abs(coef_np) > drop_tol
            rows = fo * (nl * nc) + R * nc + C
            cols = fi * (nl * nc) + (rg - r0) * nc + (C + dc) % nc
            rows_out.append(rows[keep])
            cols_out.append(cols[keep])
            vals_out.append(coef_np[keep])
    N = len(fields) * nl * nc
    return CSRMatrix.from_coo(N, N, np.concatenate(rows_out),
                              np.concatenate(cols_out),
                              np.concatenate(vals_out), device=op.device)


@dataclasses.dataclass(eq=False)
class BlockJacobiILU:
    """This rank's ILU(0) factor of its band's diagonal block. Callable on
    the rank's band of a stacked vector, (n_fields, n_loc, n), returning the
    same shape; `.flat` (the same call) takes the flat band."""

    fields: tuple
    n: int                      # global grid rows
    nl: int                     # rows a band
    factor: ILUPreconditioner

    @classmethod
    def of(cls, op: StencilOperator, mesh, axis: str = "x",
           dtype=torch.float64) -> "BlockJacobiILU":
        """Factor this rank's band-diagonal block of `op`."""
        ring = Ring.of(mesh, axis)
        nr = op.shape_grid[0]
        csr = local_block_csr(op, ring.index, ring.size)
        return cls(tuple(op.out_fields), nr, ring.rows(nr),
                   ILUPreconditioner.ilu0(csr, dtype=dtype))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        """v: (n_fields, n_loc, n), or the same band flat, [f0 (n_loc n),
        f1 (n_loc n), ...] -> M^-1 v in v's shape, with no
        communication."""
        return self.factor.solve(v.reshape(-1)).reshape(v.shape)

    flat = __call__
