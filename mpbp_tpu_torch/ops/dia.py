"""DIA (diagonal-offset) sparse format (port of `mpbp_tpu/ops/dia.py`).

Stencil-born matrices have all nonzeros on O(1) fixed diagonals, the flat
index offsets of their stencil taps. Stored by diagonal, SpMV needs no
column indices: `matvec` is kernel K5/K6 (`ops/cuda_dia.py`) on a CUDA
tensor, on the matrix's row tiles (`tiles`), and its `torch.roll` form on
a CPU tensor.

Convention: data[k, i] = A[i, (i + offsets[k]) mod ncols]. Offsets are
col - row, taken mod ncols (periodic) or signed (non-periodic, which gives
negative offsets). For a rectangular matrix the product is
    y[i] = sum_k data[k, i] * (i < ncols ? x[(i + off_k) mod ncols] : 0),
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mpbp_tpu_torch.ops import cuda_dia


@dataclasses.dataclass(eq=False)
class DIAMatrix:
    shape: tuple[int, int]
    offsets: tuple[int, ...]
    data: torch.Tensor          # (n_diags, nrows)

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.data))

    @functools.cached_property
    def kernel_offsets(self) -> torch.Tensor:
        """The offsets normalised to [0, ncols), int64 on the data's
        device: the kernel's operand."""
        ncols = max(self.shape[1], 1)
        return torch.tensor([o % ncols for o in self.offsets],
                            dtype=torch.int64, device=self.data.device)

    @functools.cached_property
    def tiles(self) -> cuda_dia.DIATiles:
        """The row-tile layout the kernel runs on (`cuda_dia.dia_tiles`),
        built once on the data's device; the data must not change after."""
        return cuda_dia.dia_tiles(self)

    @classmethod
    def from_csr(cls, csr, periodic: bool = False) -> "DIAMatrix":
        """Convert a CSR matrix (on the CSR's device); offset = (col - row)
        mod ncols if periodic else col - row."""
        indptr, indices, vals = csr.host_arrays()
        nrows, ncols = csr.shape
        rows = np.repeat(np.arange(nrows), np.diff(indptr))
        offs = indices.astype(np.int64) - rows
        if periodic:
            offs = offs % ncols
        uniq = np.unique(offs)
        data = np.zeros((len(uniq), nrows), dtype=vals.dtype)
        np.add.at(data, (np.searchsorted(uniq, offs), rows), vals)
        return cls.from_numpy(csr.shape, uniq, data, device=csr.vals.device)

    @classmethod
    def from_numpy(cls, shape, offsets, data, *,
                   device: torch.device | str) -> "DIAMatrix":
        """From host arrays, e.g. the JAX package's DIAMatrix fields."""
        return cls((int(shape[0]), int(shape[1])),
                   tuple(int(o) for o in offsets),
                   torch.tensor(np.asarray(data), device=device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: kernel K5/K6 on CUDA, the roll form on CPU."""
        return cuda_dia.dia_spmv(self, x)

    def to_dense(self) -> np.ndarray:
        data = self.data.detach().cpu().numpy()
        d = np.zeros(self.shape, data.dtype)
        nrows, ncols = self.shape
        i = np.arange(nrows)
        for k, off in enumerate(self.offsets):
            np.add.at(d, (i, (i + off) % ncols), data[k])
        return d
