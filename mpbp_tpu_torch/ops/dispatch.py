"""Kernel dispatch for general sparse matvecs (port of
`mpbp_tpu/ops/dispatch.py`).

`best_spmv` picks a kernel for a CSR matrix by structure, once, on the
host:
  "dia" - K5/K6 (`ops/cuda_dia.py`) when few diagonals carry the matrix;
  "ell" - K7 (`ops/cuda_ell.py`) on the matrix's compressed rows
          otherwise (factors with fill, unstructured rows).
The JAX package's TPU gates do not come across: N % 128 (the lane
layout), the VMEM budgets, and the resident/"dia_streamed" split (x outgrew
VMEM; the card reads x through L2, so one DIA kernel serves any N). On a
CUDA matrix `best_spmv` never returns a plain path: a matrix the kernels
cannot take raises. On a CPU matrix the same paths run their kernels'
plain versions.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.ops.cuda_ell import CompressedRows
from mpbp_tpu_torch.ops.dia import DIAMatrix
from mpbp_tpu_torch.ops.sparse import CSRMatrix

# DIA is worthwhile while the diagonal payload K*N stays within ~3x the nnz
# (zero-padded diagonals stream dead bytes); beyond that ELL is denser.
_DIA_PAD_RATIO = 3.0
_MAX_DIA = 96


def best_spmv(csr: CSRMatrix, dtype: torch.dtype = torch.float32
              ) -> tuple[Callable, str]:
    """Return (matvec, path_name) for a CSR matrix, with the matrix cast
    to `dtype` (float32 or float64); path_name is "dia" or "ell"."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"best_spmv: no kernel for dtype {dtype}")
    nrows, ncols = csr.shape
    if max(nrows, ncols) >= 2 ** 31:
        raise ValueError(f"best_spmv: shape {csr.shape} exceeds the "
                         "kernels' int32 columns")
    csr_c = CSRMatrix(csr.shape, csr.indptr, csr.indices,
                      csr.vals.to(dtype))
    if nrows == ncols:
        indptr, indices, _ = csr.host_arrays()
        rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(indptr))
        K = len(np.unique((indices.astype(np.int64) - rows) % ncols))
        if K <= _MAX_DIA and K * nrows <= _DIA_PAD_RATIO * csr.nnz:
            return DIAMatrix.from_csr(csr_c, periodic=True).matvec, "dia"
    return CompressedRows.from_arrays(csr.shape, *csr.host_arrays(), dtype,
                                      device=csr.vals.device).matvec, "ell"
