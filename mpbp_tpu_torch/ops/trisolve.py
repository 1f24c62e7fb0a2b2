"""Sparse triangular solves (port of `mpbp_tpu/ops/trisolve.py`).

* `LevelTriSolve` is the exact solve by wavefront level scheduling: rows
  are grouped into levels that depend only on earlier levels (the native
  C++ `level_schedule`), sorted by level and padded to one fixed width per
  level; the apply is a Python loop over levels, one gather, reduce and
  scatter each, in plain PyTorch (no TPU kernel exists for it). A level
  costs about six small launches, and the ILU factors of an n x n grid have
  O(n^2) levels, so on the card this apply is bound by launch overhead.
* `NeumannTriSolve` is the approximate solve by a fixed number of Jacobi
  (truncated Neumann) sweeps x <- D^-1 (b - S x): fully parallel, each
  sweep ONE launch of kernel K7 with its epilogue on the strict triangle's
  compressed rows, all of a solve's sweeps from one host call
  (`ops/cuda_ell.ell_sweeps`), in f32 and f64. The JAX package's TPU gate
  (f32 and n % 128 == 0 only) does not come across.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.native import level_schedule
from mpbp_tpu_torch.ops import cuda_ell
from mpbp_tpu_torch.ops.cuda_ell import CompressedRows


@dataclasses.dataclass(eq=False)
class LevelTriSolve:
    """Level-scheduled triangular solve plan. Rows are sorted by level and
    padded so each level occupies exactly `width` slots from
    level*width; padded slots carry row id n (a dummy row), value-0
    entries and a unit diagonal. L from ILUT has an implicit unit diagonal;
    U's diagonal is given separately in `diag`."""

    n: int
    n_levels: int
    width: int                 # max rows in any level
    rows_sorted: torch.Tensor  # (P,) int64, dummy = n
    cols: torch.Tensor         # (P, K) int64, padded 0
    vals: torch.Tensor         # (P, K), padded 0
    diag: torch.Tensor         # (P,), 1 for unit / padding

    @classmethod
    def from_csr(cls, indptr, indices, vals, is_upper: bool,
                 diag_vals=None, dtype: torch.dtype = torch.float64, *,
                 device: torch.device | str) -> "LevelTriSolve":
        """Build from a strictly-triangular CSR part (no diagonal) and an
        optional separate diagonal (None = unit diagonal)."""
        n = len(indptr) - 1
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int32)
        vals_np = np.asarray(vals, np.float64)

        levels, n_levels = level_schedule(indptr, indices, is_upper)
        n_levels = max(n_levels, 1)
        order = np.argsort(levels, kind="stable")
        counts = np.bincount(levels, minlength=n_levels)
        width = int(counts.max()) if n else 1
        K = max(int(np.diff(indptr).max()) if n else 1, 1)

        P = n_levels * width
        rows_sorted = np.full(P, n, np.int64)
        cols = np.zeros((P, K), np.int64)
        vmat = np.zeros((P, K), np.float64)
        diag = np.ones(P, np.float64)
        dv = (np.asarray(diag_vals, np.float64)
              if diag_vals is not None else np.ones(n))

        starts = np.zeros(n_levels + 1, np.int64)
        starts[1:] = np.cumsum(counts)
        lev_of_sorted = levels[order]
        slot = np.arange(n, dtype=np.int64) - starts[lev_of_sorted]
        pos = lev_of_sorted.astype(np.int64) * width + slot
        rows_sorted[pos] = order
        diag[pos] = dv[order]
        row_of_nnz = np.repeat(np.arange(n), np.diff(indptr))
        pos_of_row = np.empty(n, np.int64)
        pos_of_row[order] = pos
        local = np.arange(indptr[-1], dtype=np.int64) - np.repeat(
            indptr[:-1], np.diff(indptr))
        cols[pos_of_row[row_of_nnz], local] = indices
        vmat[pos_of_row[row_of_nnz], local] = vals_np

        def dev(a, dt=None):
            return torch.tensor(a, dtype=dt, device=device)

        return cls(n=n, n_levels=n_levels, width=width,
                   rows_sorted=dev(rows_sorted), cols=dev(cols),
                   vals=dev(vmat, dtype), diag=dev(diag, dtype))

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Solve T x = b. x carries a dummy slot n that the padded rows
        write and no entry reads (padded columns are 0 with value 0)."""
        n, W = self.n, self.width
        x = torch.zeros(n + 1, dtype=b.dtype, device=b.device)
        bx = b[torch.clamp(self.rows_sorted, max=max(n - 1, 0))]
        for lev in range(self.n_levels):
            s = slice(lev * W, (lev + 1) * W)
            acc = (self.vals[s] * x[self.cols[s]]).sum(1)
            x[self.rows_sorted[s]] = (bx[s] - acc) / self.diag[s]
        return x[:n]


def neumann_trisolve(strict: CompressedRows, diag: torch.Tensor,
                     b: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Approximate solve of (D + S) x = b by `sweeps` Jacobi sweeps
    x_{k+1} = D^-1 (b - S x_k) from x_0 = D^-1 b, with S strictly
    triangular: each sweep is one K7 launch with the epilogue, all of them
    from one host call (`cuda_ell.ell_sweeps`). Exact after n_levels
    sweeps."""
    return cuda_ell.ell_sweeps(strict, b, 1.0 / diag, sweeps)


@dataclasses.dataclass(eq=False)
class NeumannTriSolve:
    """Fixed-sweep approximate triangular solve plan: no wavefront
    sequencing, `sweeps` fully parallel ELL sweeps. Legal as an inner solve
    under the flexible outer Krylov method, at the cost of extra outer
    iterations."""

    n: int
    sweeps: int
    strict: CompressedRows   # the strict triangle
    diag: torch.Tensor       # (n,)

    @classmethod
    def from_csr(cls, indptr, indices, vals, sweeps: int, diag_vals=None,
                 dtype: torch.dtype = torch.float64, *,
                 device: torch.device | str) -> "NeumannTriSolve":
        """Same contract as LevelTriSolve.from_csr."""
        n = len(indptr) - 1
        dv = (np.asarray(diag_vals, np.float64)
              if diag_vals is not None else np.ones(n))
        return cls(n=n, sweeps=sweeps,
                   strict=CompressedRows.from_arrays(
                       (n, n), indptr, indices, vals, dtype, device=device),
                   diag=torch.tensor(dv, dtype=dtype, device=device))

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return neumann_trisolve(self.strict, self.diag, b, self.sweeps)


def neumann_sweeps_with(strict_mv: Callable, diag: torch.Tensor,
                        b: torch.Tensor, sweeps: int) -> torch.Tensor:
    """The Neumann/Jacobi sweep recurrence x_{k+1} = D^-1 (b - S x_k) with
    the strictly-triangular SpMV supplied as a callable."""
    inv_d = 1.0 / diag
    x = inv_d * b
    for _ in range(sweeps):
        x = inv_d * (b - strict_mv(x))
    return x
