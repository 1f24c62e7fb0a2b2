"""General sparse matrix containers, COO/CSR/ELL/BSR (port of
`mpbp_tpu/ops/sparse.py`).

Symbolic structure is built on the host in numpy once per operator; the
numeric payloads (and the column indices) are tensors on an explicit
device. CSR is the host/setup format: `from_coo` and `host_arrays` are the
JAX package's numpy code, so a CSR exported here equals the JAX package's
bit for bit (the native ILUT drops entries by magnitude). ELL is the device
format: `ELLMatrix.matvec` and `matmat` run kernels K7 and K8
(`ops/cuda_ell.py`) on the matrix's compressed rows on a CUDA tensor.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict

import numpy as np
import torch

from mpbp_tpu_torch import native
from mpbp_tpu_torch.ops import cuda_ell


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass(eq=False)
class COOMatrix:
    shape: tuple[int, int]
    rows: torch.Tensor  # (nnz,) int32
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        contrib = self.vals * x[self.cols]
        return torch.zeros(self.shape[0], dtype=x.dtype,
                           device=x.device).index_add_(0, self.rows.long(),
                                                       contrib)

    def to_csr(self) -> "CSRMatrix":
        return CSRMatrix.from_coo(self.shape[0], self.shape[1],
                                  _host(self.rows), _host(self.cols),
                                  _host(self.vals), device=self.vals.device)

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, dtype=_host(self.vals).dtype)
        np.add.at(d, (_host(self.rows), _host(self.cols)), _host(self.vals))
        return d


@dataclasses.dataclass(eq=False)
class CSRMatrix:
    """CSR with duplicate-free, column-sorted rows; `indptr` stays on the
    host."""

    shape: tuple[int, int]
    indptr: np.ndarray      # (nrows+1,) int64, host
    indices: torch.Tensor   # (nnz,) int32
    vals: torch.Tensor      # (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @classmethod
    def from_coo(cls, nrows, ncols, rows, cols, vals, *,
                 device: torch.device | str) -> "CSRMatrix":
        """Build from COO triplets, summing duplicates (host-side)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        # sort by (row, col), then reduce duplicates
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if len(rows):
            uniq = np.ones(len(rows), dtype=bool)
            uniq[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            group = np.cumsum(uniq) - 1
            out_vals = np.zeros(group[-1] + 1, dtype=vals.dtype)
            np.add.at(out_vals, group, vals)
            rows, cols, vals = rows[uniq], cols[uniq], out_vals
        indptr = np.zeros(nrows + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls.from_numpy((nrows, ncols), indptr, cols, vals,
                              device=device)

    @classmethod
    def from_numpy(cls, shape, indptr, indices, vals, *,
                   device: torch.device | str) -> "CSRMatrix":
        """From host arrays, e.g. the JAX package's `host_arrays()`."""
        return cls((int(shape[0]), int(shape[1])),
                   np.asarray(indptr, np.int64),
                   torch.tensor(np.asarray(indices, np.int32), device=device),
                   torch.tensor(np.asarray(vals), device=device))

    def prune(self, drop_tol: float) -> "CSRMatrix":
        idx, v = _host(self.indices), _host(self.vals)
        keep = np.abs(v) > drop_tol
        rows = np.repeat(np.arange(self.shape[0]),
                         np.diff(self.indptr))[keep]
        return CSRMatrix.from_coo(self.shape[0], self.shape[1], rows,
                                  idx[keep], v[keep], device=self.vals.device)

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    @functools.cached_property
    def _rows(self) -> torch.Tensor:
        return torch.tensor(np.repeat(np.arange(self.shape[0]),
                                      np.diff(self.indptr)),
                            device=self.vals.device)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Segment-sum SpMV (the portable path; ELL is the kernel path)."""
        contrib = self.vals * x[self.indices]
        return torch.zeros(self.shape[0], dtype=contrib.dtype,
                           device=x.device).index_add_(0, self._rows, contrib)

    def to_ell(self, width: int | None = None) -> "ELLMatrix":
        """Padded rows; padding repeats the row's last column (a row with
        no entries reads a clamped index) with value 0. The rows are the
        JAX package's; they are stored transposed (slot-major)."""
        lens = self.row_lengths()
        w = int(lens.max()) if width is None else width
        nrows = self.shape[0]
        idx, v = _host(self.indices), _host(self.vals)
        starts = np.asarray(self.indptr[:-1])
        slot = np.arange(w)[None, :]
        in_row = slot < lens[:, None]
        flat = np.minimum(starts[:, None] + np.minimum(slot, np.maximum(
            lens[:, None] - 1, 0)), max(len(idx) - 1, 0))
        cols = idx[flat].astype(np.int32) if len(idx) else np.zeros(
            (nrows, w), np.int32)
        vals = np.where(in_row, v[flat], 0) if len(v) else np.zeros(
            (nrows, w), v.dtype)
        dev = self.vals.device
        return ELLMatrix(self.shape,
                         torch.tensor(np.ascontiguousarray(cols.T),
                                      device=dev),
                         torch.tensor(np.ascontiguousarray(vals.T),
                                      device=dev))

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, dtype=_host(self.vals).dtype)
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        d[rows, _host(self.indices)] = _host(self.vals)
        return d

    def transpose(self) -> "CSRMatrix":
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        return CSRMatrix.from_coo(self.shape[1], self.shape[0],
                                  _host(self.indices), rows,
                                  _host(self.vals), device=self.vals.device)

    def host_arrays(self):
        return self.indptr, _host(self.indices), _host(self.vals)


@dataclasses.dataclass(eq=False)
class ELLMatrix:
    """Padded sparse rows with absolute int32 columns, stored slot-major:
    cols/vals are (width, nrows). Padding has value 0 and an in-range
    column. The JAX package stores the transpose, (nrows, width). Every
    ELL operand of the port (`to_ell`, `BandedELL.to_ell`) is one of
    these; K7 and K8 read its nonzero slots as `compressed`, made once."""

    shape: tuple[int, int]
    cols: torch.Tensor  # (width, nrows) int32
    vals: torch.Tensor  # (width, nrows)

    @property
    def width(self) -> int:
        return int(self.cols.shape[0])

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.vals))

    @functools.cached_property
    def compressed(self) -> cuda_ell.CompressedRows:
        """K7's and K8's operand: the nonzero slots in compressed rows, in
        slot order."""
        return cuda_ell.CompressedRows.from_ell(self)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x through kernel K7 (plain version on CPU)."""
        return self.compressed.matvec(x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """SpMM (m, n) @ (n, k) -> (m, k) through kernel K8 on the
        compressed rows (plain version on CPU); an X of other than n rows
        raises ValueError."""
        return cuda_ell.ell_spmm(self.compressed, X)


@dataclasses.dataclass(eq=False)
class BSRMatrix:
    """Block CSR with fixed (bs x bs) dense blocks, ELL-padded block rows:
    blocks (n_block_rows, width, bs, bs), bcols (n_block_rows, width)."""

    shape: tuple[int, int]
    bs: int
    bcols: torch.Tensor
    blocks: torch.Tensor

    @classmethod
    def from_csr(cls, csr: CSRMatrix, bs: int) -> "BSRMatrix":
        m, n = csr.shape
        if m % bs or n % bs:
            raise ValueError(f"shape {csr.shape} is not a multiple of {bs}")
        indptr, idx, v = csr.host_arrays()
        blockmap: dict[tuple[int, int], np.ndarray] = {}
        for r in range(m):
            for p in range(indptr[r], indptr[r + 1]):
                c = idx[p]
                key = (r // bs, c // bs)
                if key not in blockmap:
                    blockmap[key] = np.zeros((bs, bs), dtype=v.dtype)
                blockmap[key][r % bs, c % bs] = v[p]
        per_row: dict[int, list] = defaultdict(list)
        for (br, bc), blk in blockmap.items():
            per_row[br].append((bc, blk))
        width = max((len(x) for x in per_row.values()), default=1)
        bcols = np.zeros((m // bs, width), dtype=np.int32)
        blocks = np.zeros((m // bs, width, bs, bs), dtype=v.dtype)
        for br, lst in per_row.items():
            lst.sort(key=lambda t: t[0])
            for k, (bc, blk) in enumerate(lst):
                bcols[br, k] = bc
                blocks[br, k] = blk
        dev = csr.vals.device
        return cls(csr.shape, bs, torch.tensor(bcols, device=dev),
                   torch.tensor(blocks, device=dev))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xb = x.reshape(-1, self.bs)
        out = torch.einsum("rwij,rwj->ri", self.blocks, xb[self.bcols])
        return out.reshape(self.shape[0])


def spgemm_csr(A: CSRMatrix, B: CSRMatrix) -> CSRMatrix:
    """General CSR x CSR product on the host (setup path), by the native
    C++ SpGEMM."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
    rows, cols, vals = native.spgemm(A.shape[0], *A.host_arrays(),
                                     *B.host_arrays())
    return CSRMatrix.from_coo(A.shape[0], B.shape[1], rows, cols, vals,
                              device=A.vals.device)
