"""Kernels K7 (sparse matrix-vector product over compressed rows) and K8
(ELL SpMM): hand-written CUDA for Hopper (`csrc/sparse_spmv.cu`, entry
points ell_spmv_* and ell_spmm_*), their plain PyTorch versions, their
operand `CompressedRows` and the `BandedELL` container.

Replaces `mpbp_tpu/ops/pallas_ell.py`:
  * `ell_spmv` (K7) replaces `ell_spmv_pallas`: y = A x. With `b` and
    `inv_d` it also applies the Jacobi epilogue inv_d * (b - A x), so one
    Neumann sweep of a triangular solve (`ops/trisolve.py`) is one launch;
    `ell_sweeps` makes all the sweeps of one solve in one host call.
  * `ell_spmm` (K8) replaces `ell_spmm_pallas`: A @ X for X (ncols, k),
    gathering X rows (no one-hot MXU patch).

Both read `CompressedRows`: the real entries only, in row order, with
int32 row pointers, columns and values on the device, and no padding. The
ILU factors K7 sweeps have rows of very unequal length (F's at n=64: mean
125, longest 400), so an ELL block padded to the longest row streams
mostly zeros; GtG, K8's operand, pads 5 entries a row to 7 slots. For K7
a group of `group` lanes (a power of two, 2-32, chosen from the mean row
length and the value type when the operand is built) shares each row.
For K8 a group shares each row too, each lane owning a chunk of X's
columns; `spmm_plan` chooses the group and the chunk from k, the value
type, X's alignment and the mean row length at each call.
`BandedELL` keeps the JAX package's 128-lane band and residue layout for
parity; `to_ell()` turns it into absolute columns. The band encoding, the
doubled x and the VMEM gates existed for Mosaic only.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise. `LAUNCHES` counts kernel launches only.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mpbp_tpu_torch.ops import _build

LAUNCHES = _build.Launches(ell_spmv=0, ell_spmm=0)

_LANES = 128
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_MAX_GROUP = 32


def group_size(mean_row: float, dtype: torch.dtype) -> int:
    """K7's lanes per row: the least power of two, from 2 to 32, whose
    lanes cover the mean row in one pass of 16-byte loads (four f32 or two
    f64 entries a lane)."""
    per_lane = 128 // torch.finfo(dtype).bits
    g = 2
    while g < _MAX_GROUP and per_lane * g < mean_row:
        g *= 2
    return g


@dataclasses.dataclass(eq=False)
class CompressedRows:
    """K7's and K8's operand: the real entries of an (N, ncols) sparse
    matrix in row order. `rowptr` (N+1,), `cols` (nnz,) int32 and `vals`
    (nnz,) lie on one device; `group` is K7's lanes per row."""

    shape: tuple[int, int]
    rowptr: torch.Tensor   # (N+1,) int32
    cols: torch.Tensor     # (nnz,) int32
    vals: torch.Tensor     # (nnz,)
    group: int

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    @classmethod
    def from_arrays(cls, shape, indptr, indices, vals,
                    dtype: torch.dtype = torch.float64, *,
                    device: torch.device | str) -> "CompressedRows":
        """From host CSR arrays (indptr, indices, vals), every entry kept."""
        indptr = np.asarray(indptr, np.int64)
        nrows, ncols = (int(s) for s in shape)
        if max(nrows, ncols, int(indptr[-1])) >= 2 ** 31:
            raise ValueError(f"CompressedRows: shape {shape} or nnz "
                             f"{int(indptr[-1])} exceeds int32 indices")
        return cls((nrows, ncols),
                   torch.tensor(indptr.astype(np.int32), device=device),
                   torch.tensor(np.asarray(indices, np.int32), device=device),
                   torch.tensor(np.asarray(vals), dtype=dtype, device=device),
                   group_size(indptr[-1] / max(nrows, 1), dtype))

    @classmethod
    def from_ell(cls, ell) -> "CompressedRows":
        """The nonzero slots of a slot-major ELLMatrix, on its device (the
        padding carries value 0)."""
        vals, cols = ell.vals.t(), ell.cols.t()
        keep = vals != 0
        rowptr = torch.zeros(ell.shape[0] + 1, dtype=torch.int32,
                             device=vals.device)
        torch.cumsum(keep.sum(1), 0, out=rowptr[1:])
        nnz = int(rowptr[-1])
        return cls(tuple(ell.shape), rowptr, cols[keep].contiguous(),
                   vals[keep].contiguous(),
                   group_size(nnz / max(ell.shape[0], 1), vals.dtype))

    def astype(self, dtype: torch.dtype) -> "CompressedRows":
        """The same rows with values of `dtype` and that type's group."""
        return dataclasses.replace(
            self, vals=self.vals.to(dtype),
            group=group_size(self.nnz / max(self.shape[0], 1), dtype))

    @functools.cached_property
    def rows(self) -> torch.Tensor:
        """Each entry's row (int64): the plain version's segment ids."""
        counts = (self.rowptr[1:] - self.rowptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self.shape[0], device=self.cols.device), counts)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x through K7 (plain version on CPU)."""
        return ell_spmv(self, x)


def ell_spmv_reference(A: CompressedRows, x: torch.Tensor,
                       b: torch.Tensor | None = None,
                       inv_d: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K7: the segment sum of vals * x[cols] over each row
    (`index_add_`, as `CSRMatrix.matvec`); with `b` and `inv_d`,
    inv_d * (b - A x)."""
    acc = torch.zeros(A.shape[0], dtype=x.dtype, device=x.device)
    acc.index_add_(0, A.rows, A.vals * x[A.cols])
    return acc if b is None else inv_d * (b - acc)


def ell_spmm_reference(A: CompressedRows, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8: the segment sum of vals * X[cols] over each row
    (`index_add_`, as `ell_spmv_reference`)."""
    Y = torch.zeros((A.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    return Y.index_add_(0, A.rows, A.vals[:, None] * X[A.cols])


def _pow2_at_least(v: float) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def spmm_plan(k: int, dtype: torch.dtype, mean_row: float,
              aligned: bool) -> tuple[bool, int, int]:
    """K8's launch shape, (vec, col_lanes, group), for X of k columns.
    `vec`: each lane owns a 16-byte chunk (four f32 or two f64 columns),
    which needs k a multiple of the chunk and X 16-byte `aligned`; else one
    column. `col_lanes`: the least power of two, at most 32, whose lanes
    cover k's chunks (more chunks run as column tiles). `group`: lanes a
    row; with four or more column lanes it is `col_lanes`, so each sum
    takes the row's entries in their order, and with one or two the row's
    entries are split over the least power of two of lanes, at most 32,
    that covers the mean row (as K7 does)."""
    chunk = 128 // torch.finfo(dtype).bits
    vec = aligned and k % chunk == 0
    col_lanes = min(_MAX_GROUP, _pow2_at_least(k // chunk if vec else k))
    group = col_lanes if col_lanes >= 4 else max(
        col_lanes, min(_MAX_GROUP, _pow2_at_least(mean_row)))
    return vec, col_lanes, group


def _check_operands(name, vals, indices, vecs) -> None:
    """`vals` of a kernel's dtype; the index arrays and the vectors on its
    device, the vectors of its dtype."""
    if vals.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {vals.dtype} not supported "
                        "(float32/float64)")
    for t in vecs:
        if t.dtype != vals.dtype:
            raise TypeError(f"{name}: operand is {t.dtype}, vals are "
                            f"{vals.dtype}")
    for t in (*indices, *vecs):
        if t.device != vals.device:
            raise ValueError(f"{name}: operand on {t.device}, vals on "
                             f"{vals.device}")


def _check_cuda(name, *tensors) -> None:
    """What the kernels need beyond the operand checks: a CUDA device,
    contiguity."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")


def _check_rows(name, A: CompressedRows, x, epi) -> None:
    if A.rowptr.dtype != torch.int32 or A.cols.dtype != torch.int32:
        raise TypeError(f"{name}: rowptr and cols must be int32")
    _check_operands(name, A.vals, (A.rowptr, A.cols), (x, *epi))
    if x.shape != (A.shape[1],) or any(t.shape != (A.shape[0],)
                                       for t in epi):
        raise ValueError(f"{name}: x must be ({A.shape[1]},) and b, inv_d "
                         f"({A.shape[0]},)")


def ell_spmv(A: CompressedRows, x: torch.Tensor,
             b: torch.Tensor | None = None,
             inv_d: torch.Tensor | None = None) -> torch.Tensor:
    """K7: A @ x over compressed rows; with `b` and `inv_d` (both (N,)) the
    sweep inv_d * (b - A x). Kernel on CUDA, plain version on CPU."""
    if (b is None) != (inv_d is None):
        raise ValueError("ell_spmv: give both b and inv_d, or neither")
    epi = () if b is None else (b, inv_d)
    _check_rows("ell_spmv", A, x, epi)
    if x.device.type == "cpu":
        return ell_spmv_reference(A, x, b, inv_d)
    _check_cuda("ell_spmv", A.rowptr, A.cols, A.vals, x, *epi)
    N = A.shape[0]
    y = torch.empty(N, dtype=x.dtype, device=x.device)
    if N == 0:
        return y
    _build.launch("sparse_spmv", f"ell_spmv_{_SUFFIX[x.dtype]}", x.device,
                  A.rowptr.data_ptr(), A.cols.data_ptr(), A.vals.data_ptr(),
                  N, A.group, x.data_ptr(), b.data_ptr() if epi else None,
                  inv_d.data_ptr() if epi else None, y.data_ptr())
    LAUNCHES.add("ell_spmv")
    return y


def ell_sweeps(A: CompressedRows, b: torch.Tensor, inv_d: torch.Tensor,
               sweeps: int) -> torch.Tensor:
    """`sweeps` Jacobi sweeps x <- inv_d * (b - A x) from x = inv_d * b,
    each one K7 launch with its epilogue: the Neumann solve of (D + A) x =
    b for a strictly triangular A. On CUDA one host call launches them all,
    and `LAUNCHES` counts every sweep: on an H100 machine the host spends
    4.4 us a sweep so, 17.7 us with one call a sweep, against 12 us for a
    sweep of F's n=64 factors on the card (chip_smoke.py's launch_path and
    ilu_layers phases). On CPU the plain version runs them one by one."""
    x = inv_d * b
    _check_rows("ell_sweeps", A, x, (b, inv_d))
    if x.device.type == "cpu":
        for _ in range(sweeps):
            x = ell_spmv_reference(A, x, b, inv_d)
        return x
    _check_cuda("ell_sweeps", A.rowptr, A.cols, A.vals, b, inv_d)
    if sweeps < 1 or A.shape[0] == 0:
        return x
    buf = (x, torch.empty_like(x))
    _build.launch("sparse_spmv", f"ell_sweeps_{_SUFFIX[x.dtype]}", x.device,
                  A.rowptr.data_ptr(), A.cols.data_ptr(), A.vals.data_ptr(),
                  A.shape[0], A.group, b.data_ptr(), inv_d.data_ptr(),
                  buf[0].data_ptr(), buf[1].data_ptr(), sweeps)
    LAUNCHES.add("ell_spmv", sweeps)
    return buf[sweeps % 2]


def ell_spmm(A: CompressedRows, X: torch.Tensor) -> torch.Tensor:
    """K8: A @ X over compressed rows for row-major X (ncols, k) -> (N, k).
    An X of another row count raises ValueError on every device (the JAX
    package's gather clamps it instead). Kernel on CUDA, plain version on
    CPU."""
    if A.rowptr.dtype != torch.int32 or A.cols.dtype != torch.int32:
        raise TypeError("ell_spmm: rowptr and cols must be int32")
    _check_operands("ell_spmm", A.vals, (A.rowptr, A.cols), (X,))
    if X.dim() != 2 or X.shape[0] != A.shape[1]:
        raise ValueError(f"ell_spmm: X must be ({A.shape[1]}, k) for an "
                         f"operand of shape {A.shape}, got {tuple(X.shape)}")
    if X.device.type == "cpu":
        return ell_spmm_reference(A, X)
    _check_cuda("ell_spmm", A.rowptr, A.cols, A.vals, X)
    N, k = A.shape[0], X.shape[1]
    Y = torch.empty((N, k), dtype=X.dtype, device=X.device)
    if N * k == 0:
        return Y
    vec, col_lanes, group = spmm_plan(k, X.dtype, A.nnz / N,
                                      X.data_ptr() % 16 == 0)
    _build.launch("sparse_spmv", f"ell_spmm_{_SUFFIX[X.dtype]}", X.device,
                  A.rowptr.data_ptr(), A.cols.data_ptr(), A.vals.data_ptr(),
                  N, group, col_lanes, int(vec), k, X.data_ptr(),
                  Y.data_ptr())
    LAUNCHES.add("ell_spmm")
    return Y


@dataclasses.dataclass(eq=False)
class BandedELL:
    """ELL storage bucketed into 128-aligned column-offset bands (the JAX
    package's layout): entry (m, col) sits in band o = 128*floor(((col - m)
    mod N) / 128) with lane residue rel = (col - m) mod 128, so its source
    is (m + o + rel) mod N. `idx` holds the residues (int32), `vals` the
    values, both (N, sum(widths)), band after band; padding has value 0."""

    shape: tuple[int, int]
    offsets: tuple[int, ...]   # band starts, multiples of 128
    widths: tuple[int, ...]    # per-band ELL widths
    idx: torch.Tensor          # (N, sum(widths)) int32 lane residues
    vals: torch.Tensor         # (N, sum(widths))

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.vals))

    @property
    def total_width(self) -> int:
        return int(self.idx.shape[1])

    @classmethod
    def from_csr(cls, csr) -> "BandedELL":
        """Bucket a square CSR matrix (periodic column offsets, matching
        DIAMatrix.from_csr(periodic=True)), on the CSR's device. The host
        bucketing is that of the JAX package's `BandedELL.from_csr`."""
        nrows, ncols = csr.shape
        if nrows != ncols:
            raise ValueError(f"BandedELL needs a square matrix: {csr.shape}")
        indptr, indices, vals = csr.host_arrays()
        rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(indptr))
        cdiff = (indices.astype(np.int64) - rows) % ncols
        band = (cdiff // _LANES) * _LANES
        rel = (cdiff % _LANES).astype(np.int32)
        widths, idx_cols, val_cols = [], [], []
        offs = np.unique(band)
        for o in offs:
            m = band == o
            r, rl, vv = rows[m], rel[m], vals[m]
            counts = np.bincount(r, minlength=nrows)
            w = int(counts.max())
            # entries of a band arrive row-major, so an entry's slot is its
            # rank within its row's run
            starts = np.zeros(nrows + 1, np.int64)
            starts[1:] = np.cumsum(counts)
            slot = np.arange(len(r), dtype=np.int64) - starts[r]
            icol = np.zeros((nrows, w), np.int32)
            vcol = np.zeros((nrows, w), vals.dtype)
            icol[r, slot] = rl
            vcol[r, slot] = vv
            widths.append(w)
            idx_cols.append(icol)
            val_cols.append(vcol)
        if not widths:
            idx_cols, val_cols = [np.zeros((nrows, 0), np.int32)], \
                [np.zeros((nrows, 0), vals.dtype)]
        return cls.from_numpy((nrows, ncols), offs, widths,
                              np.concatenate(idx_cols, 1),
                              np.concatenate(val_cols, 1),
                              device=csr.vals.device)

    @classmethod
    def from_numpy(cls, shape, offsets, widths, idx, vals, *,
                   device: torch.device | str) -> "BandedELL":
        """From the JAX package's BandedELL fields as numpy arrays."""
        return cls(tuple(int(s) for s in shape),
                   tuple(int(o) for o in offsets),
                   tuple(int(w) for w in widths),
                   torch.tensor(np.asarray(idx, np.int32), device=device),
                   torch.tensor(np.asarray(vals), device=device))

    def to_ell(self):
        """Plain slot-major ELL (ops/sparse.ELLMatrix) with absolute
        columns (m + o + rel) mod N, computed in int64 and stored as
        int32."""
        from mpbp_tpu_torch.ops.sparse import ELLMatrix

        N = self.shape[0]
        band = torch.tensor(np.repeat(np.asarray(self.offsets, np.int64),
                                      self.widths), device=self.idx.device)
        rows = torch.arange(N, dtype=torch.int64, device=self.idx.device)
        cols = (rows[None, :] + band[:, None]
                + self.idx.t().to(torch.int64)) % N
        return ELLMatrix(self.shape, cols.to(torch.int32),
                         self.vals.t().contiguous())

    @functools.cached_property
    def ell(self):
        """`to_ell()`, made once: the operand of matvec and matmat."""
        return self.to_ell()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x through K7 on the compressed rows of `ell` (plain version
        on CPU)."""
        return self.ell.matvec(x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for X (N, k) through K8 on the compressed rows of `ell`
        (plain version on CPU)."""
        return self.ell.matmat(X)
