"""Kernels K7 (ELL SpMV) and K8 (ELL SpMM): hand-written CUDA for Hopper
(`csrc/sparse_spmv.cu`, entry points ell_spmv_* and ell_spmm_*), their
plain PyTorch versions, and the `BandedELL` container.

Replaces `mpbp_tpu/ops/pallas_ell.py`:
  * `ell_spmv` (K7) replaces `ell_spmv_pallas`. With `b` and `inv_d` it
    also applies the Jacobi epilogue inv_d * (b - A x), so one Neumann
    sweep of a triangular solve (`ops/trisolve.py`) is one launch.
  * `ell_spmm` (K8) replaces `ell_spmm_pallas`: A @ X for X (N, k),
    one thread per output entry, gathering X rows (no one-hot MXU patch).

The kernels take plain ELL with absolute int32 columns, stored slot-major:
`cols` and `vals` are (W, nrows), so a warp reads 32 consecutive rows of
one slot (the TPU kernel's `idx3` choice); `ops/sparse.ELLMatrix` is the
container that holds them. Padding slots carry value 0 and any in-range
column. `BandedELL` keeps the JAX package's 128-lane band and
residue layout for parity; `to_ell()` turns it into absolute columns. The
band encoding, the doubled x and the VMEM gates existed for Mosaic only.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise. `LAUNCHES` counts kernel launches only.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mpbp_tpu_torch.ops import _build

LAUNCHES = {"ell_spmv": 0, "ell_spmm": 0}

_LANES = 128
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def ell_spmv_reference(cols: torch.Tensor, vals: torch.Tensor,
                       x: torch.Tensor, b: torch.Tensor | None = None,
                       inv_d: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K7 on slot-major (W, N) arrays: gather, multiply, sum
    over slots; with `b` and `inv_d`, inv_d * (b - A x)."""
    acc = (vals * x[cols]).sum(0)
    return acc if b is None else inv_d * (b - acc)


def ell_spmm_reference(cols: torch.Tensor, vals: torch.Tensor,
                       X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8 on slot-major (W, N) arrays: one gathered X-row
    multiply-add per slot."""
    Y = torch.zeros((cols.shape[1], X.shape[1]), dtype=X.dtype,
                    device=X.device)
    for w in range(cols.shape[0]):
        Y += vals[w, :, None] * X[cols[w]]
    return Y


def _check(name, cols, vals, *vecs) -> None:
    if cols.dim() != 2 or tuple(vals.shape) != tuple(cols.shape):
        raise ValueError(f"{name}: cols and vals must both be (W, N), got "
                         f"{tuple(cols.shape)} and {tuple(vals.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{name}: cols must be int32, got {cols.dtype}")
    if vals.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {vals.dtype} not supported "
                        "(float32/float64)")
    if cols.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: width {cols.shape[0]} too large")
    for t in vecs:
        if t.dtype != vals.dtype:
            raise TypeError(f"{name}: operand is {t.dtype}, vals are "
                            f"{vals.dtype}")
    for t in (cols, *vecs):
        if t.device != vals.device:
            raise ValueError(f"{name}: operand on {t.device}, vals on "
                             f"{vals.device}")


def _check_cuda(name, *tensors) -> None:
    """What the kernels need beyond `_check`: a CUDA device, contiguity."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
             b: torch.Tensor | None = None,
             inv_d: torch.Tensor | None = None) -> torch.Tensor:
    """K7: A @ x for slot-major ELL (cols int32 (W, N), vals (W, N)); with
    `b` and `inv_d` (both (N,)) the sweep inv_d * (b - A x). Kernel on
    CUDA, plain version on CPU."""
    N = cols.shape[1] if cols.dim() == 2 else -1
    if (b is None) != (inv_d is None):
        raise ValueError("ell_spmv: give both b and inv_d, or neither")
    epi = () if b is None else (b, inv_d)
    _check("ell_spmv", cols, vals, x, *epi)
    if x.dim() != 1 or any(t.shape != (N,) for t in epi):
        raise ValueError(f"ell_spmv: x must be 1-D and b, inv_d ({N},)")
    if x.device.type == "cpu":
        return ell_spmv_reference(cols, vals, x, b, inv_d)
    _check_cuda("ell_spmv", cols, vals, x, *epi)
    y = torch.empty(N, dtype=x.dtype, device=x.device)
    if N == 0:
        return y
    _build.launch("sparse_spmv", f"ell_spmv_{_SUFFIX[x.dtype]}", x.device,
                  cols.data_ptr(), vals.data_ptr(), cols.shape[0], N,
                  x.data_ptr(), b.data_ptr() if epi else None,
                  inv_d.data_ptr() if epi else None, y.data_ptr())
    LAUNCHES["ell_spmv"] += 1
    return y


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
             X: torch.Tensor) -> torch.Tensor:
    """K8: A @ X for slot-major ELL and row-major X (ncols, k) -> (N, k).
    Kernel on CUDA, plain version on CPU."""
    _check("ell_spmm", cols, vals, X)
    if X.dim() != 2:
        raise ValueError(f"ell_spmm: X must be (ncols, k), got "
                         f"{tuple(X.shape)}")
    if X.device.type == "cpu":
        return ell_spmm_reference(cols, vals, X)
    _check_cuda("ell_spmm", cols, vals, X)
    N, k = cols.shape[1], X.shape[1]
    Y = torch.empty((N, k), dtype=X.dtype, device=X.device)
    if N * k == 0:
        return Y
    _build.launch("sparse_spmv", f"ell_spmm_{_SUFFIX[X.dtype]}", X.device,
                  cols.data_ptr(), vals.data_ptr(), cols.shape[0], N, k,
                  X.data_ptr(), Y.data_ptr())
    LAUNCHES["ell_spmm"] += 1
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
        """A @ x through K7 (plain version on CPU)."""
        return self.ell.matvec(x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for X (N, k) through K8 (plain version on CPU)."""
        return self.ell.matmat(X)
