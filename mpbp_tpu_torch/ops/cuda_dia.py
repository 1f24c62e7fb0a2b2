"""Kernel K5/K6, the DIA SpMV: hand-written CUDA for Hopper
(`csrc/sparse_spmv.cu`, entry points dia_spmv_f32/dia_spmv_f64), with its
plain PyTorch version and the row-tile layout it runs on.

Replaces `mpbp_tpu/ops/pallas_dia.py`: `dia_spmv_pallas` (x resident in
VMEM) and `dia_spmv_pallas_streamed` (x streamed in windows past VMEM) are
one kernel here, since the card reads x through its 50 MB L2 and has no
VMEM ceiling to stream around. It computes

    y[i] = sum_k data[k, i] * (i < ncols ? x[(i + off_k) mod ncols] : 0)

for any shape and signed or periodic offsets (the `DIAMatrix.matvec`
convention).

What bounds it: the bytes of the values it streams. A stencil matrix's
diagonals are zero over most of their length: the multiphase A has 35
diagonals and 11.2 nonzeros a row, path (b)'s tall G 12 diagonals and 0.5
nonzeros a row. So the kernel runs on row tiles (`DIATiles`, built once
per `DIAMatrix` on its device, `DIAMatrix.tiles`): the rows are cut into
tiles of T rows, and each tile keeps only the diagonals that have a
nonzero among its rows below ncols, in the matrix's diagonal order. At
T=128 that streams 1.07 values per nonzero on A at n=512 (35 / 11.2 =
3.1 for the dense layout). One block a tile, one row a thread: the
values of a tile-diagonal are contiguous (coalesced reads) and its x reads
contiguous, through L2. The TPU's doubled x and VMEM windows have no
counterpart. The tile sums the same products in the same diagonal order,
skipping only diagonals that are all zero in the tile, so on finite
inputs it gives the dense layout's result bit for bit.

On a CPU tensor `dia_spmv` runs the plain version (`dia_spmv_reference`,
the roll form, no tiles); on a CUDA tensor it launches the kernel or
raises. `dia_tiled_reference` computes the product from the tiles in
plain PyTorch, so the CPU tests reach the layout. `LAUNCHES` counts kernel
launches only.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mpbp_tpu_torch.ops import _build

LAUNCHES = _build.Launches(dia_spmv=0)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# rows a tile: a power of two, one block of that many threads a tile
TILE_ROWS = 128


@dataclasses.dataclass(eq=False)
class DIATiles:
    """Row-tile DIA layout of a `DIAMatrix`: tile t holds rows
    [t*rows, (t+1)*rows) and keeps segments s in [tile_ptr[t],
    tile_ptr[t+1]), each one diagonal's `rows` values in that tile (0 at
    rows >= min(nrows, ncols) and in the last tile's padding) and its
    offset in [0, ncols)."""
    shape: tuple[int, int]
    rows: int
    tile_ptr: torch.Tensor      # (ntiles + 1,) int32
    offsets: torch.Tensor       # (S,) int32
    values: torch.Tensor        # (S, rows), the matrix's dtype

    @property
    def ntiles(self) -> int:
        return self.tile_ptr.numel() - 1


def dia_tiles(A, rows: int = TILE_ROWS) -> DIATiles:
    """The row-tile layout of DIAMatrix A on A's device, by torch ops."""
    if rows < 1 or rows > 1024 or rows & (rows - 1):
        raise ValueError(f"rows a tile must be a power of two in [1, 1024], "
                         f"got {rows}")
    nrows, ncols = A.shape
    ntiles = -(-nrows // rows)
    m = min(nrows, ncols)
    # the rows at or past ncols of a tall matrix keep no data
    padded = F.pad(A.data[:, :m], (0, ntiles * rows - m)).view(
        len(A.offsets), ntiles, rows)
    keep = (padded != 0).any(dim=2).T              # (ntiles, K)
    tile, diag = keep.nonzero(as_tuple=True)       # tile-major, then k
    tile_ptr = torch.zeros(ntiles + 1, dtype=torch.int32,
                           device=A.data.device)
    tile_ptr[1:] = torch.cumsum(keep.sum(dim=1), 0)
    return DIATiles(A.shape, rows, tile_ptr,
                    A.kernel_offsets[diag].to(torch.int32),
                    padded[diag, tile].contiguous())


def dia_spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5/K6 on a `DIAMatrix` A: the `torch.roll` form."""
    nrows, ncols = A.shape
    acc = None
    for k, off in enumerate(A.offsets):
        xs = torch.roll(x, -off) if off else x
        if nrows <= ncols:
            contrib = A.data[k] * xs[:nrows]
        else:
            contrib = A.data[k] * F.pad(xs, (0, nrows - ncols))
        acc = contrib if acc is None else acc + contrib
    if acc is None:
        return torch.zeros(nrows, dtype=x.dtype, device=x.device)
    return acc


def dia_tiled_reference(tiles: DIATiles, x: torch.Tensor) -> torch.Tensor:
    """A @ x from the row-tile layout, in plain PyTorch: each row sums its
    tile's segments in their stored order, as the kernel does, so the
    result equals `dia_spmv_reference`'s on finite inputs."""
    nrows, ncols = tiles.shape
    T, ntiles = tiles.rows, tiles.ntiles
    S = tiles.values.shape[0]
    if S == 0:
        return torch.zeros(nrows, dtype=x.dtype, device=x.device)
    ptr = tiles.tile_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    tile = torch.repeat_interleave(torch.arange(ntiles, device=x.device),
                                   counts)
    slot = torch.arange(S, device=x.device) - ptr[tile]
    row = tile[:, None] * T + torch.arange(T, device=x.device)
    # values are 0 at rows >= min(nrows, ncols): those products are 0
    prods = tiles.values * x[(row + tiles.offsets[:, None]) % ncols]
    by_slot = torch.zeros(int(counts.max()), ntiles, T, dtype=x.dtype,
                          device=x.device)
    by_slot[slot, tile] = prods
    y = by_slot[0]
    for j in range(1, by_slot.shape[0]):
        y = y + by_slot[j]
    return y.reshape(-1)[:nrows]


def dia_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """K5/K6: y = A @ x for a `DIAMatrix` A. Kernel on CUDA (on A's row
    tiles), plain version on CPU."""
    nrows, ncols = A.shape
    data = A.data
    if x.dim() != 1 or x.shape[0] != ncols:
        raise ValueError(f"x must be ({ncols},), got {tuple(x.shape)}")
    if tuple(data.shape) != (len(A.offsets), nrows):
        raise ValueError(f"data must be ({len(A.offsets)}, {nrows}), got "
                         f"{tuple(data.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"dtype {x.dtype} not supported (float32/float64)")
    if data.dtype != x.dtype:
        raise TypeError(f"data is {data.dtype}, x is {x.dtype}")
    if data.device != x.device:
        raise ValueError(f"data is on {data.device}, x on {x.device}")
    if x.device.type == "cpu":
        return dia_spmv_reference(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x.device}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("data and x must be contiguous")
    y = torch.empty(nrows, dtype=x.dtype, device=x.device)
    if nrows == 0:
        return y
    tiles = A.tiles
    _build.launch("sparse_spmv", f"dia_spmv_{_SUFFIX[x.dtype]}", x.device,
                  tiles.tile_ptr.data_ptr(), tiles.offsets.data_ptr(),
                  tiles.values.data_ptr(), tiles.rows, nrows, ncols,
                  x.data_ptr(), y.data_ptr())
    LAUNCHES.add("dia_spmv")
    return y
