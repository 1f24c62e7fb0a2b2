"""The row-tile layout of kernel K5/K6 (`cuda_dia.dia_tiles`) and its plain
version (`dia_tiled_reference`) against the dense-DIA plain version and
the JAX package's `DIAMatrix.matvec` (CPU): the multiphase A from the JAX
layout, the flat non-periodic -D, F and G, and random shapes (N not a
multiple of the tile, N = 1, no diagonals), at two tile heights. The
kernel itself runs only on the card (`test_torch_cuda_kernels.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu.ops import dia as jax_dia
from mpbp_tpu_torch.ops import cuda_dia
from mpbp_tpu_torch.ops.dia import DIAMatrix

torch.set_num_threads(1)

# (nrows, ncols, offsets), as in test_torch_cuda_kernels.DIA_SHAPES
RANDOM_SHAPES = {"square": (1000, 1000, (0, 1, -1, 37, -37, 999)),
                 "one row": (1, 1, (0,)),
                 "tall": (1000, 250, (-900, -3, 0, 2, 249)),
                 "wide": (250, 1000, (-5, 0, 1, 250, 750)),
                 "no diagonals": (77, 77, ()),
                 "tall, ncols inside a tile": (700, 300, (-650, -299, -1, 0,
                                                          1, 299))}


def jax_matrix(case: str) -> jax_dia.DIAMatrix:
    """A JAX-package DIA matrix: the periodic A at n=8 or 16, the flat
    (signed-offset) -D, F or G at n=16, or a random shape."""
    if case in ("A n=8", "A n=16"):
        return jax_make_operator(int(case[4:]), eta_n=100.0).A.to_dia()
    if case in ("-D", "F", "G"):
        blk = {"-D": "minus_D", "F": "F", "G": "G"}[case]
        jop = jax_make_operator(16, eta_n=100.0)
        return jax_dia.DIAMatrix.from_csr(
            getattr(jop, blk).to_csr(drop_tol=0.0), periodic=False)
    nrows, ncols, offsets = RANDOM_SHAPES[case]
    data = np.random.default_rng(1).normal(size=(len(offsets), nrows))
    return jax_dia.DIAMatrix((nrows, ncols), offsets, jnp.asarray(data))


def port(jA) -> DIAMatrix:
    return DIAMatrix.from_numpy(jA.shape, jA.offsets, np.asarray(jA.data),
                                device="cpu")


CASES = ["A n=8", "A n=16", "-D", "F", "G", *RANDOM_SHAPES]


@pytest.mark.parametrize("rows", [32, 128])
@pytest.mark.parametrize("case", CASES)
def test_tiled_reference_matches_dense_and_jax(case, rows):
    """f64: the tiles' plain sum equals the dense-DIA plain version exactly
    (same products, same order, only all-zero segments skipped) and the
    JAX package's matvec to 1e-12 of max|y|."""
    jA = jax_matrix(case)
    A = port(jA)
    x = np.random.default_rng(2).normal(size=A.shape[1])
    tx = torch.as_tensor(x)
    tiles = cuda_dia.dia_tiles(A, rows)
    assert tiles.ntiles == -(-A.shape[0] // rows)
    got = cuda_dia.dia_tiled_reference(tiles, tx)
    torch.testing.assert_close(got, cuda_dia.dia_spmv_reference(A, tx),
                               rtol=0, atol=0)
    want = (np.zeros(A.shape[0]) if not jA.offsets
            else np.asarray(jA.matvec(jnp.asarray(x))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * max(np.abs(want).max(), 1e-300))


def _tiles_dense(tiles) -> np.ndarray:
    """The matrix the tiles hold, as a dense array."""
    nrows, ncols = tiles.shape
    d = np.zeros((tiles.ntiles * tiles.rows, ncols))
    ptr = tiles.tile_ptr.numpy()
    for t in range(tiles.ntiles):
        rows = t * tiles.rows + np.arange(tiles.rows)
        for s in range(ptr[t], ptr[t + 1]):
            cols = (rows + int(tiles.offsets[s])) % ncols
            np.add.at(d, (rows, cols), tiles.values[s].numpy())
    return d[:nrows]


@pytest.mark.parametrize("case", ["A n=16", "-D", "F", "G", "tall",
                                  "tall, ncols inside a tile",
                                  "no diagonals"])
def test_tile_layout_keeps_every_nonzero_and_no_empty_segment(case):
    """Every stored (tile, diagonal) segment has a nonzero, and the tiles
    hold exactly the matrix (its rows past ncols, which give 0, dropped)."""
    A = port(jax_matrix(case))
    tiles = cuda_dia.dia_tiles(A, 128)
    S = tiles.values.shape[0]
    assert tiles.tile_ptr.dtype == torch.int32
    assert tiles.offsets.dtype == torch.int32
    assert int(tiles.tile_ptr[-1]) == S == tiles.offsets.numel()
    assert bool((tiles.values != 0).any(dim=1).all())
    assert bool(((tiles.offsets >= 0) & (tiles.offsets < A.shape[1])).all())
    want = A.to_dense()
    want[A.shape[1]:] = 0.0
    np.testing.assert_array_equal(_tiles_dense(tiles), want)


def test_tiles_of_a_at_n64_stream_few_zeros():
    """On A at n=64 (35 diagonals, 11.2 nonzeros a row) the 128-row tiles
    keep at most 1.35 values per nonzero (1.294 measured), and none of A's
    nonzeros is lost."""
    A = port(jax_make_operator(64, eta_n=100.0).A.to_dia())
    tiles = cuda_dia.dia_tiles(A, 128)
    nnz = int(torch.count_nonzero(A.data))
    assert int(torch.count_nonzero(tiles.values)) == nnz
    assert tiles.values.numel() / nnz <= 1.35
