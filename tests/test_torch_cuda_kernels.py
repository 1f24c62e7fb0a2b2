"""Kernels K1-K4 and K5-K8 on the card against their plain PyTorch
versions (K3 and K4 also against K2), on awkward shapes, and the solves of
the slices on the card
against the same solves on the CPU. Every test here needs an NVIDIA GPU and
skips without one. The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpbp_tpu_torch import bench
from mpbp_tpu_torch.drivers import solve_multiphase
from mpbp_tpu_torch.models.fused import _extend_rows, make_fused_apply_kernel
from mpbp_tpu_torch.models.multiphase import operator_from_numpy
from mpbp_tpu_torch.ops import cuda_dia, cuda_ell, cuda_stencil
from mpbp_tpu_torch.ops.dia import DIAMatrix
from mpbp_tpu_torch.ops.cuda_ell import BandedELL
from mpbp_tpu_torch.ops.sparse import CSRMatrix, ELLMatrix

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5),
                                         (torch.float64, 1e-12)])
def test_kernels_match_plain_versions(cuda_device, dtype, bound):
    """At a size that is not a multiple of the 32x8 block (masked edges),
    random theta in [0.1, 0.9] and a random state; the bound is relative
    to max|plain| (FMA contraction and operation order)."""
    n = 50
    rng = np.random.default_rng(0)
    cell, xpt, ypt = (rng.uniform(0.1, 0.9, (n, n)) for _ in range(3))
    op = operator_from_numpy(cell, xpt, ypt,
                             dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0,
                                  eta_s=1.0), device=cuda_device, dtype=dtype)
    x = torch.as_tensor(rng.normal(size=(5, n, n)), dtype=dtype,
                        device=cuda_device)
    for name, nf in (("f_apply", 4), ("a_apply", 5)):
        args = (op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt,
                x[:nf].contiguous(), op.params, op.grid.dx, op.grid.dy)
        before = cuda_stencil.LAUNCHES[name]
        got = getattr(cuda_stencil, name)(*args)
        want = getattr(cuda_stencil, f"{name}_reference")(*args)
        torch.cuda.synchronize()
        assert cuda_stencil.LAUNCHES[name] == before + 1
        assert float((got - want).abs().max()) <= bound * float(
            want.abs().max())


def test_hybrid_solve_on_card_matches_cpu(cuda_device):
    """The slice's solve on the card against the same solve on the CPU at
    n=16, where the outer count is stable: 15 iterations under rhs
    perturbations up to 1e-12 on the CPU. (At n=32 a 1e-14 perturbation
    moves it between 18 and 22 in f64, so counts there are not compared.)
    The f32 inner solves round differently on the card (FMA, reduction
    order), hence the band of 2."""
    kw = dict(n=16, eta_n=100.0, pc="lsc_mg_full", precision="hybrid",
              tol=1e-8, maxiter=100, inner_tol=1e-4, inner_iters=40)
    before = dict(cuda_stencil.LAUNCHES)
    gpu = solve_multiphase(**kw, device=cuda_device)
    assert all(cuda_stencil.LAUNCHES[k] > before[k]
               for k in ("f_apply", "a_apply"))
    cpu = solve_multiphase(**kw, device="cpu")
    msg = f"card {gpu.iters} iters, cpu {cpu.iters}"
    assert gpu.converged and abs(gpu.iters - cpu.iters) <= 2, msg
    assert gpu.params["true_relres"] <= 10 * kw["tol"]
    assert gpu.error_norms["l2"] == pytest.approx(cpu.error_norms["l2"],
                                                  rel=1e-4)


BOUNDS = [(torch.float32, 1e-5), (torch.float64, 1e-12)]


def _assert_close(got, want, bound):
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= bound * scale


# (nrows, ncols, offsets): N not a multiple of the 128-row tile, N = 1,
# signed (negative) offsets on tall and wide rectangular shapes, no
# diagonals, and a tall matrix whose ncols = 300 falls inside the tile of
# rows 256..383 (rows below and past ncols in one tile)
DIA_SHAPES = [(1000, 1000, (0, 1, -1, 37, -37, 999)), (1, 1, (0,)),
              (1000, 250, (-900, -3, 0, 2, 249)),
              (250, 1000, (-5, 0, 1, 250, 750)), (77, 77, ()),
              (700, 300, (-650, -299, -1, 0, 1, 299))]


@pytest.mark.parametrize("dtype,bound", BOUNDS)
@pytest.mark.parametrize("nrows,ncols,offsets", DIA_SHAPES)
def test_dia_spmv_matches_plain(cuda_device, dtype, bound, nrows, ncols,
                                offsets):
    rng = np.random.default_rng(1)
    A = DIAMatrix.from_numpy((nrows, ncols), offsets,
                             rng.normal(size=(len(offsets), nrows)),
                             device=cuda_device)
    A = DIAMatrix(A.shape, A.offsets, A.data.to(dtype))
    x = torch.as_tensor(rng.normal(size=ncols), dtype=dtype,
                        device=cuda_device)
    before = cuda_dia.LAUNCHES["dia_spmv"]
    got = cuda_dia.dia_spmv(A, x)
    assert cuda_dia.LAUNCHES["dia_spmv"] == before + 1
    _assert_close(got, cuda_dia.dia_spmv_reference(A, x), bound)
    # the row tiles as built on the card, summed by their plain version
    assert A.tiles.values.device == x.device
    _assert_close(got, cuda_dia.dia_tiled_reference(A.tiles, x), bound)


def _ell(rng, N, ncols, W, dtype, device):
    """Slot-major random ELL whose last slot is padding (value 0) in every
    other row, with row 3 empty (all slots padding)."""
    cols = rng.integers(0, ncols, size=(W, N)).astype(np.int32)
    vals = rng.normal(size=(W, N))
    if W > 1:
        vals[-1, ::2] = 0.0
    vals[:, min(3, N - 1)] = 0.0
    return (torch.as_tensor(cols, device=device),
            torch.as_tensor(vals, dtype=dtype, device=device))


def _rows(rng, N, max_row, dtype, device, long_row=0, ncols=None):
    """Random compressed (N, ncols) rows, square by default, of lengths
    0..max_row (a quarter of them empty), row 1 of length `long_row` when
    given."""
    ncols = N if ncols is None else ncols
    lens = rng.integers(0, max_row + 1, size=N)
    lens[rng.random(N) < 0.25] = 0
    if long_row and N > 1:
        lens[1] = long_row
    indptr = np.concatenate([[0], np.cumsum(lens)])
    cols = rng.integers(0, ncols, size=indptr[-1])
    vals = rng.normal(size=indptr[-1])
    return cuda_ell.CompressedRows.from_arrays((N, ncols), indptr, cols,
                                               vals, dtype, device=device)


def _misaligned(A):
    """The same rows with vals and cols 4 bytes past a 16-byte boundary:
    the kernel's scalar-load path."""
    def shift(t):
        buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
        out = buf[1:1 + t.numel()]
        out.copy_(t)
        return out
    return dataclasses.replace(A, cols=shift(A.cols), vals=shift(A.vals))


@pytest.mark.parametrize("dtype,bound", BOUNDS)
@pytest.mark.parametrize("N,max_row,long_row", [(1000, 1, 0), (1000, 7, 70),
                                                (1, 3, 0), (4097, 40, 300),
                                                (16384, 250, 400)])
@pytest.mark.parametrize("group", [None, 2, 8, 32])
def test_ell_spmv_matches_plain(cuda_device, dtype, bound, N, max_row,
                                long_row, group):
    """K7 on compressed rows against its plain version, with and without
    the epilogue, at the operand's own lane group and at forced ones, with
    empty rows and a row longer than the group; then on misaligned
    arrays (scalar loads)."""
    rng = np.random.default_rng(2)
    A = _rows(rng, N, max_row, dtype, cuda_device, long_row)
    if group is not None:
        A = dataclasses.replace(A, group=group)
    x, b = (torch.as_tensor(rng.normal(size=N), dtype=dtype,
                            device=cuda_device) for _ in range(2))
    inv_d = torch.as_tensor(1.0 + rng.random(N), dtype=dtype,
                            device=cuda_device)
    for op in (A, _misaligned(A)):
        before = cuda_ell.LAUNCHES["ell_spmv"]
        got = cuda_ell.ell_spmv(op, x)
        got_epi = cuda_ell.ell_spmv(op, x, b=b, inv_d=inv_d)
        assert cuda_ell.LAUNCHES["ell_spmv"] == before + 2
        _assert_close(got, cuda_ell.ell_spmv_reference(A, x), bound)
        _assert_close(got_epi, cuda_ell.ell_spmv_reference(A, x, b, inv_d),
                      bound)


@pytest.mark.parametrize("dtype,bound", BOUNDS)
@pytest.mark.parametrize("sweeps", [0, 1, 2, 7])
def test_ell_sweeps_match_one_launch_at_a_time(cuda_device, dtype, bound,
                                               sweeps):
    """The Neumann sweeps of one host call against the same sweeps by the
    plain version, and one count per sweep."""
    rng = np.random.default_rng(4)
    A = _rows(rng, 3000, 40, dtype, cuda_device, long_row=200)
    b = torch.as_tensor(rng.normal(size=3000), dtype=dtype,
                        device=cuda_device)
    inv_d = torch.as_tensor(1.0 + rng.random(3000), dtype=dtype,
                            device=cuda_device)
    want = inv_d * b
    for _ in range(sweeps):
        want = cuda_ell.ell_spmv_reference(A, want, b, inv_d)
    before = cuda_ell.LAUNCHES["ell_spmv"]
    got = cuda_ell.ell_sweeps(A, b, inv_d, sweeps)
    assert cuda_ell.LAUNCHES["ell_spmv"] == before + sweeps
    _assert_close(got, want, bound)


def test_ell_matvec_runs_k7_on_its_compressed_rows(cuda_device):
    """ELLMatrix.matvec (slot-major, padded, an empty row) through K7 on
    the nonzero slots, against the padded arrays' own sum."""
    rng = np.random.default_rng(5)
    cols, vals = _ell(rng, 1000, 1000, 7, torch.float64, cuda_device)
    ell = ELLMatrix((1000, 1000), cols, vals)
    x = torch.as_tensor(rng.normal(size=1000), device=cuda_device)
    before = cuda_ell.LAUNCHES["ell_spmv"]
    got = ell.matvec(x)
    assert cuda_ell.LAUNCHES["ell_spmv"] == before + 1
    assert ell.compressed.nnz == int(torch.count_nonzero(vals))
    _assert_close(got, (vals * x[cols]).sum(0), 1e-12)


@pytest.mark.parametrize("dtype,bound", BOUNDS)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 16, 33, 130])
@pytest.mark.parametrize("max_row,long_row", [(7, 70), (40, 300)])
def test_ell_spmm_matches_plain(cuda_device, dtype, bound, k, max_row,
                                long_row):
    """K8 on rectangular compressed rows (a quarter of them empty, one row
    longer than any lane group) against its plain version, at every
    launch shape of `spmm_plan`: 16-byte and one-column chunks, entries
    split over lanes, column tiles."""
    rng = np.random.default_rng(3)
    A = _rows(rng, 1000, max_row, dtype, cuda_device, long_row, ncols=700)
    X = torch.as_tensor(rng.normal(size=(700, k)), dtype=dtype,
                        device=cuda_device)
    before = cuda_ell.LAUNCHES["ell_spmm"]
    got = cuda_ell.ell_spmm(A, X)
    assert cuda_ell.LAUNCHES["ell_spmm"] == before + 1
    assert got.shape == (1000, k)
    _assert_close(got, cuda_ell.ell_spmm_reference(A, X), bound)


@pytest.mark.parametrize("dtype,bound", BOUNDS)
@pytest.mark.parametrize("k", [4, 16])
def test_ell_spmm_misaligned_x_takes_one_column_a_lane(cuda_device, dtype,
                                                       bound, k):
    """X one element past a 16-byte boundary (a storage offset): the
    scalar path, against the plain version and the aligned run."""
    rng = np.random.default_rng(7)
    A = _rows(rng, 2000, 9, dtype, cuda_device)
    buf = torch.as_tensor(rng.normal(size=2000 * k + 1), dtype=dtype,
                          device=cuda_device)
    X = buf[1:].view(2000, k)
    assert X.is_contiguous() and X.data_ptr() % 16 != 0
    assert cuda_ell.spmm_plan(k, dtype, A.nnz / 2000, False)[0] is False
    got = cuda_ell.ell_spmm(A, X)
    _assert_close(got, cuda_ell.ell_spmm_reference(A, X), bound)
    _assert_close(got, cuda_ell.ell_spmm(A, X.clone()), bound)


def test_ell_spmm_refuses_what_it_cannot_take(cuda_device):
    """A non-contiguous X and an X of another row count raise ValueError
    before any launch; N = 0 and k = 0 return empty results unlaunched."""
    rng = np.random.default_rng(8)
    A = _rows(rng, 300, 6, torch.float64, cuda_device, ncols=200)
    before = cuda_ell.LAUNCHES["ell_spmm"]
    X = torch.as_tensor(rng.normal(size=(8, 200)), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ell.ell_spmm(A, X.t())
    for rows in (199, 201):
        with pytest.raises(ValueError, match=r"X must be \(200, k\)"):
            cuda_ell.ell_spmm(A, torch.zeros((rows, 8), dtype=torch.float64,
                                             device=cuda_device))
    assert cuda_ell.ell_spmm(A, X.t().contiguous()[:, :0]).shape == (300, 0)
    empty = _rows(rng, 0, 3, torch.float64, cuda_device, ncols=200)
    assert cuda_ell.ell_spmm(empty, X.t().contiguous()).shape == (0, 8)
    assert cuda_ell.LAUNCHES["ell_spmm"] == before


def test_ell_and_banded_matmat_run_k8(cuda_device):
    """ELLMatrix.matmat (slot-major, padded, an empty row) and
    BandedELL.matmat through K8 on the compressed rows, against the padded
    arrays' own sum, one launch each."""
    rng = np.random.default_rng(9)
    cols, vals = _ell(rng, 1024, 1024, 7, torch.float64, cuda_device)
    ell = ELLMatrix((1024, 1024), cols, vals)
    X = torch.as_tensor(rng.normal(size=(1024, 16)), device=cuda_device)
    want = (vals[:, :, None] * X[cols]).sum(0)
    before = cuda_ell.LAUNCHES["ell_spmm"]
    _assert_close(ell.matmat(X), want, 1e-12)
    csr = CSRMatrix.from_coo(
        1024, 1024, np.tile(np.arange(1024), 7), cols.cpu().numpy().ravel(),
        vals.cpu().numpy().ravel(), device=cuda_device)
    _assert_close(BandedELL.from_csr(csr).matmat(X), want, 1e-12)
    assert cuda_ell.LAUNCHES["ell_spmm"] == before + 2


def test_ilut_neumann_solve_on_card_matches_cpu(cuda_device):
    """The reference-parity ILU solve with Neumann sweeps (path (a)) on the
    card against the CPU at n=16 (74 iterations in f64 on the CPU); every
    sweep is one K7 launch on the card."""
    kw = dict(n=16, eta_n=100.0, pc="lsc_ilut", ilut_apply="neumann",
              tol=1e-8, maxiter=150)
    before = cuda_ell.LAUNCHES["ell_spmv"]
    gpu = solve_multiphase(**kw, device=cuda_device)
    assert cuda_ell.LAUNCHES["ell_spmv"] > before
    cpu = solve_multiphase(**kw, device="cpu")
    assert gpu.converged and abs(gpu.iters - cpu.iters) <= 2
    assert gpu.error_norms["l2"] == pytest.approx(cpu.error_norms["l2"],
                                                  rel=1e-6)


def _random_operator(n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    cell, xpt, ypt = (rng.uniform(0.1, 0.9, (n, n)) for _ in range(3))
    op = operator_from_numpy(cell, xpt, ypt,
                             dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0,
                                  eta_s=1.0), device=device, dtype=dtype)
    x = torch.as_tensor(rng.normal(size=(5, n, n)), dtype=dtype,
                        device=device)
    return op, x


def _shifted(t):
    """A contiguous copy of `t` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype,bound", BOUNDS)
@pytest.mark.parametrize("n", [1, 8, 50, 512, 1000])
def test_f_apply_matches_plain_and_k2(cuda_device, dtype, bound, n):
    """K1 (several points a thread, register windows) against its plain
    version and against K2's first four outputs on the same state with
    p = 0, at sizes that are and are not multiples of its points per
    thread; then on misaligned planes (its scalar-load path)."""
    op, x = _random_operator(n, dtype, cuda_device, seed=n)
    x[4] = 0.0
    planes = (op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt)
    scal = (op.params, op.grid.dx, op.grid.dy)
    args = (*planes, x[:4].contiguous(), *scal)
    before = cuda_stencil.LAUNCHES["f_apply"]
    got = cuda_stencil.f_apply(*args)
    assert cuda_stencil.LAUNCHES["f_apply"] == before + 1
    _assert_close(got, cuda_stencil.f_apply_reference(*args), bound)
    _assert_close(got, cuda_stencil.a_apply(*planes, x, *scal)[:4], bound)
    shifted = (*(_shifted(t) for t in args[:4]), *scal)
    _assert_close(cuda_stencil.f_apply(*shifted), got, bound)


@pytest.mark.parametrize("dtype,bound", BOUNDS)
@pytest.mark.parametrize("n", [1, 50, 51, 512, 1000])
def test_a_apply_matches_plain(cuda_device, dtype, bound, n):
    """K2 (register windows, several points a thread) against its plain
    version at sizes that are (50, 512, 1000) and are not (1, 51) multiples
    of its points per thread, then on misaligned planes (its scalar-load
    path)."""
    op, x = _random_operator(n, dtype, cuda_device, seed=n + 1)
    args = (op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt, x,
            op.params, op.grid.dx, op.grid.dy)
    before = cuda_stencil.LAUNCHES["a_apply"]
    got = cuda_stencil.a_apply(*args)
    assert cuda_stencil.LAUNCHES["a_apply"] == before + 1
    _assert_close(got, cuda_stencil.a_apply_reference(*args), bound)
    shifted = (*(_shifted(t) for t in args[:4]), *args[4:])
    _assert_close(cuda_stencil.a_apply(*shifted), got, bound)


# K4's tiles: its default, every tile the A-apply race runs (where it fits
# the dtype's shared memory), one-row and 40-row tiles, 32- and 64-column
# tiles (8 or 16 lanes a footprint row issue the 16-byte copies in f32),
# one that divides none of the sizes below (7 x 96), and one wider than
# the small grids (2 x 256: its footprint wraps past n)
K4_TILES = (None, *bench.PIPELINED_TILES, (1, 32), (4, 32), (8, 64),
            (16, 64), (40, 32), (7, 96), (2, 256))


def _k4_tiles(dtype):
    return [t for t in K4_TILES if t is None or
            cuda_stencil.staged_smem_bytes(t, dtype)
            <= cuda_stencil._SMEM_OPTIN_MAX]


@pytest.mark.parametrize("dtype,bound", BOUNDS)
@pytest.mark.parametrize("n", [1, 2, 3, 50, 51, 512, 1000])
def test_k3_extend_and_k4_match_plain_and_k2(cuda_device, dtype, bound, n):
    """K3 through the row extension and K4 at its tiles against the plain
    apply and against K2 on the same state, at sizes that are and are not
    multiples of their points a thread, of 16 bytes and of any tile; then
    on planes one element past a 16-byte boundary (the point-by-point
    paths). K3 and K4 run K2's arithmetic at K2's points a thread on
    register windows of the same values, so they are bit-equal to K2."""
    op, x = _random_operator(n, dtype, cuda_device, seed=n + 2)
    args = (op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt, x,
            op.params, op.grid.dx, op.grid.dy)
    want = cuda_stencil.a_apply_reference(*args)
    k2 = cuda_stencil.a_apply(*args)
    before = dict(cuda_stencil.LAUNCHES)
    got = make_fused_apply_kernel(op, "extend")(x)
    assert cuda_stencil.LAUNCHES["a_apply_band"] == \
        before["a_apply_band"] + 1
    _assert_close(got, want, bound)
    assert torch.equal(got, k2)
    ext = (_extend_rows(args[0], 1), *args[1:3], _extend_rows(x, 1))
    shifted = (*(_shifted(t) for t in ext), *args[4:], 1)
    _assert_close(cuda_stencil.a_apply_band(*shifted), want, bound)
    tiles = _k4_tiles(dtype)
    for tile in tiles:
        got = cuda_stencil.a_apply_staged(*args, tile=tile)
        _assert_close(got, want, bound)
        assert torch.equal(got, k2), tile
    shifted = (*(_shifted(t) for t in args[:4]), *args[4:])
    _assert_close(cuda_stencil.a_apply_staged(*shifted), want, bound)
    assert cuda_stencil.LAUNCHES["a_apply_staged"] == \
        before["a_apply_staged"] + len(tiles) + 1


@pytest.mark.parametrize("h", [1, 2, 8])
@pytest.mark.parametrize("dtype,bound", BOUNDS)
def test_k3_on_a_band_matches_plain_and_k2(cuda_device, dtype, bound, h):
    """A band of n_loc=24 rows of a random n=50 grid, its h halo rows the
    grid's neighbour rows (not periodic within the band): K3 against its
    plain version and against those rows of K2's full apply."""
    n, n_loc, r0 = 50, 24, 13
    op, x = _random_operator(n, dtype, cuda_device, seed=1)
    tn, wx, wy = op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt
    band = (tn[r0 - h:r0 + n_loc + h].contiguous(),
            wx[r0:r0 + n_loc].contiguous(), wy[r0:r0 + n_loc].contiguous(),
            x[:, r0 - h:r0 + n_loc + h].contiguous(), op.params, op.grid.dx,
            op.grid.dy, h)
    got = cuda_stencil.a_apply_band(*band)
    _assert_close(got, cuda_stencil.a_apply_band_reference(*band), bound)
    k2 = cuda_stencil.a_apply(tn, wx, wy, x, op.params, op.grid.dx,
                              op.grid.dy)
    _assert_close(got, k2[:, r0:r0 + n_loc].contiguous(), bound)


def test_k4_tile_out_of_shared_memory_raises(cuda_device):
    op, x = _random_operator(16, torch.float64, cuda_device)
    args = (op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt, x,
            op.params, op.grid.dx, op.grid.dy)
    with pytest.raises(ValueError):
        cuda_stencil.a_apply_staged(*args, tile=(64, 256))


@pytest.mark.parametrize("halo", ["inkernel", "extend", "pipelined"])
def test_ir_solve_on_card_matches_cpu(cuda_device, halo):
    """The ir time-to-solve benchmark at n=16 on the card with each f32
    matvec kernel against the same benchmark on the CPU: converged to
    1e-8 and the same L2 to 1e-4."""
    from mpbp_tpu_torch import bench_solve

    kernel = {"inkernel": "a_apply", "extend": "a_apply_band",
              "pipelined": "a_apply_staged"}[halo]
    argv = ["--n", "16", "--halo", halo]
    before = cuda_stencil.LAUNCHES[kernel]
    gpu = bench_solve.main(argv + ["--device", str(cuda_device)])
    assert cuda_stencil.LAUNCHES[kernel] > before
    cpu = bench_solve.main(argv + ["--device", "cpu"])
    assert gpu["converged"] and gpu["true_relres"] < 1e-8
    assert gpu["error_l2"] == pytest.approx(cpu["error_l2"], rel=1e-4)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(n=8, eta_n=1.0, eta_s=1.0, pc="exact_schur", tol=1e-8,
                      maxiter=40), id="exact_schur"),
    pytest.param(dict(n=16, eta_n=100.0, eta_s=1.0, pc="lsc_mg_krylov",
                      tol=1e-8, maxiter=60, inner_tol=1e-5, inner_iters=60),
                 id="lsc_mg_krylov")])
def test_slice8_kinds_on_card_match_cpu(cuda_device, kw):
    """The exact_schur (dense matmuls, K2 outer matvec) and lsc_mg_krylov
    (K1 inner matvec, K2 outer) solves on the card against the same solves
    on the CPU: the same iteration count and the CPU's solution within
    1e-8 relative."""
    before = dict(cuda_stencil.LAUNCHES)
    gpu = solve_multiphase(**kw, device=cuda_device)
    assert cuda_stencil.LAUNCHES["a_apply"] > before["a_apply"]
    if kw["pc"] == "lsc_mg_krylov":
        assert cuda_stencil.LAUNCHES["f_apply"] > before["f_apply"]
    cpu = solve_multiphase(**kw, device="cpu")
    assert gpu.converged and cpu.converged
    assert gpu.iters == cpu.iters
    scale = float(cpu.x.abs().max())
    assert float((gpu.x.cpu() - cpu.x).abs().max()) <= 1e-8 * scale


def _k3_on_bands(op, x, splits):
    """K3 on the grid cut into row bands of the given sizes, each extended
    by its neighbours' edge rows (what the ring exchange delivers, wrapped
    at the grid's ends), concatenated."""
    tn, wx, wy = op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt
    n = tn.shape[0]
    outs, r0 = [], 0
    for nl in splits:
        ext = torch.arange(r0 - 1, r0 + nl + 1, device=x.device) % n
        outs.append(cuda_stencil.a_apply_band(
            tn[ext].contiguous(), wx[r0:r0 + nl].contiguous(),
            wy[r0:r0 + nl].contiguous(), x[:, ext].contiguous(), op.params,
            op.grid.dx, op.grid.dy, 1))
        r0 += nl
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [50, 512, 1000])
def test_k3_on_four_exchanged_bands_equals_k2(cuda_device, dtype, n):
    """The sharded matvec's arithmetic: K3 on 4 row bands (n=50: 13, 13,
    12, 12 rows), each with the neighbour rows the halo exchange brings,
    concatenated, bit-equal to K2 on the whole grid."""
    op, x = _random_operator(n, dtype, cuda_device, seed=n + 3)
    splits = [len(s) for s in np.array_split(np.arange(n), 4)]
    before = cuda_stencil.LAUNCHES["a_apply_band"]
    got = _k3_on_bands(op, x, splits)
    assert cuda_stencil.LAUNCHES["a_apply_band"] == before + 4
    k2 = cuda_stencil.a_apply(op.phase_n.cell, op.phase_n.xface_pt,
                              op.phase_n.yface_pt, x, op.params, op.grid.dx,
                              op.grid.dy)
    torch.cuda.synchronize()
    assert torch.equal(got, k2)


def test_sharded_solve_on_one_nccl_rank_matches_cpu_gloo(cuda_device):
    """solve_multiphase_sharded on one NCCL rank on the card (K3 every
    outer matvec and F apply) against the same call on one gloo rank on
    the CPU: converged, count within 2, L2 within 1%."""
    import torch.distributed as dist

    from mpbp_tpu_torch.drivers import solve_multiphase_sharded

    kw = dict(n=64, eta_n=100.0, pc="mg", precision="hybrid", tol=1e-8,
              maxiter=40)
    before = cuda_stencil.LAUNCHES["a_apply_band"]
    try:
        gpu = solve_multiphase_sharded(**kw, device=cuda_device)
        assert dist.get_backend() == "nccl"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert cuda_stencil.LAUNCHES["a_apply_band"] > before
    try:
        cpu = solve_multiphase_sharded(**kw, device="cpu")
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    msg = f"card {gpu.iters}, cpu {cpu.iters}"
    assert gpu.converged and cpu.converged, msg
    assert abs(gpu.iters - cpu.iters) <= 2, msg
    assert gpu.params["true_relres"] <= 10 * kw["tol"]
    assert abs(gpu.error_norms["l2"] - cpu.error_norms["l2"]) <= \
        0.01 * cpu.error_norms["l2"]


def test_sharded_solve_on_four_nccl_ranks_matches_one(cuda_device, tmp_path):
    """solve_multiphase_sharded on 4 NCCL ranks, one card each (halo rows
    through NCCL point to point, all-reduces, the coarse MG gathers),
    against the same call on one NCCL rank: converged, counts within 2,
    L2 within 1%, K3 launched on every rank. Needs 4 cards."""
    import torch.distributed as dist

    import torch_rank_fns as rf
    from mpbp_tpu_torch.drivers import solve_multiphase_sharded

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs (one NCCL rank a card)")
    kw = dict(n=256, eta_n=100.0, pc="mg", precision="hybrid", tol=1e-10,
              maxiter=60)
    four = rf.run_ranks("driver", 4, tmp_path, timeout=600, device="cuda",
                        **kw)
    try:
        one = solve_multiphase_sharded(**kw, device=cuda_device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    msg = f"4 ranks {four[0]['iters']}, 1 rank {one.iters}"
    assert all(r["devices"] == 4 and r["k3_launches"] > 0 for r in four)
    assert all(r["iters"] == four[0]["iters"] for r in four)
    assert four[0]["converged"] and one.converged, msg
    assert abs(four[0]["iters"] - one.iters) <= 2, msg
    assert four[0]["true_relres"] <= kw["tol"]
    assert abs(four[0]["l2"] - one.error_norms["l2"]) <= \
        0.01 * one.error_norms["l2"]
