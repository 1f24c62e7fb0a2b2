"""The port's sparse-matrix layer against the JAX package on the same
numpy-seeded inputs (CPU): the CSR/DIA exports of the stencil operators,
the CSR/ELL/BSR/COO matvecs, the plain versions of kernels K5-K8 against
the Pallas kernels in interpret mode, the Neumann epilogue, K8's launch
plan and X-shape check, and `best_spmv`'s path names."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu import native
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu.ops import dia as jax_dia
from mpbp_tpu.ops import dispatch as jax_dispatch
from mpbp_tpu.ops import pallas_dia, pallas_ell
from mpbp_tpu.ops import sparse as jax_sparse
from mpbp_tpu.ops import trisolve as jax_trisolve
from mpbp_tpu.solvers.preconditioners import lsc_products as jax_lsc_products
from mpbp_tpu_torch.ops import cuda_dia, cuda_ell, dispatch, stencil, trisolve
from mpbp_tpu_torch.ops.cuda_ell import BandedELL
from mpbp_tpu_torch.ops.dia import DIAMatrix
from mpbp_tpu_torch.ops.sparse import (BSRMatrix, COOMatrix, CSRMatrix,
                                       spgemm_csr)

torch.set_num_threads(1)


def port_stencil(jop):
    """The port's StencilOperator on exactly the JAX operator's planes."""
    terms = {k: {o: torch.tensor(np.asarray(c)) for o, c in om.items()}
             for k, om in jop.terms.items()}
    return stencil.StencilOperator(jop.out_fields, jop.in_fields, terms,
                                   jop.shape_grid)


def port_csr(jcsr, device="cpu"):
    return CSRMatrix.from_numpy(jcsr.shape, *jcsr.host_arrays(),
                                device=device)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def jop16():
    return jax_make_operator(16, eta_n=100.0)


@pytest.fixture(scope="module")
def gtg_u_factor(jop16):
    """The strict upper triangle of GtG's ILUT(100, 1e-3) factor at n=16
    (256 rows), as a JAX CSR, with its diagonal."""
    csr = jax_lsc_products(jop16)[0].to_csr(drop_tol=1e-14)
    _, (Up, Ui, Uv) = native.ilut(*csr.host_arrays(), fill=100, tau=1e-3)
    n = len(Up) - 1
    keep = np.ones(len(Ui), bool)
    keep[Up[:-1]] = False
    ptr = np.zeros(n + 1, np.int64)
    ptr[1:] = np.cumsum(np.diff(Up) - 1)
    strict = jax_sparse.CSRMatrix((n, n), ptr, jnp.asarray(Ui[keep]),
                                  jnp.asarray(Uv[keep]))
    return strict, Uv[Up[:-1]]


@pytest.mark.parametrize("block", ["A", "F", "G", "minus_D", "GtG"])
def test_to_csr_and_to_dia_are_bitwise_equal_to_jax(jop16, block):
    jop = (jax_lsc_products(jop16)[0] if block == "GtG"
           else getattr(jop16, block))
    top = port_stencil(jop)
    assert top.nnz_per_row_bound() == jop.nnz_per_row_bound()
    for tol in (0.0, 1e-14):
        got, want = top.to_csr(drop_tol=tol), jop.to_csr(drop_tol=tol)
        assert got.shape == want.shape
        for g, w in zip(got.host_arrays(), want.host_arrays()):
            np.testing.assert_array_equal(g, w)
        assert got.indices.dtype == torch.int32
    if block in ("A", "F", "GtG"):
        got, want = top.to_dia(), jop.to_dia()
        assert got.offsets == want.offsets and got.shape == want.shape
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        got32 = top.to_dia(np.float32)
        assert got32.data.dtype == torch.float32


def test_csr_ell_bsr_coo_matvecs_match_jax(jop16):
    rng = np.random.default_rng(0)
    jcsr = jop16.A.to_csr()
    csr = port_csr(jcsr)
    x = rng.normal(size=csr.shape[1])
    X = rng.normal(size=(csr.shape[1], 3))
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    want = np.asarray(jcsr.matvec(jx))
    close(csr.matvec(tx), want, 1e-12)
    np.testing.assert_array_equal(csr.to_dense(), jcsr.to_dense())
    np.testing.assert_array_equal(csr.transpose().to_dense(),
                                  jcsr.transpose().to_dense())
    pruned, jpruned = csr.prune(1.0), jcsr.prune(1.0)
    for g, w in zip(pruned.host_arrays(), jpruned.host_arrays()):
        np.testing.assert_array_equal(g, w)

    # the port stores the JAX package's (nrows, width) arrays slot-major
    ell, jell = csr.to_ell(), jcsr.to_ell()
    np.testing.assert_array_equal(ell.cols.numpy().T, np.asarray(jell.cols))
    np.testing.assert_array_equal(ell.vals.numpy().T, np.asarray(jell.vals))
    assert ell.cols.is_contiguous() and ell.vals.is_contiguous()
    assert ell.width == jell.width and ell.nnz == jell.nnz
    close(ell.matvec(tx), jell.matvec(jx), 1e-12)
    close(ell.matmat(torch.as_tensor(X)), jell.matmat(jnp.asarray(X)), 1e-12)

    bsr = BSRMatrix.from_csr(csr, 16)
    jbsr = jax_sparse.BSRMatrix.from_csr(jcsr, 16)
    np.testing.assert_array_equal(bsr.bcols.numpy(), np.asarray(jbsr.bcols))
    close(bsr.matvec(tx), jbsr.matvec(jx), 1e-12)

    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    coo = COOMatrix(csr.shape, torch.as_tensor(rows, dtype=torch.int32),
                    csr.indices, csr.vals)
    close(coo.matvec(tx), want, 1e-12)
    np.testing.assert_array_equal(coo.to_dense(), jcsr.to_dense())
    for g, w in zip(coo.to_csr().host_arrays(), jcsr.host_arrays()):
        np.testing.assert_array_equal(g, w)


def test_spgemm_csr_matches_jax(jop16):
    jmd, jg = jop16.minus_D.to_csr(), jop16.G.to_csr()
    got = spgemm_csr(port_csr(jmd), port_csr(jg))
    want = jax_sparse.spgemm_csr(jmd, jg)
    for g, w in zip(got.host_arrays(), want.host_arrays()):
        np.testing.assert_array_equal(g, w)


def test_dia_spmv_reference_matches_matvec_and_pallas(jop16):
    """Square periodic A at n=16 (N=1280, K=35): the port's DIAMatrix
    (from the JAX layout) against JAX's roll form and the Pallas kernel
    K5 in interpret mode, f64 at 1e-12 relative to max|y|."""
    jA = jop16.A.to_dia()
    A = DIAMatrix.from_numpy(jA.shape, jA.offsets, np.asarray(jA.data),
                             device="cpu")
    x = np.random.default_rng(1).normal(size=A.shape[1])
    got = cuda_dia.dia_spmv_reference(A, torch.as_tensor(x))
    torch.testing.assert_close(A.matvec(torch.as_tensor(x)), got, rtol=0,
                               atol=0)
    close(got, jA.matvec(jnp.asarray(x)), 1e-12)
    close(got, pallas_dia.dia_spmv_pallas(jA, interpret=True)(
        jnp.asarray(x)), 1e-12)
    np.testing.assert_array_equal(A.to_dense(), jA.to_dense())


@pytest.mark.parametrize("block", ["G", "minus_D"])
def test_dia_spmv_reference_rectangular_signed_offsets(jop16, block):
    """Non-periodic (signed, some negative) offsets on the rectangular G
    (tall) and -D (wide): the port's from_csr and matvec against JAX's."""
    jcsr = getattr(jop16, block).to_csr(drop_tol=0.0)
    jD = jax_dia.DIAMatrix.from_csr(jcsr, periodic=False)
    D = DIAMatrix.from_csr(port_csr(jcsr), periodic=False)
    assert D.offsets == jD.offsets and min(D.offsets) < 0
    assert D.shape[0] != D.shape[1]
    np.testing.assert_array_equal(D.data.numpy(), np.asarray(jD.data))
    x = np.random.default_rng(2).normal(size=D.shape[1])
    close(cuda_dia.dia_spmv_reference(D, torch.as_tensor(x)),
          jD.matvec(jnp.asarray(x)), 1e-12)


def test_banded_ell_layout_and_absolute_columns(gtg_u_factor):
    strict, _ = gtg_u_factor
    jb = pallas_ell.BandedELL.from_csr(strict)
    b = BandedELL.from_csr(port_csr(strict))
    assert (b.shape, b.offsets, b.widths) == (jb.shape, jb.offsets,
                                              jb.widths)
    np.testing.assert_array_equal(b.idx.numpy(), np.asarray(jb.idx))
    np.testing.assert_array_equal(b.vals.numpy(), np.asarray(jb.vals))
    assert b.nnz == jb.nnz == strict.nnz and b.total_width == jb.total_width
    ell = BandedELL.from_numpy(jb.shape, jb.offsets, jb.widths,
                               np.asarray(jb.idx), np.asarray(jb.vals),
                               device="cpu").to_ell()
    assert ell.cols.dtype == torch.int32
    assert ell.cols.shape == (jb.total_width, strict.shape[0])
    # every stored entry sits at its CSR column
    dense = np.zeros(strict.shape)
    np.add.at(dense, (np.arange(strict.shape[0])[None, :],
                      ell.cols.numpy()), ell.vals.numpy())
    np.testing.assert_array_equal(dense, strict.to_dense())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ell_references_match_pallas_interpret(gtg_u_factor, dtype):
    """K7/K8 plain versions against ell_spmv_pallas / ell_spmm_pallas in
    interpret mode on BandedELL of GtG's ILUT U factor at n=16 (the Pallas
    kernels take f32; f64 is held against the JAX container's XLA path)."""
    strict, _ = gtg_u_factor
    jcsr = jax_sparse.CSRMatrix(strict.shape, strict.indptr, strict.indices,
                                strict.vals.astype(dtype))
    jb = pallas_ell.BandedELL.from_csr(jcsr)
    ell = BandedELL.from_csr(port_csr(jcsr)).to_ell()
    rows = ell.compressed
    assert rows.nnz == strict.nnz and rows.vals.dtype == ell.vals.dtype
    rng = np.random.default_rng(3)
    x = rng.normal(size=strict.shape[0]).astype(dtype)
    X = rng.normal(size=(strict.shape[0], 5)).astype(dtype)
    got = cuda_ell.ell_spmv_reference(rows, torch.as_tensor(x))
    got_mm = cuda_ell.ell_spmm_reference(rows, torch.as_tensor(X))
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    close(got, jb.matvec(jnp.asarray(x)), rtol)
    if dtype == np.float32:
        close(got, pallas_ell.ell_spmv_pallas(jb, interpret=True)(
            jnp.asarray(x)), rtol)
        close(got_mm, pallas_ell.ell_spmm_pallas(jb, 5, interpret=True)(
            jnp.asarray(X)), rtol)
    else:
        close(got_mm, np.asarray(jcsr.to_dense()) @ X, rtol)
    # the wrappers take the plain versions on CPU tensors
    torch.testing.assert_close(cuda_ell.ell_spmv(rows, torch.as_tensor(x)),
                               got)
    torch.testing.assert_close(ell.matmat(torch.as_tensor(X)), got_mm)


@pytest.fixture(scope="module")
def spmm_operands(jop16, gtg_u_factor):
    """K8's CPU operands as JAX CSRs: GtG's strict ILUT U factor at n=16
    (256 x 256) with every fifth row emptied as well (its last row is
    empty already), and the tall G (1024 x 256)."""
    strict, _ = gtg_u_factor
    indptr, idx, v = strict.host_arrays()
    rows = np.repeat(np.arange(strict.shape[0]), np.diff(indptr))
    keep = rows % 5 != 2
    ptr = np.zeros(strict.shape[0] + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(rows[keep], minlength=strict.shape[0]))
    square = jax_sparse.CSRMatrix(strict.shape, ptr,
                                  jnp.asarray(np.asarray(idx)[keep]),
                                  jnp.asarray(np.asarray(v)[keep]))
    return {"square": square, "rectangular": jop16.G.to_csr()}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 4, 16, 33, 130])
@pytest.mark.parametrize("matrix", ["square", "rectangular"])
def test_ell_spmm_reference_matches_jax(spmm_operands, matrix, k, dtype):
    """The plain K8 on compressed rows against the JAX package's ELL
    matmat, and on the square matrix in f32 against ell_spmm_pallas in
    interpret mode (the Pallas kernel takes f32 and square matrices only):
    f32 within 3e-5 (as tests/test_pallas_ell.py), f64 within 1e-12, both
    relative to max|Y|. The CPU path of ELLMatrix.matmat is that plain
    version."""
    src = spmm_operands[matrix]
    jcsr = jax_sparse.CSRMatrix(src.shape, src.indptr, src.indices,
                                src.vals.astype(dtype))
    ell = port_csr(jcsr).to_ell()
    rows = ell.compressed
    if matrix == "square":
        assert np.diff(rows.rowptr.numpy()).min() == 0   # empty rows
    X = np.random.default_rng(6).normal(size=(src.shape[1], k)).astype(dtype)
    got = cuda_ell.ell_spmm_reference(rows, torch.as_tensor(X))
    assert got.shape == (src.shape[0], k) and got.dtype == rows.vals.dtype
    rtol = 3e-5 if dtype == np.float32 else 1e-12
    close(got, jcsr.to_ell().matmat(jnp.asarray(X)), rtol)
    if matrix == "square" and dtype == np.float32:
        jb = pallas_ell.BandedELL.from_csr(jcsr)
        close(got, pallas_ell.ell_spmm_pallas(jb, k, interpret=True)(
            jnp.asarray(X)), rtol)
    assert torch.equal(ell.matmat(torch.as_tensor(X)), got)


@pytest.mark.parametrize("x_rows", [2, 5])
@pytest.mark.parametrize("entry", ["ell_spmm", "ELLMatrix.matmat",
                                   "BandedELL.matmat"])
def test_spmm_refuses_an_x_of_another_row_count(entry, x_rows):
    """A 3x3 operand with an X of 2 or 5 rows raises ValueError through
    every entry point, where the JAX package's gather clamps the short X
    and ignores the long one's extra rows; nothing is launched."""
    csr = CSRMatrix.from_coo(3, 3, [0, 1, 2, 2], [0, 2, 1, 2],
                             [1.0, 2.0, 3.0, 4.0], device="cpu")
    X = torch.ones((x_rows, 2), dtype=torch.float64)
    call = {"ell_spmm": lambda: cuda_ell.ell_spmm(csr.to_ell().compressed,
                                                  X),
            "ELLMatrix.matmat": lambda: csr.to_ell().matmat(X),
            "BandedELL.matmat": lambda: BandedELL.from_csr(csr).matmat(X)}
    before = dict(cuda_ell.LAUNCHES)
    with pytest.raises(ValueError, match=r"X must be \(3, k\)"):
        call[entry]()
    assert cuda_ell.LAUNCHES == before
    assert csr.to_ell().matmat(torch.ones((3, 2), dtype=torch.float64)
                               ).shape == (3, 2)


def test_spmm_checks_x_before_its_device():
    """The row-count check comes before the device's: on a device with no
    kernel (meta) a short X raises the shape's ValueError, a right one the
    device's."""
    rows = cuda_ell.CompressedRows(
        (3, 3), torch.zeros(4, dtype=torch.int32, device="meta"),
        torch.zeros(4, dtype=torch.int32, device="meta"),
        torch.zeros(4, dtype=torch.float64, device="meta"), 2)
    with pytest.raises(ValueError, match="X must be"):
        cuda_ell.ell_spmm(rows, torch.ones((2, 4), dtype=torch.float64,
                                           device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        cuda_ell.ell_spmm(rows, torch.ones((3, 4), dtype=torch.float64,
                                           device="meta"))


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("k,dtype,aligned,mean_row,want", [
    (16, F32, True, 5, (True, 4, 4)),       # GtG's k: 4 lanes a row
    (16, F64, True, 5, (True, 8, 8)),       # 8 lanes, 4 rows a warp
    (16, F32, False, 5, (False, 16, 16)),   # misaligned X: one column a lane
    (4, F32, True, 5, (True, 1, 8)),        # one chunk: entries split
    (2, F64, True, 5, (True, 1, 8)),
    (1, F32, True, 5, (False, 1, 8)),
    (1, F64, True, 100, (False, 1, 32)),
    (1, F64, True, 0.5, (False, 1, 1)),
    (2, F32, True, 5, (False, 2, 8)),
    (3, F64, True, 5, (False, 4, 4)),
    (33, F32, True, 5, (False, 32, 32)),    # two column tiles
    (130, F32, True, 5, (False, 32, 32)),   # five
    (130, F64, True, 5, (True, 32, 32)),    # 65 chunks: three
    (256, F32, True, 5, (True, 32, 32)),
])
def test_spmm_plan(k, dtype, aligned, mean_row, want):
    assert cuda_ell.spmm_plan(k, dtype, mean_row, aligned) == want


def test_ell_epilogue_matches_neumann_sweeps(gtg_u_factor):
    strict, diag = gtg_u_factor
    n = strict.shape[0]
    rng = np.random.default_rng(4)
    b = rng.normal(size=n)
    rows = cuda_ell.CompressedRows.from_arrays((n, n), *strict.host_arrays(),
                                               device="cpu")
    # the JAX package's padded sweep operand holds these entries, row by
    # row, and zeros
    jcols, jvals = (np.asarray(a) for a in
                    jax_trisolve.strict_ell_from_csr(*strict.host_arrays(), n))
    keep = jvals != 0
    np.testing.assert_array_equal(keep.sum(1), np.diff(rows.rowptr.numpy()))
    np.testing.assert_array_equal(jcols[keep], rows.cols.numpy())
    np.testing.assert_array_equal(jvals[keep], rows.vals.numpy())
    tb, td = torch.as_tensor(b), torch.as_tensor(diag)
    x = torch.as_tensor(rng.normal(size=n))
    inv_d = 1.0 / td
    one = cuda_ell.ell_spmv(rows, x, b=tb, inv_d=inv_d)
    torch.testing.assert_close(
        one, inv_d * (tb - cuda_ell.ell_spmv(rows, x)), rtol=0, atol=0)
    torch.testing.assert_close(rows.matvec(x), cuda_ell.ell_spmv(rows, x),
                               rtol=0, atol=0)
    got = trisolve.neumann_trisolve(rows, td, tb, 7)
    want = jax_trisolve.neumann_sweeps_with(
        lambda v: strict.matvec(v), jnp.asarray(diag), jnp.asarray(b), 7)
    close(got, want, 1e-12)
    close(trisolve.neumann_sweeps_with(
        lambda v: cuda_ell.ell_spmv(rows, v), td, tb, 7), want, 1e-12)


def test_best_spmv_paths_match_jax(jop16, gtg_u_factor):
    """Where the JAX package's TPU gates pass (square, N % 128 == 0, fits
    VMEM), both pick the same path, and the matvecs agree."""
    strict, _ = gtg_u_factor
    mats = {"A": jop16.A.to_csr(), "F": jop16.F.to_csr(),
            "GtG": jax_lsc_products(jop16)[0].to_csr(drop_tol=1e-14),
            "U": strict}
    x = np.random.default_rng(5).normal(size=1280)
    paths = {}
    for name, jcsr in mats.items():
        # f32: the JAX package's kernels take no other dtype
        _, jpath = jax_dispatch.best_spmv(jcsr, jnp.float32)
        mv, path = dispatch.best_spmv(port_csr(jcsr), torch.float64)
        paths[name] = path
        assert path == jpath.replace("_streamed", ""), name
        xs = x[:jcsr.shape[0]]
        close(mv(torch.as_tensor(xs)), jcsr.matvec(jnp.asarray(xs)), 1e-12)
    assert paths["GtG"] == "dia" and paths["U"] == "ell"
    # a rectangular matrix takes the ELL path; an integer dtype has none
    _, path = dispatch.best_spmv(port_csr(jop16.G.to_csr()), torch.float64)
    assert path == "ell"
    with pytest.raises(TypeError):
        dispatch.best_spmv(port_csr(strict), torch.int64)


def test_wrappers_check_their_operands():
    x = torch.ones(4, dtype=torch.float64)
    rows = cuda_ell.CompressedRows.from_arrays((4, 4), [0, 1, 1, 2, 2],
                                               [0, 3], [1.0, 2.0],
                                               device="cpu")
    with pytest.raises(TypeError, match="int32"):
        cuda_ell.ell_spmv(dataclasses.replace(rows, cols=rows.cols.long()), x)
    with pytest.raises(TypeError):
        cuda_ell.ell_spmv(rows, x.float())
    with pytest.raises(ValueError, match="both"):
        cuda_ell.ell_spmv(rows, x, b=x)
    with pytest.raises(ValueError):
        cuda_ell.ell_spmv(rows, torch.ones(5, dtype=torch.float64))
    with pytest.raises(TypeError, match="int32"):
        cuda_ell.ell_spmm(dataclasses.replace(rows, cols=rows.cols.long()),
                          x[:, None])
    with pytest.raises(TypeError):
        cuda_ell.ell_spmm(rows, x[:, None].float())
    with pytest.raises(ValueError):
        cuda_ell.ell_spmm(rows, x)
    A = DIAMatrix.from_numpy((4, 4), (0, -1), np.ones((2, 4)), device="cpu")
    with pytest.raises(ValueError):
        cuda_dia.dia_spmv(A, torch.ones(5, dtype=torch.float64))
    with pytest.raises(TypeError):
        cuda_dia.dia_spmv(A, torch.ones(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="no kernel"):
        cuda_dia.dia_spmv(A.__class__((4, 4), (0,), torch.ones(
            (1, 4), dtype=torch.float64, device="meta")),
            torch.ones(4, dtype=torch.float64, device="meta"))
