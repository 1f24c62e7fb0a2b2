"""Kernel K7's operand, `CompressedRows`, on the CPU: its plain version
against the padded slot-major ELL sum on the same rows (rows of length 0,
rows longer than the lane group, the ILU factors of path (a)), its lane
group on the factors the Neumann sweeps run, and `NeumannTriSolve` against
the JAX package's on the same factors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.ops import trisolve as jax_trisolve
from mpbp_tpu_torch import native
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.ops import cuda_ell, trisolve
from mpbp_tpu_torch.ops.cuda_ell import CompressedRows, group_size
from mpbp_tpu_torch.ops.ilu import ILUPreconditioner
from mpbp_tpu_torch.ops.sparse import ELLMatrix
from mpbp_tpu_torch.solvers.preconditioners import lsc_products

torch.set_num_threads(1)


def strict_ell_from_csr(indptr, indices, vals, n: int) -> ELLMatrix:
    """The padded slot-major ELL of a strictly-triangular CSR part, padding
    self-references with value 0 (the JAX package's Neumann operand, in the
    port's slot-major container): the padded reference of K7's operand."""
    indptr = np.asarray(indptr, np.int64)
    counts = np.diff(indptr)
    K = max(1, int(counts.max()) if n else 1)
    cols = np.tile(np.arange(n, dtype=np.int32)[None, :], (K, 1))
    vmat = np.zeros((K, n))
    r = np.repeat(np.arange(n), counts)
    slot = np.arange(indptr[-1], dtype=np.int64) - np.repeat(indptr[:-1],
                                                             counts)
    cols[slot, r] = np.asarray(indices, np.int32)
    vmat[slot, r] = np.asarray(vals, np.float64)
    return ELLMatrix((n, n), torch.tensor(cols), torch.tensor(vmat))


def padded_sum(ell: ELLMatrix, x, b=None, inv_d=None):
    """The padded slot-major ELL's plain version: every slot, padding
    included, summed over the slots."""
    acc = (ell.vals * x[ell.cols]).sum(0)
    return acc if b is None else inv_d * (b - acc)


def strict_factors(n: int):
    """Host CSR arrays of the strict triangles that path (a)'s Neumann
    sweeps run at grid n: F's ILUT(400, 3e-5) and GtG's ILUT(100, 1e-3)
    L and U, U's diagonal split off as `ILUPreconditioner` does."""
    op = make_multiphase_operator(n, eta_n=100.0, device="cpu")
    out = {}
    for name, csr, fill, tau in (
            ("F", op.F.to_csr(drop_tol=1e-14), 400, 3e-5),
            ("GtG", lsc_products(op)[0].to_csr(drop_tol=1e-14), 100, 1e-3)):
        (Lp, Li, Lv), (Up, Ui, Uv) = native.ilut(*csr.host_arrays(),
                                                 fill=fill, tau=tau)
        keep = np.ones(len(Ui), bool)
        keep[Up[:-1]] = False
        ptr = np.zeros(len(Up), np.int64)
        ptr[1:] = np.cumsum(np.diff(Up) - 1)
        out[f"{name} L"] = (Lp, Li, Lv, None)
        out[f"{name} U"] = (ptr, Ui[keep], Uv[keep], Uv[Up[:-1]])
    return out


@pytest.fixture(scope="module")
def factors16():
    return strict_factors(16)


def random_rows(rng, N, max_row, long_row):
    lens = rng.integers(0, max_row + 1, size=N)
    lens[::5] = 0
    if N > 1:
        lens[1] = long_row
    indptr = np.concatenate([[0], np.cumsum(lens)])
    return (indptr, rng.integers(0, N, size=indptr[-1]).astype(np.int32),
            rng.normal(size=indptr[-1]))


def _vectors(rng, N):
    x, b = (torch.as_tensor(rng.normal(size=N)) for _ in range(2))
    return x, b, torch.as_tensor(1.0 + rng.random(N))


@pytest.mark.parametrize("N,max_row,long_row", [(1, 0, 0), (300, 6, 40),
                                                (1000, 60, 400)])
def test_rows_match_padded_ell(N, max_row, long_row):
    """Random rows, empty ones every fifth and row 1 longer than any
    group: the compressed operand (from the CSR arrays and from the padded
    ELL) against the padded sum, f64 to 1e-14, with and without the
    epilogue."""
    rng = np.random.default_rng(N)
    indptr, cols, vals = random_rows(rng, N, max_row, long_row)
    A = CompressedRows.from_arrays((N, N), indptr, cols, vals, device="cpu")
    assert A.nnz == indptr[-1]
    assert long_row == 0 or long_row > A.group
    ell = strict_ell_from_csr(indptr, cols, vals, N)
    B = ell.compressed
    assert B.group == A.group
    x, b, inv_d = _vectors(rng, N)
    want, want_epi = padded_sum(ell, x), padded_sum(ell, x, b, inv_d)
    scale = max(float(want.abs().max()), 1.0)
    for op in (A, B):
        for got, ref in ((cuda_ell.ell_spmv(op, x), want),
                         (cuda_ell.ell_spmv(op, x, b, inv_d), want_epi)):
            assert float((got - ref).abs().max()) <= 1e-14 * scale
    torch.testing.assert_close(ell.matvec(x), cuda_ell.ell_spmv(B, x),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["F L", "F U", "GtG L", "GtG U"])
def test_factor_rows_match_padded_ell(factors16, name):
    ptr, idx, vals, _ = factors16[name]
    N = len(ptr) - 1
    A = CompressedRows.from_arrays((N, N), ptr, idx, vals, device="cpu")
    ell = strict_ell_from_csr(ptr, idx, vals, N)
    x, b, inv_d = _vectors(np.random.default_rng(1), N)
    for got, want in ((A.matvec(x), padded_sum(ell, x)),
                      (cuda_ell.ell_spmv(A, x, b, inv_d),
                       padded_sum(ell, x, b, inv_d))):
        assert float((got - want).abs().max()) <= 1e-14 * float(
            want.abs().max())


@pytest.mark.parametrize("dtype,want", [
    (torch.float64, [2, 2, 4, 8, 16, 32, 32, 32]),
    (torch.float32, [2, 2, 2, 4, 8, 16, 32, 32])])
def test_group_size(dtype, want):
    """A 16-byte load holds two f64 or four f32 entries, so f32 takes half
    the lanes for the same row."""
    assert [group_size(m, dtype)
            for m in (0, 1, 4.5, 15, 17, 33, 125, 1e6)] == want


def test_group_of_path_a_factors(factors16):
    """F's factors (fill 400) take 32 lanes a row, GtG's 8 or 16 in f64
    and 4 or 8 in f32, at n=16 and at path (a)'s n=64; `astype` picks the
    group of the new type."""
    for n, facs in ((16, factors16), (64, strict_factors(64))):
        for name, (ptr, idx, vals, _) in facs.items():
            N = len(ptr) - 1
            A = CompressedRows.from_arrays((N, N), ptr, idx, vals,
                                           device="cpu")
            A32 = CompressedRows.from_arrays((N, N), ptr, idx, vals,
                                             torch.float32, device="cpu")
            want = {32} if name.startswith("F") else {8, 16}
            if n == 16 and name == "F L":
                want = {16, 32}   # a small grid's L is short
            assert A.group in want, (n, name, A.group, A.nnz / N)
            want32 = {32} if name.startswith("F") else {4, 8}
            if n == 16 and name == "F L":
                want32 = {8, 16, 32}
            assert A32.group in want32, (n, name, A32.group, A.nnz / N)
            assert A.astype(torch.float32).group == A32.group
            assert A32.astype(torch.float64).group == A.group


@pytest.mark.parametrize("name", ["F L", "F U", "GtG L", "GtG U"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_neumann_solve_matches_jax(factors16, name, dtype, rtol):
    ptr, idx, vals, diag = factors16[name]
    N = len(ptr) - 1
    got = trisolve.NeumannTriSolve.from_csr(ptr, idx, vals, 9,
                                            diag_vals=diag, dtype=dtype,
                                            device="cpu")
    assert isinstance(got.strict, CompressedRows)
    assert got.strict.vals.dtype == dtype
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = jax_trisolve.NeumannTriSolve.from_csr(ptr, idx, vals, 9,
                                                 diag_vals=diag,
                                                 dtype=jdtype)
    b = np.random.default_rng(2).normal(size=N)
    w = np.asarray(want.solve(jnp.asarray(b, dtype=jdtype)))
    g = got.solve(torch.as_tensor(b, dtype=dtype)).numpy()
    assert np.abs(g - w).max() <= rtol * np.abs(w).max()


def test_ilu_neumann_triangles_are_compressed_rows(factors16):
    op = make_multiphase_operator(16, eta_n=100.0, device="cpu")
    ilu = ILUPreconditioner.ilut(op.F.to_csr(drop_tol=1e-14), fill=400,
                                 tau=3e-5, apply="neumann", sweeps=4)
    ptr, _, _, _ = factors16["F U"]
    assert ilu.upper.strict.nnz == ptr[-1]
    assert ilu.upper.strict.rowptr.dtype == torch.int32
