"""The port's block-Jacobi ILU(0) (`mpbp_tpu_torch/parallel/block_ilu.py`)
against the JAX package's: the band blocks bit for bit, one band against
the full ILU(0), and on 4 gloo ranks (spawned from `torch_rank_fns` under
the MPBP_* launch contract) the apply against per-band factors and the
block-ILU LSC solve against JAX's count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_fns as rf
from mpbp_tpu.models import mms as jmms
from mpbp_tpu.models.multiphase import make_multiphase_operator as jax_op
from mpbp_tpu.parallel import sharding as jsh
from mpbp_tpu.parallel.block_ilu import local_block_csr as jax_block
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.ops.ilu import ILUPreconditioner
from mpbp_tpu_torch.parallel.block_ilu import local_block_csr
from mpbp_tpu_torch.solvers.preconditioners import ILUInner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def op16():
    return make_multiphase_operator(16, eta_n=100.0, device="cpu")


def _v16():
    return np.random.default_rng(1).normal(size=(4, 16, 16))


def _jax_solve(n):
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("x",))
    op = jax_op(n, c=1, d=-1, xi=1.0, eta_n=100.0, eta_s=1.0)
    _, b = jmms.fill_sol_and_rhs(op.grid, jmms.variable_thn_problem(
        1, -1, 1.0, 100.0, 1.0))
    M = jsh.make_sharded_lsc_pc_ilu(op, mesh, inner_tol=1e-4,
                                    inner_iters=40)
    return jsh.sharded_solve(op, b, mesh, tol=1e-6, maxiter=150, pc=M)


@pytest.mark.parametrize("s", range(4))
def test_local_block_csr_equals_jax(op16, s):
    """Band s of 4's diagonal block of F: the JAX package's CSR bit for
    bit."""
    jop = jax_op(16, c=1, d=-1, xi=1.0, eta_n=100.0, eta_s=1.0)
    want = jax_block(jop.F, s, 4)
    got = local_block_csr(op16.F, s, 4)
    np.testing.assert_array_equal(got.indptr, np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))


def test_single_band_equals_full_ilu0(op16):
    """One band is the whole operator: its ILU(0) apply is the full
    operator's (`ILUInner.ilu0_of`)."""
    one = ILUPreconditioner.ilu0(local_block_csr(op16.F, 0, 1))
    v = torch.as_tensor(np.random.default_rng(0).normal(size=4 * 16 * 16))
    np.testing.assert_allclose(one.solve(v).numpy(),
                               ILUInner.ilu0_of(op16.F)(v).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_local_block_pattern_shift_invariant(op16):
    """Every band's block has one sparsity pattern and its own values."""
    a, b = local_block_csr(op16.F, 0, 4), local_block_csr(op16.F, 2, 4)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices.numpy(), b.indices.numpy())
    assert not np.allclose(a.vals.numpy(), b.vals.numpy())


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return rf.run_ranks("block_ilu", 4, tmp_path_factory.mktemp("ilu"),
                        timeout=300, contract="mpbp", v16=_v16(), solve_n=8)


def test_block_apply_matches_per_band_factors(op16, four):
    """The 4-rank apply (no communication) equals each band's own ILU(0)
    solve, 1e-12."""
    v = _v16()
    got = four[0]["apply"]
    for s in range(4):
        fac = ILUPreconditioner.ilu0(local_block_csr(op16.F, s, 4))
        want = fac.solve(torch.as_tensor(
            v[:, 4 * s:4 * s + 4].reshape(-1))).numpy().reshape(4, 4, 16)
        np.testing.assert_allclose(got[:, 4 * s:4 * s + 4], want,
                                   rtol=1e-12, atol=1e-12)


def test_block_ilu_lsc_solve_matches_jax(four):
    """`make_sharded_lsc_pc_ilu` at n=8, eta_n=100, tol 1e-6 on 4 ranks:
    converged in JAX's count within 2 (the n=32 case is slow)."""
    got = four[0]["solve"]
    want = _jax_solve(8)
    assert got["converged"] and abs(got["iters"] - int(want.iters)) <= 2, (
        got["iters"], int(want.iters))


@pytest.mark.slow
def test_block_ilu_lsc_solve_at_n32(tmp_path):
    """The same at n=32, the JAX package's test size (JAX: 45; the port
    took 45 in ~40 s on 4 CPU ranks)."""
    got = rf.run_ranks("block_ilu", 4, tmp_path, timeout=600,
                       v16=_v16(), solve_n=32)[0]["solve"]
    want = _jax_solve(32)
    assert got["converged"] and abs(got["iters"] - int(want.iters)) <= 2
