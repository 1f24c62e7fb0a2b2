"""The port's banded SpGEMM (`ops/spgemm.py`) and the DIA-matrix LSC
preconditioner against the JAX package (CPU, f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu.ops import dia as jax_dia
from mpbp_tpu.ops import spgemm as jax_spgemm
from mpbp_tpu_torch.drivers import pack_fields
from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.ops import spgemm
from mpbp_tpu_torch.ops.dia import DIAMatrix
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers.preconditioners import make_lsc_pc_from_dia

torch.set_num_threads(1)


def _banded(m, n, offsets, rng):
    """(JAX, port) DIA pair with the given (col - row) offsets; entries
    outside [0, n) are zero."""
    data = np.zeros((len(offsets), m))
    i = np.arange(m)
    for k, o in enumerate(offsets):
        data[k] = rng.normal(size=m) * ((i + o >= 0) & (i + o < n))
    return (jax_dia.DIAMatrix((m, n), tuple(offsets), jnp.asarray(data)),
            DIAMatrix.from_numpy((m, n), offsets, data, device="cpu"))


def _same(got: DIAMatrix, want, rtol=1e-13):
    assert got.offsets == want.offsets and got.shape == want.shape
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=rtol, atol=rtol)


@pytest.mark.parametrize("periodic", [False, True])
def test_dia_spgemm_matches_jax(periodic):
    rng = np.random.default_rng(0)
    if periodic:
        N = 20
        ja, a = _banded(N, N, (0, 1, 5, N - 2), rng)
        jb, b = _banded(N, N, (0, 2, N - 1), rng)
        # periodic operands keep their wrapped entries
        a.data[:] = torch.as_tensor(rng.normal(size=(4, N)))
        ja = jax_dia.DIAMatrix(ja.shape, ja.offsets, jnp.asarray(a.data))
    else:
        ja, a = _banded(24, 32, (-3, 0, 2, 7), rng)
        jb, b = _banded(32, 16, (-16, -1, 0, 4), rng)
    got = spgemm.dia_spgemm(a, b, periodic=periodic)
    _same(got, jax_spgemm.dia_spgemm(ja, jb, periodic=periodic))
    np.testing.assert_allclose(got.to_dense(), a.to_dense() @ b.to_dense(),
                               rtol=1e-13, atol=1e-13)


def test_dia_add_and_prune_match_jax():
    rng = np.random.default_rng(2)
    ja, a = _banded(16, 16, (0, 1), rng)
    jb, b = _banded(16, 16, (0, 3), rng)
    _same(spgemm.dia_add(a, b, beta=-2.0),
          jax_spgemm.dia_add(ja, jb, beta=-2.0))
    pruned = spgemm.dia_prune(spgemm.dia_add(a, a, beta=-1.0))
    assert pruned.offsets == () and tuple(pruned.data.shape) == (0, 16)
    _same(spgemm.dia_prune(a), jax_spgemm.dia_prune(ja))


def _flat_dia_pair(stencil_op_jax):
    csr = stencil_op_jax.to_csr(drop_tol=0.0)
    jd = jax_dia.DIAMatrix.from_csr(csr, periodic=False)
    return jd, DIAMatrix.from_numpy(jd.shape, jd.offsets, np.asarray(jd.data),
                                    device="cpu")


def test_lsc_products_device_matches_jax():
    jop = jax_make_operator(8, eta_n=100.0)
    (jmd, md), (jf, f), (jg, g) = (_flat_dia_pair(b) for b in
                                   (jop.minus_D, jop.F, jop.G))
    got = spgemm.lsc_products_device(md, f, g)
    want = jax_spgemm.lsc_products_device(jmd, jf, jg)
    for gg, ww in zip(got, want):
        _same(gg, ww, rtol=1e-12)


def test_lsc_pc_from_dia_solves_at_n16():
    """Path (b) at n=16: DIA blocks, device SpGEMM products, inner Krylov on
    DIA matvecs, FGMRES on A.to_dia().matvec; converges within 40
    iterations as the JAX package's does (16 there), with the same L2."""
    from mpbp_tpu.drivers import pack_fields as jax_pack
    from mpbp_tpu.models import mms as jax_mms
    from mpbp_tpu.solvers import gmres as jax_krylov
    from mpbp_tpu.solvers.preconditioners import \
        make_lsc_pc_from_dia as jax_make_pc
    from mpbp_tpu.utils.norms import norms_report as jax_norms
    from mpbp_tpu_torch.utils.norms import norms_report

    n = 16
    top = make_multiphase_operator(n, eta_n=100.0, device="cpu")
    u, b = mms.fill_sol_and_rhs(top.grid, mms.variable_thn_problem(
        1.0, -1.0, 1.0, 100.0, 1.0))
    flat = [DIAMatrix.from_csr(blk.to_csr(drop_tol=0.0), periodic=False)
            for blk in (top.minus_D, top.F, top.G)]
    M = make_lsc_pc_from_dia(*flat, inner_tol=1e-5, inner_iters=80)
    res = krylov.fgmres(top.A.to_dia().matvec, pack_fields(top, b),
                        tol=1e-8, maxiter=80, M=M)
    assert res.converged and res.iters <= 40

    jop = jax_make_operator(n, eta_n=100.0)
    ju, jb = jax_mms.fill_sol_and_rhs(jop.grid, jax_mms.variable_thn_problem(
        1.0, -1.0, 1.0, 100.0, 1.0))
    jflat = [jax_dia.DIAMatrix.from_csr(blk.to_csr(drop_tol=0.0),
                                        periodic=False)
             for blk in (jop.minus_D, jop.F, jop.G)]
    jres = jax_krylov.fgmres(jop.A.to_dia().matvec, jax_pack(jop, jb),
                             tol=1e-8, maxiter=80,
                             M=jax_make_pc(*jflat, inner_tol=1e-5,
                                           inner_iters=80))
    assert abs(res.iters - int(jres.iters)) <= 1
    l2 = norms_report(res.x, pack_fields(top, u), top.grid.dx,
                      top.grid.dy)["l2"]
    jl2 = jax_norms(jres.x, jax_pack(jop, ju), jop.grid.dx,
                    jop.grid.dy)["l2"]
    assert l2 == pytest.approx(float(jl2), rel=1e-4)
