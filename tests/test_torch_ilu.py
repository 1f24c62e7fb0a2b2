"""The port's ILU preconditioners and triangular solves against the JAX
package (CPU, f64): equal factor arrays from the shared native library on
bit-identical CSR, level and Neumann applies, and the refined inner."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu import native
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu.ops.ilu import ILUPreconditioner as JaxILU
from mpbp_tpu.solvers import preconditioners as jax_pcs
from mpbp_tpu_torch.ops import stencil
from mpbp_tpu_torch.ops.ilu import ILUPreconditioner
from mpbp_tpu_torch.ops.sparse import CSRMatrix
from mpbp_tpu_torch.solvers import preconditioners as pcs

torch.set_num_threads(1)


def port_stencil(jop):
    terms = {k: {o: torch.tensor(np.asarray(c)) for o, c in om.items()}
             for k, om in jop.terms.items()}
    return stencil.StencilOperator(jop.out_fields, jop.in_fields, terms,
                                   jop.shape_grid)


@pytest.fixture(scope="module")
def blocks():
    """(name -> (JAX stencil, port stencil on the same planes)) at n=8,
    eta_n=100."""
    jop = jax_make_operator(8, eta_n=100.0)
    gtg, _ = jax_pcs.lsc_products(jop)
    return {"F": (jop.F, port_stencil(jop.F)), "GtG": (gtg, port_stencil(gtg))}


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kind", ["ilut", "ilu0"])
@pytest.mark.parametrize("block", ["F", "GtG"])
def test_factor_arrays_equal_jax(blocks, kind, block):
    jst, tst = blocks[block]
    jcsr, tcsr = jst.to_csr(drop_tol=1e-14), tst.to_csr(drop_tol=1e-14)
    for g, w in zip(tcsr.host_arrays(), jcsr.host_arrays()):
        np.testing.assert_array_equal(g, w)
    fac = getattr(native, kind)
    args = dict(fill=100, tau=1e-3) if kind == "ilut" else {}
    for g, w in zip(fac(*tcsr.host_arrays(), **args),
                    fac(*jcsr.host_arrays(), **args)):
        for ga, wa in zip(g, w):
            np.testing.assert_array_equal(ga, wa)


@pytest.mark.parametrize("apply", ["level", "neumann"])
@pytest.mark.parametrize("block", ["F", "GtG"])
def test_ilut_solve_matches_jax(blocks, apply, block):
    jst, tst = blocks[block]
    want = JaxILU.ilut(jst.to_csr(drop_tol=1e-14), fill=100, tau=1e-3,
                       apply=apply, sweeps=10)
    got = ILUPreconditioner.ilut(tst.to_csr(drop_tol=1e-14), fill=100,
                                 tau=1e-3, apply=apply, sweeps=10)
    if apply == "level":
        assert got.lower.n_levels == int(want.lower.n_levels)
        assert got.upper.n_levels == int(want.upper.n_levels)
    b = np.random.default_rng(0).normal(size=got.lower.n)
    assert _rel(got.solve(torch.as_tensor(b)),
                want.solve(jnp.asarray(b))) <= 1e-12


def test_ilu0_level_solve_matches_jax(blocks):
    jst, tst = blocks["F"]
    want = JaxILU.ilu0(jst.to_csr(drop_tol=1e-14))
    got = ILUPreconditioner.ilu0(tst.to_csr(drop_tol=1e-14))
    b = np.random.default_rng(1).normal(size=got.lower.n)
    assert _rel(got(torch.as_tensor(b)), want(jnp.asarray(b))) <= 1e-12


def test_neumann_apply_equals_level_apply_with_enough_sweeps(blocks):
    """NeumannTriSolve is exact once sweeps >= n_levels."""
    _, tst = blocks["GtG"]
    csr = tst.to_csr(drop_tol=1e-14)
    level = ILUPreconditioner.ilut(csr, fill=100, tau=1e-3)
    lv = max(level.lower.n_levels, level.upper.n_levels)
    neu = ILUPreconditioner.ilut(csr, fill=100, tau=1e-3, apply="neumann",
                                 sweeps=lv)
    b = torch.as_tensor(np.random.default_rng(2).normal(size=csr.shape[0]))
    torch.testing.assert_close(neu.solve(b), level.solve(b), rtol=1e-9,
                               atol=1e-9)


def test_level_solve_is_exact_triangular_solve(blocks):
    """L U x = b holds for the level apply's output, against the host's
    sequential solves of the same factors."""
    _, tst = blocks["F"]
    csr = tst.to_csr(drop_tol=1e-14)
    (Lp, Li, Lv), (Up, Ui, Uv) = native.ilut(*csr.host_arrays(), fill=100,
                                             tau=1e-3)
    b = np.random.default_rng(3).normal(size=csr.shape[0])
    want = native.upper_solve_host(
        Up, Ui, Uv, native.lower_solve_unit_host(Lp, Li, Lv, b))
    got = ILUPreconditioner.ilut(csr, fill=100, tau=1e-3).solve(
        torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("apply", ["level", "neumann"])
def test_ilu_inner_with_refinement_matches_jax(blocks, apply):
    jst, tst = blocks["F"]
    want = jax_pcs.ILUInner.ilut_of(jst, fill=20, tau=1e-3, refine=1,
                                    apply=apply, sweeps=8)
    got = pcs.ILUInner.ilut_of(tst, fill=20, tau=1e-3, refine=1,
                               apply=apply, sweeps=8)
    assert got.refine == 1 and got.matvec is not None
    b = np.random.default_rng(4).normal(size=got.ilu.lower.n)
    assert _rel(got(torch.as_tensor(b)), want(jnp.asarray(b))) <= 1e-12
    if apply == "level":
        # refinement improves on the bare (exact-solve) factor apply
        tb = torch.as_tensor(b)
        r_bare = torch.linalg.norm(tb - got.matvec(got.ilu(tb)))
        r_ref = torch.linalg.norm(tb - got.matvec(got(tb)))
        assert r_ref < r_bare


def test_ilu_in_f32_and_on_the_csr_device():
    n = 64
    rng = np.random.default_rng(5)
    dense = np.diag(4.0 + rng.random(n)) + np.diag(-rng.random(n - 1), -1) \
        + np.diag(-rng.random(n - 1), 1)
    r, c = np.nonzero(dense)
    csr = CSRMatrix.from_coo(n, n, r, c, dense[r, c], device="cpu")
    for apply in ("level", "neumann"):
        ilu = ILUPreconditioner.ilut(csr, fill=5, tau=0.0,
                                     dtype=torch.float32, apply=apply,
                                     sweeps=n)
        b = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
        x = ilu(b)
        assert x.dtype == torch.float32
        np.testing.assert_allclose(dense @ x.numpy().astype(np.float64),
                                   b.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="apply"):
        ILUPreconditioner.ilut(csr, apply="wavefront")
