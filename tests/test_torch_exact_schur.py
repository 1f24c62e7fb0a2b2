"""The port's exact-Schur preconditioner and its Jacobi and dense inners
(`mpbp_tpu_torch.solvers.preconditioners`) against the JAX package's on
the same vectors at n=8, the `exact_schur` and unpreconditioned solves
against the JAX package's, and `a_matvec(fused=False)`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.drivers import a_matvec as jax_a_matvec
from mpbp_tpu.drivers import solve_multiphase as jax_solve
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_operator
from mpbp_tpu.solvers import gmres as jax_krylov
from mpbp_tpu.solvers import preconditioners as jax_pcs
from mpbp_tpu_torch.drivers import (a_matvec, make_preconditioner,
                                    make_preconditioner_mixed,
                                    solve_multiphase)
from mpbp_tpu_torch.models.multiphase import (VEL_FIELDS,
                                              make_multiphase_operator)
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers import preconditioners as pcs

torch.set_num_threads(1)

KW = dict(c=1.0, d=-1.0, xi=1.0, eta_n=1.0, eta_s=1.0)


def _ops(n=8, **kw):
    p = dict(KW, **kw)
    return make_multiphase_operator(n, **p, device="cpu"), jax_operator(n, **p)


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)))


def test_jacobi_inner_matches_jax():
    """50 Jacobi sweeps on F, to 1e-12 relative of max|JAX|."""
    top, jop = _ops()
    n = 8
    fdiag = torch.cat([top.F.terms[(f, f)][(0, 0)].reshape(-1)
                       for f in VEL_FIELDS])
    tmpl = {f: torch.zeros(n, n, dtype=torch.float64) for f in VEL_FIELDS}
    mv = krylov.flatten_op(top.F.apply, tmpl, VEL_FIELDS)
    jdiag = jnp.concatenate([jop.F.terms[(f, f)][(0, 0)].ravel()
                             for f in jop.F.out_fields])
    jmv = jax_krylov.flatten_op(jop.F.apply, {f: jnp.zeros((n, n))
                                              for f in jop.F.in_fields},
                                jop.F.in_fields)
    v = np.random.default_rng(0).normal(size=4 * n * n)
    got = pcs.JacobiInner(mv, fdiag, iters=50)(torch.as_tensor(v))
    want = jax_pcs.JacobiInner(jmv, jdiag, iters=50)(jnp.asarray(v))
    assert _rel_err(got, want) <= 1e-12


@pytest.mark.parametrize("block,pseudo", [("F", False), ("GtG", True)])
def test_dense_inner_matches_jax(block, pseudo):
    """inv of F and pinv of the singular GtG, each to 1e-10 relative."""
    top, jop = _ops()
    blk = {"F": lambda o, p: o.F, "GtG": lambda o, p: p.lsc_products(o)[0]}
    got_inner = pcs.DenseInner.of(blk[block](top, pcs), pseudo=pseudo)
    want_inner = jax_pcs.DenseInner.of(blk[block](jop, jax_pcs),
                                       pseudo=pseudo)
    v = np.random.default_rng(1).normal(size=got_inner.inv.shape[1])
    got = got_inner(torch.as_tensor(v))
    assert got.device == torch.device("cpu") and got.dtype == torch.float64
    assert _rel_err(got, want_inner(jnp.asarray(v))) <= 1e-10


@pytest.mark.parametrize("eta_n", [1.0, 100.0])
def test_exact_schur_apply_matches_jax(eta_n):
    """The exact-Schur apply on one random vector, to 1e-8 relative: the
    inner GMRES on S stops at 1e-5 in both packages."""
    top, jop = _ops(eta_n=eta_n)
    v = np.random.default_rng(2).normal(size=5 * 64)
    got = pcs.make_exact_schur_pc(top)(torch.as_tensor(v))
    want = jax_pcs.make_exact_schur_pc(jop)(jnp.asarray(v))
    assert _rel_err(got, want) <= 1e-8


def test_exact_schur_solve_matches_jax():
    """n=8, eta 1: converged in at most 2 iterations, JAX's count, the
    error norms of JAX's solve to 1e-6 relative."""
    got = solve_multiphase(n=8, eta_n=1.0, eta_s=1.0, pc="exact_schur",
                           tol=1e-8, maxiter=40, device="cpu")
    want = jax_solve(n=8, eta_n=1.0, eta_s=1.0, pc="exact_schur", tol=1e-8,
                     maxiter=40)
    assert got.converged and got.iters <= 2 and got.iters == want.iters
    assert got.params["true_relres"] <= 1e-7
    assert got.error_norms["l2"] == pytest.approx(want.error_norms["l2"],
                                                  rel=1e-6)


def test_unpreconditioned_solve_stagnates_as_jax():
    """pc='none', n=16 stiff: stagnated with 1e-6 < relres < 1e-4 (the
    reference's 1.6e-5), JAX's relres to 1e-3 relative."""
    got = solve_multiphase(n=16, eta_n=100.0, eta_s=1.0, pc="none",
                           tol=1e-8, maxiter=100, device="cpu")
    want = jax_solve(n=16, eta_n=100.0, eta_s=1.0, pc="none", tol=1e-8,
                     maxiter=100)
    assert not got.converged and got.status == "stagnated"
    assert 1e-6 < got.relres < 1e-4
    assert got.relres == pytest.approx(want.relres, rel=1e-3)


def test_exact_schur_has_no_mixed_precision_assembly():
    top, _ = _ops()
    with pytest.raises(ValueError, match="not an lsc_"):
        make_preconditioner_mixed(top, top, "exact_schur")
    assert make_preconditioner(top, "none") is None


def test_unfused_a_matvec_matches_fused_and_jax():
    """a_matvec(fused=False), the plain StencilOperator.apply, equals the
    K2 path to 1e-12 and the JAX package's unfused matvec to 1e-12
    relative of max|JAX| at n=16, eta_n 100."""
    top, jop = _ops(n=16, eta_n=100.0)
    v = np.random.default_rng(3).normal(size=5 * 256)
    plain = a_matvec(top, fused=False)(torch.as_tensor(v))
    fused = a_matvec(top)(torch.as_tensor(v))
    want = np.asarray(jax_a_matvec(jop, fused=False)(jnp.asarray(v)))
    assert _rel_err(plain, fused.numpy()) <= 1e-12
    assert _rel_err(plain, want) <= 1e-12
