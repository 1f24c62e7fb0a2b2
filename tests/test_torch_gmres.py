"""The port's Krylov solvers against the JAX package on seeded dense systems
(same iteration counts, residual histories to 1e-10) and on the
unpreconditioned multiphase system."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.drivers import solve_multiphase as jax_solve
from mpbp_tpu.solvers import gmres as jax_krylov
from mpbp_tpu_torch.drivers import solve_multiphase
from mpbp_tpu_torch.solvers import gmres as krylov

torch.set_num_threads(1)

N = 64
RTOL = 1e-10


def nonsymmetric(seed=0):
    rng = np.random.default_rng(seed)
    A = np.diag(np.linspace(1.0, 20.0, N)) + rng.normal(size=(N, N)) / 2
    return A, rng.normal(size=N)


def spd(seed=1):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(N, N))
    return B @ B.T / N + np.diag(np.linspace(0.1, 5.0, N)), rng.normal(size=N)


def solve_both(A, b, run_port, run_jax):
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    got = run_port(lambda v: At @ v, torch.as_tensor(b))
    want = run_jax(lambda v: Aj @ v, jnp.asarray(b))
    return got, want


def assert_same_solve(got, want):
    assert got.iters == int(want.iters)
    assert got.converged == bool(want.converged)
    h_want = np.asarray(want.res_history)
    np.testing.assert_array_equal(np.isnan(got.res_history),
                                  np.isnan(h_want))
    ok = ~np.isnan(h_want)
    np.testing.assert_allclose(got.res_history[ok], h_want[ok], rtol=RTOL,
                               atol=RTOL * h_want[0])
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(want.x)).max())
    assert got.relres == pytest.approx(float(want.relres), rel=1e-8)


@pytest.mark.parametrize("orthog", ["cgs2", "cgs1"])
def test_fgmres_matches_jax(orthog):
    A, b = nonsymmetric()
    Mt = torch.as_tensor(1.0 / np.diag(A))
    Mj = jnp.asarray(1.0 / np.diag(A))
    got, want = solve_both(
        A, b,
        lambda mv, b: krylov.fgmres(mv, b, tol=1e-10, maxiter=N,
                                    M=lambda v: Mt * v, orthog=orthog),
        lambda mv, b: jax_krylov.fgmres(mv, b, tol=1e-10, maxiter=N,
                                        M=lambda v: Mj * v, orthog=orthog))
    assert got.converged and 5 < got.iters < N
    assert_same_solve(got, want)


def test_gmres_fixed_preconditioner_matches_jax():
    A, b = nonsymmetric(2)
    Mt = torch.as_tensor(1.0 / np.diag(A))
    Mj = jnp.asarray(1.0 / np.diag(A))
    got, want = solve_both(
        A, b,
        lambda mv, b: krylov.gmres(mv, b, tol=1e-9, maxiter=N,
                                   M=lambda v: Mt * v),
        lambda mv, b: jax_krylov.gmres(mv, b, tol=1e-9, maxiter=N,
                                       M=lambda v: Mj * v))
    assert got.converged
    assert_same_solve(got, want)


@pytest.mark.parametrize("restart,aug_k", [(8, 0), (8, 2)])
def test_restarted_fgmres_matches_jax(restart, aug_k):
    A, b = nonsymmetric(3)
    got, want = solve_both(
        A, b,
        lambda mv, b: krylov.fgmres(mv, b, tol=1e-8, maxiter=200,
                                    restart=restart, aug_k=aug_k),
        lambda mv, b: jax_krylov.fgmres(mv, b, tol=1e-8, maxiter=200,
                                        restart=restart, aug_k=aug_k))
    assert got.iters > restart
    assert_same_solve(got, want)


def test_cg_matches_jax():
    A, b = spd()
    got, want = solve_both(
        A, b,
        lambda mv, b: krylov.cg(mv, b, tol=1e-10, maxiter=200),
        lambda mv, b: jax_krylov.cg(mv, b, x0=jnp.zeros_like(b), tol=1e-10,
                                    maxiter=200))
    assert got.converged
    assert_same_solve(got, want)


def test_jacobi_and_residual_norm_match_jax():
    A, b = spd(4)
    A = A + np.diag(np.full(N, 2.0 * np.abs(A).sum(axis=1).max()))
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    d = np.diag(A)
    got = krylov.jacobi(lambda v: At @ v, torch.as_tensor(d),
                        torch.as_tensor(b), iters=30)
    want = jax_krylov.jacobi(lambda v: Aj @ v, jnp.asarray(d),
                             jnp.asarray(b), iters=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    r, rn = krylov.residual_norm(lambda v: At @ v, torch.as_tensor(b), got)
    _, rn_j = jax_krylov.residual_norm(lambda v: Aj @ v, jnp.asarray(b),
                                       want)
    assert float(rn) == pytest.approx(float(rn_j), rel=1e-9)


def test_unpreconditioned_multiphase_stagnates_like_jax():
    kw = dict(n=16, eta_n=100.0, pc="none", tol=1e-8, maxiter=100)
    got = solve_multiphase(**kw, device="cpu")
    want = jax_solve(**kw)
    assert not got.converged and got.status == want.status == "stagnated"
    assert got.iters == want.iters == 100
    assert got.relres == pytest.approx(want.relres, rel=1e-3)
    assert round(got.relres, 7) == 1.57e-5
