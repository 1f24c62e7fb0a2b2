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


def _aug_probe():
    """diag(1..12) with A[0,1] = 0.5: its Krylov space from b = 1..12 grows
    one column an iteration, and A r0 lies in the span of the first two."""
    A = np.diag(np.arange(1.0, 13.0))
    A[0, 1] = 0.5
    return A, np.arange(1.0, 13.0)


def test_augmentation_breakdown_is_not_convergence():
    """A 3-column cycle whose last column is the augmentation r0/||r0||,
    the first column's own direction: the column breaks down, H is singular
    and its rotated diagonal is rounding noise. The JAX package's cycle
    claims convergence with a relres estimate of 0; the port drops the
    column and reports the true relres of the two good columns, not
    converged."""
    A, b = _aug_probe()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    aug = (bt / torch.linalg.norm(bt))[None]
    got = krylov._cycle(lambda v: At @ v, bt, torch.zeros_like(bt), 1e-8, 3,
                        krylov._identity, True, aug=aug)
    true_rel = float(torch.linalg.norm(bt - At @ got.x) / np.linalg.norm(b))
    assert not got.converged and got.iters == 2
    assert got.relres == pytest.approx(true_rel, rel=1e-8)
    assert true_rel > 1e-2 and np.isfinite(got.x.numpy()).all()
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    want = jax_krylov._fgmres_cycle(lambda v: Aj @ v, bj, jnp.zeros_like(bj),
                                    1e-8, 3, lambda v: v, True,
                                    aug=jnp.asarray(aug.numpy()))
    assert bool(want.converged) and float(want.relres) == 0.0


def test_krylov_column_breakdown_with_singular_h_is_not_convergence():
    """No augmentation: a variable preconditioner whose second direction is
    a multiple of its first, so A z_1 lies in the span of v_0 and v_1, the
    column breaks down and H's rotated diagonal is rounding noise, not 0.
    The cycle ends at the one good column, its relres the true one; it
    neither claims convergence nor divides by the noise."""
    rng = np.random.default_rng(4)
    A = np.diag(np.arange(1.0, 13.0)) + rng.normal(size=(12, 12)) / 4
    At, bt = torch.as_tensor(A), torch.as_tensor(rng.normal(size=12))
    first = []

    def M(v):
        if not first:
            first.append(v.clone())
            return v
        return 3.0 * first[0]

    got = krylov._cycle(lambda v: At @ v, bt, torch.zeros_like(bt), 1e-8, 3,
                        M, True)
    true_rel = float(torch.linalg.norm(bt - At @ got.x)
                     / torch.linalg.norm(bt))
    assert not got.converged and got.iters == 1
    assert got.relres == pytest.approx(true_rel, rel=1e-8)
    assert true_rel > 1e-2


def test_augmented_restart_converges_on_the_probe():
    """fgmres(restart=4, aug_k=2) on the probe's matrix converges to a true
    relres below tol, in the JAX package's count (no column is lost)."""
    A, b = _aug_probe()
    got, want = solve_both(
        A, b,
        lambda mv, b: krylov.fgmres(mv, b, tol=1e-8, maxiter=40, restart=4,
                                    aug_k=2),
        lambda mv, b: jax_krylov.fgmres(mv, b, tol=1e-8, maxiter=40,
                                        restart=4, aug_k=2))
    true_rel = np.linalg.norm(b - A @ got.x.numpy()) / np.linalg.norm(b)
    assert got.converged and true_rel < 1e-8
    assert_same_solve(got, want)


def test_lost_column_restarts_plain(monkeypatch):
    """After a cycle that dropped a column (not converged, fewer iterations
    than the cycle), the restarted solve drops its augmentations: the next
    cycle runs plain."""
    A, b = _aug_probe()
    At = torch.as_tensor(A)
    seen, cycle = [], krylov._cycle

    def spy(matvec, b, x0, tol, m, M, use_z, orthog="cgs2", aug=None,
            group=None):
        res = cycle(matvec, b, x0, tol, m, M, use_z, orthog, aug, group)
        seen.append((0 if aug is None else aug.shape[0], res.iters))
        if len(seen) == 2:      # as if the second cycle lost its column
            res = res._replace(iters=res.iters - 1, converged=False)
        return res

    monkeypatch.setattr(krylov, "_cycle", spy)
    got = krylov.fgmres(lambda v: At @ v, torch.as_tensor(b), tol=1e-8,
                        maxiter=40, restart=4, aug_k=2)
    assert [k for k, _ in seen[:4]] == [0, 1, 0, 1]
    assert got.converged


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


@pytest.mark.parametrize("orthog", ["cgs2", "cgs1"])
def test_fgmres_resumable_stepped_equals_uninterrupted(orthog):
    """Stepping fgmres_resumable one iteration at a time walks the same
    recurrence as one uninterrupted fgmres: iterates, counts and history
    to 1e-12."""
    A, b = nonsymmetric(5)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Mt = torch.as_tensor(1.0 / np.diag(A))
    kw = dict(tol=1e-10, maxiter=N, M=lambda v: Mt * v, orthog=orthog)
    full = krylov.fgmres(lambda v: At @ v, bt, **kw)
    state, steps = None, 0
    while True:
        part, state = krylov.fgmres_resumable(lambda v: At @ v, bt,
                                              state=state, max_steps=1, **kw)
        steps += 1
        assert part.iters == state.j == min(steps, full.iters)
        if part.converged or part.iters >= N:
            break
    assert part.converged and part.iters == full.iters > 5
    np.testing.assert_allclose(part.x.numpy(), full.x.numpy(), rtol=1e-12,
                               atol=1e-12 * float(full.x.abs().max()))
    ok = ~np.isnan(full.res_history)
    np.testing.assert_array_equal(np.isnan(part.res_history), ~ok)
    np.testing.assert_allclose(part.res_history[ok], full.res_history[ok],
                               rtol=1e-12)
    assert part.relres == pytest.approx(full.relres, rel=1e-12)


def test_fgmres_resumable_matches_jax_and_its_partial_iterate_is_valid():
    """A 7-step partial solve equals the JAX package's, its iterate's true
    residual matches the recurrence estimate, and resuming finishes the
    solve as the JAX package's resume does."""
    A, b = nonsymmetric(6)
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    part, state = krylov.fgmres_resumable(lambda v: At @ v,
                                          torch.as_tensor(b), tol=1e-10,
                                          maxiter=N, max_steps=7)
    jpart, jstate = jax_krylov.fgmres_resumable(lambda v: Aj @ v,
                                                jnp.asarray(b), tol=1e-10,
                                                maxiter=N, max_steps=7)
    assert part.iters == int(jpart.iters) == 7 and not part.converged
    np.testing.assert_allclose(part.x.numpy(), np.asarray(jpart.x),
                               rtol=RTOL, atol=RTOL)
    true_rel = float(torch.linalg.norm(torch.as_tensor(b) - At @ part.x)
                     / np.linalg.norm(b))
    assert abs(true_rel - part.relres) < 1e-8 * (1 + true_rel)
    res, _ = krylov.fgmres_resumable(lambda v: At @ v, torch.as_tensor(b),
                                     tol=1e-10, maxiter=N, state=state)
    jres, _ = jax_krylov.fgmres_resumable(lambda v: Aj @ v, jnp.asarray(b),
                                          tol=1e-10, maxiter=N, state=jstate)
    assert_same_solve(res, jres)
    with pytest.raises(ValueError):              # a state of another cycle
        krylov.fgmres_resumable(lambda v: At @ v, torch.as_tensor(b),
                                maxiter=N - 1, state=state)


# (pc, extra settings, iterations over which the two packages' recurrence
# histories agree): lsc_ilut's exact level solves keep them together to the
# end; lsc_mg_full's inner GMRES stops at its own tolerance, so the plain
# (unmonitored) histories of the two packages already part after 8
# iterations (1.8e-6 at the 9th, 8e-2 at the 12th; ROADMAP.md queue 3)
MONITORED = [("lsc_ilut", {}, None),
             ("lsc_mg_full", dict(inner_tol=1e-4, inner_iters=40), 8)]


@pytest.mark.parametrize("pc,extra,agree", MONITORED)
def test_true_res_monitor_matches_jax(pc, extra, agree):
    """The per-iteration true-residual monitor at n=16, full precision:
    one entry per iteration, as many as the JAX package's, equal to its
    values to 1e-6 relative where the two recurrences agree, and tracking
    the port's own recurrence history."""
    kw = dict(n=16, eta_n=100.0, pc=pc, tol=1e-8, maxiter=100,
              true_res_monitor=True, **extra)
    got = solve_multiphase(**kw, device="cpu")
    want = jax_solve(**kw)
    hist = np.asarray(got.params["true_res_history"])
    jhist = np.asarray(want.params["true_res_history"])
    assert got.converged and got.iters == want.iters == len(hist)
    assert len(hist) == len(jhist)
    np.testing.assert_allclose(hist[:agree], jhist[:agree], rtol=1e-6)
    rec = got.res_history[1:len(hist) + 1] / got.res_history[0]
    np.testing.assert_allclose(hist, rec, rtol=1e-6, atol=1e-10)
    assert hist[-1] < kw["tol"]
    with pytest.raises(ValueError, match="restart"):
        solve_multiphase(**kw, restart=10, device="cpu")
