"""The port's matrix-free eigensolver (`mpbp_tpu_torch.solvers.eigen`) and
`drivers.spectrum_report` against the JAX package's on the same inputs.
The two packages draw their Arnoldi start vectors from different random
streams, so Ritz values are compared by membership in the dense spectrum,
never position by position."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.drivers import spectrum_report as jax_spectrum_report
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_operator
from mpbp_tpu.solvers import eigen as jax_eigen
from mpbp_tpu_torch.drivers import (a_matvec, make_preconditioner,
                                    spectrum_report)
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.solvers import eigen

torch.set_num_threads(1)


def _in_spectrum(got, ref, rel):
    """Every value of `got` lies within rel * max(|value|, 1) of `ref`."""
    for ev in got:
        assert np.min(np.abs(ref - ev)) < rel * max(abs(ev), 1.0), ev


def test_eigs_diagonal_matches_jax():
    d = np.arange(1.0, 51.0)
    dt = torch.as_tensor(d)
    got = eigen.eigs(lambda v: dt * v, torch.ones(50, dtype=torch.float64),
                     k=5, tol=1e-8)
    want = jax_eigen.eigs(lambda v: jnp.asarray(d) * v, jnp.ones(50), k=5,
                          tol=1e-8)
    assert got.n_converged >= 5 and want.n_converged >= 5
    # both the top five of diag(1..50), to 1e-6 relative
    for res in (got, want):
        np.testing.assert_allclose(np.sort(np.real(res.eigenvalues[:5])),
                                   [46, 47, 48, 49, 50], rtol=1e-6)


def test_eigs_nonsymmetric_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(40, 40))
    At = torch.as_tensor(A)
    got = eigen.eigs(lambda v: At @ v, torch.ones(40, dtype=torch.float64),
                     k=4, ncv=25, tol=1e-8, maxiter=100)
    want = jax_eigen.eigs(lambda v: jnp.asarray(A) @ v, jnp.ones(40), k=4,
                          ncv=25, tol=1e-8, maxiter=100)
    ref = np.linalg.eigvals(A)
    ref = ref[np.argsort(-np.abs(ref))][:4]
    # magnitudes to 1e-4 relative (conjugate pairs order either way)
    for res in (got, want):
        np.testing.assert_allclose(np.sort(np.abs(res.eigenvalues[:4])),
                                   np.sort(np.abs(ref)), rtol=1e-4)


def test_eigs_explicit_restart_fallback(monkeypatch):
    """With no Schur routine the explicit restart still converges to the
    dominant eigenvalues (1e-3 relative), keeping both parts of complex
    Ritz pairs; the JAX package's fallback on the same matrix too."""
    monkeypatch.setattr(eigen, "_sorted_real_schur", lambda *a: None)
    monkeypatch.setattr(jax_eigen, "_sorted_real_schur", lambda *a: None)
    rng = np.random.default_rng(3)
    A = rng.normal(size=(60, 60))
    At = torch.as_tensor(A)
    ref = np.linalg.eigvals(A)
    got = eigen.eigs(lambda v: At @ v, torch.ones(60, dtype=torch.float64),
                     k=2, ncv=12, tol=1e-6, maxiter=300)
    want = jax_eigen.eigs(lambda v: jnp.asarray(A) @ v, jnp.ones(60), k=2,
                          ncv=12, tol=1e-6, maxiter=300)
    for res in (got, want):
        assert res.n_converged >= 1
        for ev in res.eigenvalues[: res.n_converged]:
            assert np.min(np.abs(ref - ev)) < 1e-3 * abs(ev), ev


def test_multiphase_A_ritz_values_are_jax_eigenvalues():
    """n=8, eta 1: every converged Ritz value of the port's K2 matvec lies
    within 1e-3 max(|lambda|, 1) of an eigenvalue of the JAX package's
    dense A, and the dominant |lambda| agrees to 1e-3."""
    op = make_multiphase_operator(8, eta_n=1.0, eta_s=1.0, device="cpu")
    res = eigen.eigs(a_matvec(op), torch.ones(5 * 64, dtype=torch.float64),
                     k=6, ncv=40, tol=1e-6, maxiter=60)
    ref = np.linalg.eigvals(np.asarray(
        jax_operator(8, eta_n=1.0, eta_s=1.0).A.to_dense()))
    assert res.n_converged >= 1
    _in_spectrum(res.eigenvalues[: res.n_converged], ref, 1e-3)
    top = np.max(np.abs(ref))
    assert abs(np.max(np.abs(res.eigenvalues)) - top) < 1e-3 * top


def test_exact_eigenvalues_match_jax():
    """The dense spectrum of A at n=8 (eta_n 100) equals the JAX package's
    to 1e-10 relative, as sets; the Arnoldi top magnitude agrees to 1e-5."""
    op = make_multiphase_operator(8, eta_n=100.0, device="cpu")
    got = eigen.exact_eigenvalues(op.A)
    want = jax_eigen.exact_eigenvalues(jax_operator(8, eta_n=100.0).A)
    assert got.shape == want.shape == (320,)
    scale = np.max(np.abs(want))
    for a, b in ((got, want), (want, got)):
        assert max(np.min(np.abs(b - ev)) for ev in a) <= 1e-10 * scale
    res = eigen.eigs(a_matvec(op), torch.zeros(320, dtype=torch.float64),
                     k=4, tol=1e-6, maxiter=60)
    assert res.n_converged >= 2
    np.testing.assert_allclose(np.max(np.abs(res.eigenvalues)), scale,
                               rtol=1e-5)


def test_eigs_maxiter_zero_returns_empty():
    d = torch.arange(1.0, 9.0, dtype=torch.float64)
    res = eigen.eigs(lambda v: d * v, torch.ones(8, dtype=torch.float64),
                     k=3, maxiter=0)
    want = jax_eigen.eigs(lambda v: v, jnp.ones(8), k=3, maxiter=0)
    assert res.n_converged == want.n_converged == 0
    assert res.iterations == want.iterations == 0
    assert res.eigenvalues.shape == want.eigenvalues.shape == (0,)
    assert res.clustering() == float("inf")


def _dense_preconditioned_spectrum(op, pc):
    """Spectrum of A*M^-1 from its dense columns (n=8: 320 dofs)."""
    mv = a_matvec(op)
    eye = torch.eye(5 * op.grid.n ** 2, dtype=torch.float64)
    cols = torch.stack([mv(pc(e)) for e in eye], dim=1)
    return np.linalg.eigvals(cols.numpy())


def test_exact_schur_clusters_spectrum_at_one():
    """With the exact Schur PC all but the constant-pressure direction of
    A*M^-1 sit within 0.05 of 1 (n=8, eta 1), and the Arnoldi top
    magnitude of A*M^-1 agrees with the dense one to 5%."""
    op = make_multiphase_operator(8, eta_n=1.0, eta_s=1.0, device="cpu")
    pc = make_preconditioner(op, "exact_schur")
    ev = _dense_preconditioned_spectrum(op, pc)
    assert np.mean(np.abs(ev - 1.0) < 0.05) >= 319 / 320
    res = eigen.preconditioned_spectrum(
        a_matvec(op), pc, torch.ones(320, dtype=torch.float64), k=3, ncv=30,
        tol=1e-3, maxiter=60)
    top = np.max(np.abs(ev))
    assert abs(np.max(np.abs(res.eigenvalues)) - top) < 0.05 * top


def test_lsc_ilut_clusters_spectrum():
    """LSC/ILUT: more than 75% of spec(A*M^-1) within 0.5 of 1 at n=8,
    while raw A spreads past 100."""
    op = make_multiphase_operator(8, eta_n=1.0, eta_s=1.0, device="cpu")
    ev = _dense_preconditioned_spectrum(op, make_preconditioner(op,
                                                                "lsc_ilut"))
    assert np.max(np.abs(eigen.exact_eigenvalues(op.A))) > 100
    assert np.mean(np.abs(ev - 1.0) < 0.5) > 0.75


def test_dense_spectrum_report():
    """spectrum_report(n=6, exact_schur, dense): JSON-serializable, one
    nullspace eigenvalue, radius < 1e-3, raw A's radius > 10; the same
    A spectrum and radii as the JAX package's report (1e-6 relative)."""
    rep = spectrum_report(n=6, eta_n=1.0, eta_s=1.0, pcs=("exact_schur",),
                          exact=True, device="cpu")
    json.dumps(rep)
    assert rep["method"] == "dense"
    assert len(rep["A"]["eigenvalues_re"]) == 5 * 36
    es = rep["preconditioned"]["exact_schur"]
    assert es["n_nullspace"] == 1
    assert es["clustering_radius_1"] < 1e-3
    assert rep["A"]["clustering_radius_1"] > 10.0
    want = jax_spectrum_report(n=6, eta_n=1.0, eta_s=1.0,
                               pcs=("exact_schur",), exact=True)
    assert rep["A"]["clustering_radius_1"] == pytest.approx(
        want["A"]["clustering_radius_1"], rel=1e-6)
    assert es["frac_within_0p1_of_1"] == \
        want["preconditioned"]["exact_schur"]["frac_within_0p1_of_1"]


def test_arnoldi_spectrum_report_matches_jax():
    """spectrum_report(n=16, eta_n=100, lsc_mg_full, Arnoldi): the
    clustering radius (the outlier envelope, ~90.1) within 1% of the JAX
    package's."""
    rep = spectrum_report(n=16, eta_n=100.0, pcs=("lsc_mg_full",),
                          exact=False, device="cpu")
    want = jax_spectrum_report(n=16, eta_n=100.0, pcs=("lsc_mg_full",),
                               exact=False)
    got = rep["preconditioned"]["lsc_mg_full"]
    ref = want["preconditioned"]["lsc_mg_full"]
    assert rep["method"] == "arnoldi" and got["n_converged"] >= 1
    assert got["clustering_radius_1"] == pytest.approx(
        ref["clustering_radius_1"], rel=1e-2)
    assert got["n_nullspace"] == ref["n_nullspace"]
