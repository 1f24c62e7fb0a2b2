"""Matrix-free eigenvalue analysis (port of `mpbp_tpu/solvers/eigen.py`).

The eigensolver needs only the matvec the Krylov driver uses, so it never
forms a matrix: the spectra of A and of the preconditioned A*M^-1 at grids
no dense eigensolver reaches. A good Schur preconditioner clusters the
spectrum of A*M^-1 near 1.

Algorithm: thick-restart Arnoldi (Krylov-Schur style). The basis lives on
the vector's device, where the matvec and the CGS2 projections run; the
small (ncv x ncv) Hessenberg eigenproblem is solved on the host with numpy
and scipy, with one host fetch per extension.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class EigResult:
    """Converged Ritz values and diagnostics."""

    eigenvalues: np.ndarray      # (k,) complex, sorted by |.| descending
    residuals: np.ndarray        # (k,) Ritz residual estimates
    n_converged: int
    iterations: int

    def clustering(self, center: complex = 1.0) -> float:
        """Max distance of the converged spectrum from `center`."""
        if self.n_converged == 0:
            return float("inf")
        ev = self.eigenvalues[: self.n_converged]
        return float(np.max(np.abs(ev - center)))


def _arnoldi_extend(matvec: Callable, V: torch.Tensor, H: np.ndarray,
                    start: int, m: int, shape) -> tuple:
    """Extend an Arnoldi factorization from `start` to `m` vectors.
    V: (m+1, N) on the device with rows [0, start] filled; H: (m+1, m) on
    the host; `shape` is the matvec's vector shape.

    The device work (matvec, CGS2 projections, normalization) is queued
    without host syncs; the Hessenberg columns come to the host in one
    transfer at the end of the extension. An exact breakdown (beta == 0)
    leaves the next basis vector zero, and every later column is then zero
    too: it is found after the fetch and truncates the factorization."""
    if start >= m:
        return V, H, m
    cols = torch.zeros((m - start, m + 2), dtype=V.dtype, device=V.device)
    for idx, j in enumerate(range(start, m)):
        w = matvec(V[j].reshape(shape)).reshape(-1)
        Vj = V[:j + 1]
        h1 = Vj @ w
        w = w - h1 @ Vj
        h2 = Vj @ w
        w = w - h2 @ Vj
        beta = torch.sqrt(torch.sum(w * w))
        V[j + 1] = w / torch.where(beta > 0, beta, torch.ones_like(beta))
        cols[idx, :j + 1] = h1 + h2
        cols[idx, m + 1] = beta
    cols = cols.cpu().numpy()                   # the one host fetch
    for idx, j in enumerate(range(start, m)):
        H[:j + 1, j] = cols[idx, :j + 1]
        H[j + 1, j] = cols[idx, m + 1]
        if cols[idx, m + 1] == 0.0:
            return V, H, j + 1  # invariant subspace
    return V, H, m


def eigs(matvec: Callable, example: torch.Tensor, k: int = 10,
         ncv: int | None = None, maxiter: int = 40, tol: float = 1e-4,
         seed: int = 0) -> EigResult:
    """Largest-magnitude eigenvalues of the linear operator `matvec`.

    The defaults are the reference's EPS settings (nev=10, tol=1e-4,
    max_it=40). `example` fixes the vector shape, dtype and device. The
    start vector is drawn from a CPU `torch.Generator` seeded with `seed`
    and then moved to the device, so a seed gives the same start on every
    device."""
    if maxiter <= 0:
        return EigResult(np.empty(0, complex), np.empty(0), 0, 0)
    ncv = ncv or max(2 * k + 1, 20)
    shape = example.shape
    dtype, device = example.dtype, example.device
    N = example.numel()

    gen = torch.Generator().manual_seed(seed)
    v0 = torch.randn(N, generator=gen, dtype=dtype).to(device)
    v0 = v0 / torch.sqrt(torch.sum(v0 * v0))

    V = torch.zeros((ncv + 1, N), dtype=dtype, device=device)
    V[0] = v0
    H = np.zeros((ncv + 1, ncv))
    start = 0

    for it in range(maxiter):
        V, H, m = _arnoldi_extend(matvec, V, H, start, ncv, shape)
        Hm = H[:m, :m]
        beta = H[m, m - 1]

        # Ritz pairs of the (host, small) Hessenberg matrix
        evals, evecs = np.linalg.eig(Hm)
        order = np.argsort(-np.abs(evals))
        evals, evecs = evals[order], evecs[:, order]
        resids = np.abs(beta * evecs[m - 1, :])

        nconv = int(np.sum(resids[:k] < tol * np.maximum(np.abs(evals[:k]),
                                                         1e-30)))
        if nconv >= k or m < ncv:
            return EigResult(evals[:k], resids[:k], nconv, it + 1)

        # Krylov-Schur thick restart: the real Schur form with the ~p
        # largest-|lambda| eigenvalues first. The leading block spans an
        # exact invariant subspace of Hm, so the Arnoldi relation
        # A V_p = V_p T_p + v_m b^T survives the restart.
        p_want = min(max(k + 3, ncv // 2), m - 2)
        out = _sorted_real_schur(Hm, p_want)
        if out is None:
            # explicit restart from a combination of the wanted Ritz
            # vectors, keeping BOTH the real and the imaginary part of the
            # complex sum: for a conjugate pair they span its 2-D real
            # invariant subspace, where the real part alone can start the
            # restart orthogonal to a wanted vector
            csum = evecs[:, :k] @ np.ones(min(k, evecs.shape[1]))
            comb = np.real(csum) + np.imag(csum)
            vr = torch.as_tensor(comb, dtype=dtype, device=device) @ V[:m]
            vr = vr / torch.sqrt(torch.sum(vr * vr))
            V = torch.zeros_like(V)
            V[0] = vr
            H = np.zeros_like(H)
            start = 0
            continue
        T, Q, p = out
        Vk = torch.as_tensor(Q[:, :p].T.copy(), dtype=dtype,
                             device=device) @ V[:m]
        Vnew = torch.zeros_like(V)
        Vnew[:p] = Vk
        Vnew[p] = V[m]
        V = Vnew
        Hnew = np.zeros_like(H)
        Hnew[:p, :p] = T[:p, :p]
        Hnew[p, :p] = beta * Q[m - 1, :p]
        H = Hnew
        start = p

    return EigResult(evals[:k], resids[:k], nconv, maxiter)


def _sorted_real_schur(Hm: np.ndarray, p: int):
    """Real Schur form of Hm with ~p largest-|lambda| eigenvalues leading.
    Returns (T, Q, p_effective), or None if no Schur routine is available
    or the selection is empty or everything."""
    try:
        from scipy.linalg import schur
    except ImportError:  # pragma: no cover - scipy is installed
        return None
    evals = np.linalg.eigvals(Hm)
    mags = np.sort(np.abs(evals))[::-1]
    if p >= len(mags):
        p = len(mags) - 1
    # threshold between the p-th and (p+1)-th magnitude; conjugate pairs
    # share a magnitude, so a midpoint never splits them
    hi, lo = mags[p - 1], mags[p]
    thresh = 0.5 * (hi + lo)
    if hi == lo:
        thresh = hi - 1e-12 * max(hi, 1.0)

    def sel(re, im):
        return re * re + im * im > thresh * thresh

    T, Q, sdim = schur(Hm, output="real", sort=sel)
    p_eff = int(sdim)
    if p_eff < 1 or p_eff >= Hm.shape[0]:
        return None
    return T, Q, p_eff


def exact_eigenvalues(op) -> np.ndarray:
    """The full dense spectrum of a StencilOperator (small grids), sorted
    by |.| descending."""
    ev = np.linalg.eigvals(op.to_dense())
    return ev[np.argsort(-np.abs(ev))]


def preconditioned_spectrum(a_matvec: Callable, pc: Callable,
                            example: torch.Tensor, k: int = 10,
                            **kw) -> EigResult:
    """Spectrum of the right-preconditioned operator A*M^-1, without
    forming any dense product."""

    def mv(v):
        return a_matvec(pc(v))

    return eigs(mv, example, k=k, **kw)
