"""Krylov solvers: FGMRES / GMRES / CG (port of `mpbp_tpu/solvers/gmres.py`).

  * Orthogonalization is classical Gram-Schmidt with one
    re-orthogonalization pass (CGS2, the default), or CGS1 with a DGKS
    selective second pass. Each projection is one matmul against the basis
    rows built so far, so its cost grows with the current dimension j.
  * The Hessenberg QR is updated with Givens rotations on the host, in the
    working dtype: the projection coefficients and the new norm come to the
    host once per iteration, which is also the convergence test's sync.
  * Flexible preconditioning stores Z_j = M(v_j), since the inner solves
    (inner Krylov, multigrid) vary from call to call.

Vectors may have any shape (flat or stacked grid fields); the basis adds a
leading axis. The loops run eagerly; the convergence test costs one host
sync per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int                # number of iterations performed
    relres: float             # final relative residual estimate
    res_history: np.ndarray   # (maxiter+1,) residual-norm estimates, NaN-padded
    converged: bool


def flatten_op(op_apply: Callable, template: dict, fields) -> Callable:
    """Adapt a grid-field operator to flat vectors."""
    fields = tuple(fields)
    shapes = {f: tuple(template[f].shape) for f in fields}
    sizes = [int(np.prod(shapes[f])) for f in fields]
    offsets = np.concatenate([[0], np.cumsum(sizes)])

    def matvec(v):
        x = {f: v[int(offsets[i]):int(offsets[i + 1])].reshape(shapes[f])
             for i, f in enumerate(fields)}
        y = op_apply(x)
        return torch.cat([y[f].reshape(-1) for f in fields])

    return matvec


def _identity(v):
    return v


def _vdot(a, b):
    return torch.sum(a * b)


def _vnorm(a):
    return torch.sqrt(_vdot(a, a))


def _np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _host(t: torch.Tensor, npdt) -> np.ndarray:
    return t.detach().cpu().numpy().astype(npdt, copy=False)


def _cycle(matvec: Callable, b: torch.Tensor, x0: torch.Tensor, tol: float,
           m: int, M: Callable, use_z: bool, orthog: str = "cgs2",
           aug: torch.Tensor | None = None) -> KrylovResult:
    """One (F)GMRES cycle of at most m iterations.

    `aug`: optional (k, *S) augmentation directions consumed as the LAST k
    flexible directions of the cycle (z_j = aug[j - (m-k)] for j >= m-k
    instead of M(v_j)): the LGMRES augmented restart. The flexible
    recurrence never requires z_j = M(v_j), so the minimization runs over
    K_{m-k} + span{aug}. They must come last: the Krylov chain grows from
    the previous v_j, so aug-first builds it on A*aug instead of r0."""
    if orthog not in ("cgs2", "cgs1"):
        raise ValueError(f"unknown orthog {orthog!r}")
    S = b.shape
    N = b.numel()
    npdt = _np_dtype(b.dtype)
    b_norm = float(_vnorm(b))
    safe_bnorm = npdt(1.0 if b_norm == 0 else b_norm)

    r0 = b - matvec(x0)
    beta = npdt(float(_vnorm(r0)))
    V = torch.zeros((m + 1, N), dtype=b.dtype, device=b.device)
    Z = torch.zeros((m if use_z else 0, N), dtype=b.dtype, device=b.device)
    V[0] = (r0 / float(beta) if beta > 0 else r0).reshape(-1)
    H = np.zeros((m + 1, m), npdt)      # the rotated Hessenberg (R factor)
    cs = np.zeros(m, npdt)
    sn = np.zeros(m, npdt)
    g = np.zeros(m + 1, npdt)
    g[0] = beta
    hist = np.full(m + 1, np.nan, npdt)
    hist[0] = beta
    done = bool(beta / safe_bnorm < tol)
    k_aug = 0 if aug is None else aug.shape[0]

    j = 0
    while not done and j < m:
        v = V[j].reshape(S)
        if k_aug and j >= m - k_aug:
            z = aug[j - (m - k_aug)].to(b.dtype)
        else:
            z = M(v)
        w = matvec(z).reshape(-1)
        if use_z:
            Z[j] = z.reshape(-1)

        Vj = V[:j + 1]
        if orthog == "cgs2":
            wnorm_pre = _vnorm(w)
            h1 = Vj @ w
            w = w - h1 @ Vj
            h2 = Vj @ w
            w = w - h2 @ Vj
            hw = torch.cat([h1 + h2, _vnorm(w)[None], wnorm_pre[None]])
            hv = _host(hw, npdt)
            h, wnorm, wnorm_pre = hv[:j + 1], hv[j + 1], hv[j + 2]
        else:
            # CGS1: one fused reduction [V; w]^T w gives the projections
            # and ||w||^2; the new norm comes from the Pythagorean identity,
            # with a second pass when the projection removed more than
            # 1/sqrt(2) of w (DGKS)
            def cgs_pass(w):
                dots = torch.cat([Vj, w[None]]) @ w
                hv = _host(dots, npdt)
                hp, ww = hv[:-1], hv[-1]
                w = w - dots[:-1] @ Vj
                return hp, ww, ww - np.sum(hp * hp), w

            h, ww, est2, w = cgs_pass(w)
            wnorm_pre = np.sqrt(max(ww, npdt(0)))
            if est2 < 0.5 * ww:
                h2, _, est2, w = cgs_pass(w)
                h = h + h2
            wnorm = np.sqrt(max(est2, npdt(0)))

        # happy breakdown: A z landed inside the current Krylov space; the
        # column ends here and the solve stops after this update
        breakdown = bool(wnorm <= 1e-12 * wnorm_pre)
        col = np.zeros(m + 1, npdt)
        col[:j + 1] = h
        col[j + 1] = 0 if breakdown else wnorm
        if not breakdown:
            V[j + 1] = w / float(wnorm) if wnorm > 0 else w

        for i in range(j):
            hi = cs[i] * col[i] + sn[i] * col[i + 1]
            hip = -sn[i] * col[i] + cs[i] * col[i + 1]
            col[i], col[i + 1] = hi, hip

        rho = np.sqrt(col[j] ** 2 + col[j + 1] ** 2)
        c_new = npdt(1) if rho == 0 else col[j] / rho
        s_new = npdt(0) if rho == 0 else col[j + 1] / rho
        cs[j], sn[j] = c_new, s_new
        col[j] = c_new * col[j] + s_new * col[j + 1]
        col[j + 1] = 0
        H[:, j] = col

        g_jp1 = -s_new * g[j]
        g[j] = c_new * g[j]
        g[j + 1] = g_jp1
        res = abs(g_jp1)
        hist[j + 1] = res
        j += 1
        done = bool(res / safe_bnorm < tol) or breakdown

    x = x0
    if j > 0:
        y = np.zeros(j, npdt)
        for i in range(j - 1, -1, -1):
            y[i] = (g[i] - H[i, i + 1:j] @ y[i + 1:]) / H[i, i]
        yt = torch.as_tensor(y, dtype=b.dtype, device=b.device)
        if use_z:
            dx = yt @ Z[:j]
        else:
            dx = M((yt @ V[:j]).reshape(S)).reshape(-1)
        x = x0 + dx.reshape(S)
    res_final = abs(g[min(j, m)]) if j > 0 else hist[0]
    return KrylovResult(x, j, float(res_final / safe_bnorm), hist, done)


def fgmres(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
           tol: float = 1e-8, maxiter: int = 100,
           M: Callable | None = None, restart: int | None = None,
           orthog: str = "cgs2", aug_k: int = 0) -> KrylovResult:
    """Flexible right-preconditioned GMRES.

    No restarts by default: maxiter is the Krylov dimension. Pass `restart`
    to run restarted cycles. orthog: 'cgs2' (default) or 'cgs1'.

    aug_k > 0 (restarted solves only) enables LGMRES-style augmented
    restarts: the LAST aug_k flexible directions of each cycle are the
    normalized corrections dx of the previous cycles."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = _identity if M is None else M
    if restart is None or restart >= maxiter:
        return _cycle(matvec, b, x0, tol, maxiter, M, True, orthog)
    return _restarted(matvec, b, x0, tol, maxiter, restart, M, True, orthog,
                      aug_k)


def gmres(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
          tol: float = 1e-8, maxiter: int = 100,
          M: Callable | None = None, restart: int | None = None,
          orthog: str = "cgs2") -> KrylovResult:
    """Right-preconditioned GMRES with a fixed preconditioner: no Z basis;
    M is applied once more at the solution update."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = _identity if M is None else M
    if restart is None or restart >= maxiter:
        return _cycle(matvec, b, x0, tol, maxiter, M, False, orthog)
    return _restarted(matvec, b, x0, tol, maxiter, restart, M, False, orthog)


def residual_norm(matvec: Callable, b: torch.Tensor, x: torch.Tensor):
    """(r, ||r||) = (b - A x, its 2-norm)."""
    r = b - matvec(x)
    return r, _vnorm(r)


def _restarted(matvec, b, x0, tol, maxiter, restart, M, use_z, orthog,
               aug_k: int = 0) -> KrylovResult:
    """Host loop over cycles with a stitched history: the initial residual,
    then one entry per iteration (each later cycle's entry 0 duplicates the
    previous cycle's final residual and is dropped), so iters equals
    len(history) - 1.

    aug_k > 0 keeps the last aug_k normalized cycle corrections dx and
    seeds the next cycle with them."""
    x = x0
    total_iters = 0
    hists = []
    result = None
    remaining = maxiter
    augs: list = []
    while remaining > 0:
        cycle = min(restart, remaining)
        # aug needs room for a genuine Krylov part (cycle > k+1); the final
        # short cycle runs plain
        aug = torch.stack(augs) if augs and cycle > len(augs) + 1 else None
        result = _cycle(matvec, b, x, tol, cycle, M, use_z, orthog, aug)
        it = result.iters
        if aug_k > 0 and it > 0:
            dx = result.x - x
            nrm = float(_vnorm(dx))
            augs = (augs + [dx / nrm])[-aug_k:] if nrm > 0 else []
        x = result.x
        total_iters += it
        h = result.res_history[: it + 1]
        hists.append(h if not hists else h[1:])
        remaining -= it if it > 0 else cycle   # breakdown: don't loop forever
        if result.converged or it == 0:
            break
    hist = np.concatenate(hists)
    full_hist = np.full(maxiter + 1, np.nan, hist.dtype)
    full_hist[: len(hist)] = hist
    return KrylovResult(x, total_iters, result.relres, full_hist,
                        result.converged)


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
       tol: float = 1e-8, maxiter: int = 200, M: Callable = _identity
       ) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD operators."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    npdt = _np_dtype(b.dtype)
    b_norm = float(_vnorm(b))
    safe_bnorm = 1.0 if b_norm == 0 else b_norm

    x = x0
    r = b - matvec(x0)
    z = M(r)
    p = z
    rz = _vdot(r, z)
    rn = float(_vnorm(r))
    hist = np.full(maxiter + 1, np.nan, npdt)
    hist[0] = rn
    done = rn / safe_bnorm < tol
    j = 0
    while not done and j < maxiter:
        Ap = matvec(p)
        pAp = _vdot(p, Ap)
        alpha = torch.where(pAp != 0, rz / pAp, torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _vdot(r, z)
        beta = torch.where(rz != 0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
        rn = float(_vnorm(r))
        hist[j + 1] = rn
        j += 1
        done = rn / safe_bnorm < tol
    return KrylovResult(x, j, rn / safe_bnorm, hist, bool(done))


def jacobi(matvec: Callable, diag: torch.Tensor, b: torch.Tensor,
           iters: int = 200, x0: torch.Tensor | None = None) -> torch.Tensor:
    """Jacobi sweeps x <- x + D^-1 (b - A x)."""
    x = torch.zeros_like(b) if x0 is None else x0
    inv_d = 1.0 / diag
    for _ in range(iters):
        x = x + inv_d * (b - matvec(x))
    return x
