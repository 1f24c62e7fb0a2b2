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
sync per iteration. One iteration is `_arnoldi_step` on an `ArnoldiState`,
so `fgmres_resumable` can stop after any iteration and resume.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(eq=False)
class ArnoldiState:
    """Mid-solve FGMRES/GMRES state (port of the JAX package's
    `ArnoldiState`). Resuming with the same (matvec, b, x0, maxiter, M)
    continues the identical Krylov recurrence. The bases stay on the
    vectors' device; the rotated Hessenberg, the Givens rotations, the
    rotated rhs and the history live on the host in the working dtype.
    A step advances the state in place."""

    j: int                # iterations completed
    V: torch.Tensor       # (m+1, N) orthonormal basis
    Z: torch.Tensor       # (m or 0, N) flexible preconditioned basis
    H: np.ndarray         # (m+1, m) rotated Hessenberg (R factor)
    cs: np.ndarray        # (m,) Givens cosines
    sn: np.ndarray        # (m,) Givens sines
    g: np.ndarray         # (m+1,) rotated rhs
    hist: np.ndarray      # (m+1,) residual estimates, NaN-padded
    done: bool            # convergence/breakdown flag
    lost: bool = False    # done on a column that was dropped: not converged


def _safe_bnorm(b: torch.Tensor):
    b_norm = float(_vnorm(b))
    return _np_dtype(b.dtype)(1.0 if b_norm == 0 else b_norm)


def _arnoldi_init(matvec: Callable, b: torch.Tensor, x0: torch.Tensor,
                  tol: float, m: int, use_z: bool,
                  safe_bnorm) -> ArnoldiState:
    """Fresh Arnoldi state of an m-iteration cycle from the residual at x0."""
    N = b.numel()
    npdt = _np_dtype(b.dtype)
    r0 = b - matvec(x0)
    beta = npdt(float(_vnorm(r0)))
    V = torch.zeros((m + 1, N), dtype=b.dtype, device=b.device)
    Z = torch.zeros((m if use_z else 0, N), dtype=b.dtype, device=b.device)
    V[0] = (r0 / float(beta) if beta > 0 else r0).reshape(-1)
    g = np.zeros(m + 1, npdt)
    g[0] = beta
    hist = np.full(m + 1, np.nan, npdt)
    hist[0] = beta
    return ArnoldiState(0, V, Z, np.zeros((m + 1, m), npdt), np.zeros(m, npdt),
                        np.zeros(m, npdt), g, hist,
                        bool(beta / safe_bnorm < tol))


def _arnoldi_step(state: ArnoldiState, matvec: Callable, M: Callable,
                  shape, tol: float, use_z: bool, orthog: str, safe_bnorm,
                  aug: torch.Tensor | None = None) -> None:
    """One FGMRES iteration on `state`, in place.

    `aug`: optional (k, *S) augmentation directions consumed as the LAST k
    flexible directions of the cycle (z_j = aug[j - (m-k)] for j >= m-k
    instead of M(v_j)): the LGMRES augmented restart. The flexible
    recurrence never requires z_j = M(v_j), so the minimization runs over
    K_{m-k} + span{aug}. They must come last: the Krylov chain grows from
    the previous v_j, so aug-first builds it on A*aug instead of r0."""
    j, V, H, cs, sn, g = state.j, state.V, state.H, state.cs, state.sn, \
        state.g
    m = H.shape[1]
    npdt = H.dtype.type
    k_aug = 0 if aug is None else aug.shape[0]
    v = V[j].reshape(shape)
    if k_aug and j >= m - k_aug:
        z = aug[j - (m - k_aug)].to(V.dtype)
    else:
        z = M(v)
    w = matvec(z).reshape(-1)
    if use_z:
        state.Z[j] = z.reshape(-1)

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

    # breakdown: A z landed inside the current basis's span, and the column
    # ends the cycle
    breakdown = bool(wnorm <= 1e-12 * wnorm_pre)
    col = np.zeros(m + 1, npdt)
    col[:j + 1] = h
    col[j + 1] = 0 if breakdown else wnorm

    for i in range(j):
        hi = cs[i] * col[i] + sn[i] * col[i + 1]
        hip = -sn[i] * col[i] + cs[i] * col[i + 1]
        col[i], col[i + 1] = hi, hip

    rho = np.sqrt(col[j] ** 2 + col[j + 1] ** 2)
    scale = max(np.abs(H[:j, :j]).max(initial=npdt(0)), wnorm_pre)
    if breakdown and rho <= max(1e-12, 100 * np.finfo(npdt).eps) * scale:
        # not a happy breakdown: z_j repeats a direction of Z (a variable
        # preconditioner, or an augmentation along an earlier z), so H is
        # singular and its rotated diagonal is rounding noise. The estimate
        # would read 0 and the back-substitution divide by that noise; the
        # cycle ends at the last good column without claiming convergence
        # (the JAX package's FGMRES does claim it here). A breakdown with H
        # nonsingular, augmentation column or not, is an exact solve.
        state.done = state.lost = True
        return
    if not breakdown:
        V[j + 1] = w / float(wnorm) if wnorm > 0 else w
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
    state.hist[j + 1] = res
    state.j = j + 1
    state.done = bool(res / safe_bnorm < tol) or breakdown


def _arnoldi_solution(state: ArnoldiState, x0: torch.Tensor, M: Callable,
                      use_z: bool, safe_bnorm) -> KrylovResult:
    """Assemble x from the (possibly mid-solve) Arnoldi state."""
    j, H, g = state.j, state.H, state.g
    m = H.shape[1]
    x = x0
    if j > 0:
        y = np.zeros(j, H.dtype)
        for i in range(j - 1, -1, -1):
            y[i] = (g[i] - H[i, i + 1:j] @ y[i + 1:]) / H[i, i]
        yt = torch.as_tensor(y, dtype=x0.dtype, device=x0.device)
        if use_z:
            dx = yt @ state.Z[:j]
        else:
            dx = M((yt @ state.V[:j]).reshape(x0.shape)).reshape(-1)
        x = x0 + dx.reshape(x0.shape)
    res_final = abs(g[min(j, m)]) if j > 0 else state.hist[0]
    return KrylovResult(x, j, float(res_final / safe_bnorm), state.hist,
                        state.done and not state.lost)


def _cycle(matvec: Callable, b: torch.Tensor, x0: torch.Tensor, tol: float,
           m: int, M: Callable, use_z: bool, orthog: str = "cgs2",
           aug: torch.Tensor | None = None) -> KrylovResult:
    """One (F)GMRES cycle of at most m iterations (`aug`: see
    `_arnoldi_step`)."""
    if orthog not in ("cgs2", "cgs1"):
        raise ValueError(f"unknown orthog {orthog!r}")
    safe_bnorm = _safe_bnorm(b)
    state = _arnoldi_init(matvec, b, x0, tol, m, use_z, safe_bnorm)
    while not state.done and state.j < m:
        _arnoldi_step(state, matvec, M, b.shape, tol, use_z, orthog,
                      safe_bnorm, aug)
    return _arnoldi_solution(state, x0, M, use_z, safe_bnorm)


def fgmres_resumable(matvec: Callable, b: torch.Tensor,
                     x0: torch.Tensor | None = None, tol: float = 1e-8,
                     maxiter: int = 100, M: Callable | None = None,
                     orthog: str = "cgs2", state: ArnoldiState | None = None,
                     max_steps: int | None = None
                     ) -> tuple[KrylovResult, ArnoldiState]:
    """Flexible GMRES that can stop mid-solve and resume exactly.

    Returns (result, state). Run with `max_steps=k` to advance at most k
    iterations; resume by passing the state back (with the same
    b/x0/maxiter/M). The steps are those of one uninterrupted `fgmres`
    cycle, so the iterates and history match it. The state is advanced in
    place (the JAX package returns a new one)."""
    if orthog not in ("cgs2", "cgs1"):
        raise ValueError(f"unknown orthog {orthog!r}")
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = _identity if M is None else M
    safe_bnorm = _safe_bnorm(b)
    if state is None:
        state = _arnoldi_init(matvec, b, x0, tol, maxiter, True, safe_bnorm)
    elif state.H.shape[1] != maxiter:
        raise ValueError(f"state is of a {state.H.shape[1]}-iteration "
                         f"cycle, maxiter is {maxiter}")
    j_stop = maxiter if max_steps is None else min(state.j + max_steps,
                                                   maxiter)
    while not state.done and state.j < j_stop:
        _arnoldi_step(state, matvec, M, b.shape, tol, True, orthog,
                      safe_bnorm)
    return _arnoldi_solution(state, x0, M, True, safe_bnorm), state


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
    seeds the next cycle with them. A cycle that ends early without
    converging dropped a column (`_arnoldi_step`): the augmentations are
    dropped too, and the next cycle runs plain."""
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
        if not result.converged and it < cycle:
            augs = []
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
