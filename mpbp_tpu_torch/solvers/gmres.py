"""Krylov solvers: FGMRES / GMRES / CG (port of `mpbp_tpu/solvers/gmres.py`).

  * Orthogonalization is classical Gram-Schmidt with one
    re-orthogonalization pass (CGS2, the default), or CGS1 with a DGKS
    selective second pass. Each projection is one matmul against the basis
    rows built so far, so its cost grows with the current dimension j.
  * The Arnoldi state lives on the vectors' device, as the JAX package's
    while_loop carry does: the rotated Hessenberg, the Givens rotations,
    the rotated rhs, the history, the count j and the done/lost flags are
    tensors in the working dtype. The new column is rotated through the
    earlier rotations on the device, one at a time in the host's order of
    operations (so the rotated column has the host loop's bits), and the
    breakdown and stop tests are device masks, not branches.
  * Flexible preconditioning stores Z_j = M(v_j), since the inner solves
    (inner Krylov, multigrid) vary from call to call.

Two kinds of loop drive the one Arnoldi step. The early-exit loops
(`fgmres`, `gmres`, `fgmres_resumable`, `cg`, restarted cycles) read the
`done` flag once an iteration and build a `KrylovResult` of host types
after the loop, from one read of the state; they back-substitute on the
host, in the working dtype, so their iterates have the bits of a solver
that keeps H on the host (at tol 1e-10 the card's sharded 1024^2 count
sits at the f64 floor and follows those bits). The fixed-budget loops
(`gmres_fixed`, `cg_fixed`: the inner solves of the preconditioners) are
`lax.while_loop` with its static bound: `solvers/graphs.loop` steps them
while ~done & (j < m), through a CUDA-graph IF node a step under capture,
by a read of `done` a step when eager, or all `maxiter` steps masked
inside `graphs.masked()`. A step after `done` changes nothing (every
update is masked, in place), and they back-substitute on the device, so
x, the count and the census are the same bits in all three ways, the
count is an early-exit run's and x is its x to rounding. The fixed-budget
GMRES cycle's own work (CGS2, the Givens tail, the cycle's start and
solution) runs as kernel K13 on CUDA (`ops/cuda_krylov.py`); the
early-exit loops keep the per-op projection and share its plain tail.

Vectors may have any shape (flat or stacked grid fields); the basis adds a
leading axis. One iteration is `_arnoldi_step` on an `ArnoldiState`, so
`fgmres_resumable` can stop after any iteration and resume.

Under a row-sharded mesh (`parallel/sharding.py`) each rank holds its band
of every vector and passes the axis's process group as `group`: every
inner product and norm is then one all-reduce over it, and every flag and
loop exit is computed from all-reduced values, which NCCL and gloo give
every rank bit for bit, so the ranks step alike. CGS2 batches the first
projection with the norm before it into one all-reduce a pass. Without
`group` nothing is reduced and the arithmetic is the single-device one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from mpbp_tpu_torch.ops import cuda_krylov
from mpbp_tpu_torch.ops.cuda_krylov import over as _over, put as _put
from mpbp_tpu_torch.solvers import graphs
from mpbp_tpu_torch.utils import metrics


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int                # number of iterations performed
    relres: float             # final relative residual estimate
    res_history: np.ndarray   # (maxiter+1,) residual-norm estimates, NaN-padded
    converged: bool


class DeviceResult(NamedTuple):
    """What a fixed-budget solve returns: nothing is read back."""

    x: torch.Tensor
    iters: torch.Tensor       # () int64 on x's device: the converged count


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


def _allsum(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the ranks of `group` (in place), or t itself."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _vdot(a, b, group=None):
    return _allsum(torch.sum(a * b), group)


def _vnorm(a, group=None):
    return torch.sqrt(_vdot(a, a, group))


@dataclasses.dataclass(eq=False)
class ArnoldiState:
    """Mid-solve FGMRES/GMRES state (port of the JAX package's
    `ArnoldiState`). Resuming with the same (matvec, b, x0, maxiter, M)
    continues the identical Krylov recurrence. Every field is a tensor on
    the vectors' device, in the working dtype (j: int64, done/lost: bool).
    A step advances the state in place: every field stays the tensor
    `_arnoldi_init` made (an IF body that did not run must leave the
    state readable, `solvers/graphs.py`)."""

    j: torch.Tensor       # () iterations completed
    V: torch.Tensor       # (m+1, N) orthonormal basis
    Z: torch.Tensor       # (m or 0, N) flexible preconditioned basis
    H: torch.Tensor       # (m+1, m) rotated Hessenberg (R factor)
    cs: torch.Tensor      # (m,) Givens cosines
    sn: torch.Tensor      # (m,) Givens sines
    g: torch.Tensor       # (m+1,) rotated rhs
    hist: torch.Tensor    # (m+1,) residual estimates, NaN-padded
    done: torch.Tensor    # () convergence/breakdown flag
    lost: torch.Tensor    # () done on a column that was dropped


def _safe_bnorm(b: torch.Tensor, group=None) -> torch.Tensor:
    b_norm = _vnorm(b, group)
    return torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)


def _arnoldi_init(matvec: Callable, b: torch.Tensor, x0: torch.Tensor,
                  tol: float, m: int, use_z: bool,
                  safe_bnorm, group=None) -> ArnoldiState:
    """Fresh Arnoldi state of an m-iteration cycle from the residual at x0."""
    N = b.numel()
    kw = dict(dtype=b.dtype, device=b.device)
    r0 = b - matvec(x0)
    beta = _vnorm(r0, group)
    V = torch.zeros((m + 1, N), **kw)
    Z = torch.zeros((m if use_z else 0, N), **kw)
    V[0] = _over(r0, torch.where(beta > 0, beta, torch.ones_like(beta))
                 ).reshape(-1)
    g = torch.zeros(m + 1, **kw)
    g[0] = beta
    hist = torch.full((m + 1,), float("nan"), **kw)
    hist[0] = beta
    return ArnoldiState(
        torch.zeros((), dtype=torch.int64, device=b.device), V, Z,
        torch.zeros((m + 1, m), **kw), torch.zeros(m, **kw),
        torch.zeros(m, **kw), g, hist, beta / safe_bnorm < tol,
        torch.zeros((), dtype=torch.bool, device=b.device))


def _orthogonalize(V: torch.Tensor, w: torch.Tensor, s: int, orthog: str,
                   group):
    """Project w off basis rows 0..s: (w, h, ||w||, ||w|| before)."""
    Vj = V[:s + 1]
    if orthog == "cgs2":
        # [h1, ||w||^2] in one reduction, then h2, then the new norm
        hw = _allsum(torch.cat([Vj @ w, torch.sum(w * w)[None]]), group)
        h1 = hw[:-1]
        w = w - h1 @ Vj
        h2 = _allsum(Vj @ w, group)
        w = w - h2 @ Vj
        return w, h1 + h2, _vnorm(w, group), torch.sqrt(hw[-1])
    # CGS1: one fused reduction [V; w]^T w gives the projections and
    # ||w||^2; the new norm comes from the Pythagorean identity, with a
    # second pass where the projection removed more than 1/sqrt(2) of w
    # (DGKS). The second pass is always computed and taken by mask: the
    # branch would read the host

    def cgs_pass(w):
        dots = _allsum(torch.cat([Vj, w[None]]) @ w, group)
        hp, ww = dots[:-1], dots[-1]
        return hp, ww, ww - torch.sum(hp * hp), w - hp @ Vj

    h, ww, est2, w = cgs_pass(w)
    h2, _, est2b, w2 = cgs_pass(w)
    again = est2 < 0.5 * ww
    zero = torch.zeros_like(ww)
    return (torch.where(again, w2, w), torch.where(again, h + h2, h),
            torch.sqrt(torch.maximum(torch.where(again, est2b, est2), zero)),
            torch.sqrt(torch.maximum(ww, zero)))


def _arnoldi_step(state: ArnoldiState, matvec: Callable, M: Callable,
                  shape, s: int, tol: float, use_z: bool, orthog: str,
                  safe_bnorm, aug: torch.Tensor | None = None,
                  group=None, traced: bool = False) -> None:
    """FGMRES iteration s of a cycle on `state`, in place, with no host
    read. Every update is taken only where the state was not done, so a
    step after done changes nothing (the fixed-budget loops); while not
    done, s equals state.j (the early-exit loops step only then).

    `traced` (the early-exit loops' steps): the projection is the span
    krylov.orthogonalize (attr `basis_rows`, s + 1), on a CUDA device
    with its `device_time` pair of the same name. A fixed-budget step may
    run under a graph capture, where no event pair is recorded.

    `aug`: optional (k, *S) augmentation directions consumed as the LAST k
    flexible directions of the cycle (z_j = aug[j - (m-k)] for j >= m-k
    instead of M(v_j)): the LGMRES augmented restart. The flexible
    recurrence never requires z_j = M(v_j), so the minimization runs over
    K_{m-k} + span{aug}. They must come last: the Krylov chain grows from
    the previous v_j, so aug-first builds it on A*aug instead of r0."""
    V = state.V
    m = state.H.shape[1]
    live = ~state.done
    k_aug = 0 if aug is None else aug.shape[0]
    if k_aug and s >= m - k_aug:
        z = aug[s - (m - k_aug)].to(V.dtype)
    else:
        z = M(V[s].reshape(shape))
    w = matvec(z).reshape(-1)
    if use_z:
        _put(state.Z[s], z.reshape(-1), live)

    if traced:
        with metrics.span("krylov.orthogonalize", basis_rows=s + 1), \
                (metrics.device_time("krylov.orthogonalize") if w.is_cuda
                 else contextlib.nullcontext()):
            w, h, wnorm, wnorm_pre = _orthogonalize(V, w, s, orthog, group)
    else:
        w, h, wnorm, wnorm_pre = _orthogonalize(V, w, s, orthog, group)
    cuda_krylov.tail_reference(state, w, h, wnorm, wnorm_pre, s, tol,
                               safe_bnorm)


@metrics.spanned("krylov.result")
def _host_result(state: ArnoldiState, x0: torch.Tensor, M: Callable,
                 use_z: bool, safe_bnorm) -> KrylovResult:
    """The KrylovResult of an early-exit loop: one read of the state's
    scalars, H, g and history, the back-substitution over its first j
    columns on the host in the working dtype, and x on the device."""
    m = state.H.shape[1]
    dt = state.H.dtype
    ok = state.done & ~state.lost
    host = torch.cat([state.H.reshape(-1), state.g, state.hist,
                      torch.stack((safe_bnorm, state.j.to(dt), ok.to(dt)))
                      ]).cpu().numpy()
    bnorm, j, ok = host[-3], int(host[-2]), bool(host[-1])
    H = host[:(m + 1) * m].reshape(m + 1, m)
    g, hist = host[(m + 1) * m:][:m + 1], host[(m + 1) * (m + 1):][:m + 1]
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
    res_final = abs(g[j]) if j > 0 else hist[0]
    return KrylovResult(x, j, float(res_final / bnorm), hist, ok)


def _steps(state: ArnoldiState, j: int, j_stop: int,
           step: Callable) -> None:
    """Step the state from its iteration j while not done, up to j_stop:
    one host read of `done` an iteration."""
    while j < j_stop:
        with metrics.span("krylov.read_done"):
            done = bool(state.done)
        if done:
            break
        with metrics.span("krylov.step"):
            step(j)
        j += 1


def _cycle(matvec: Callable, b: torch.Tensor, x0: torch.Tensor, tol: float,
           m: int, M: Callable, use_z: bool, orthog: str = "cgs2",
           aug: torch.Tensor | None = None, group=None) -> KrylovResult:
    """One (F)GMRES cycle of at most m iterations, exiting early (`aug`:
    see `_arnoldi_step`)."""
    _check_orthog(orthog)
    with metrics.span("krylov.init"):
        safe_bnorm = _safe_bnorm(b, group)
        state = _arnoldi_init(matvec, b, x0, tol, m, use_z, safe_bnorm,
                              group)
        metrics.count("krylov.basis_bytes", state.V.nbytes + state.Z.nbytes)
    _steps(state, 0, m, lambda s: _arnoldi_step(
        state, matvec, M, b.shape, s, tol, use_z, orthog, safe_bnorm, aug,
        group, traced=True))
    return _host_result(state, x0, M, use_z, safe_bnorm)


def _fixed_cycle(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None,
                 tol: float, m: int, M: Callable,
                 orthog: str = "cgs2") -> DeviceResult:
    """One GMRES cycle of at most m steps (`graphs.loop`), x
    back-substituted on the device. With CGS2 the cycle's own work runs as
    K13 (`ops/cuda_krylov.py`: kernels on CUDA, the per-op code on the
    CPU); CGS1 steps `_arnoldi_step`. A zero x0 (None) is not applied:
    r0 is b."""
    _check_orthog(orthog)
    flat = b.reshape(-1)
    if orthog == "cgs2":
        r0 = flat if x0 is None else (b - matvec(x0)).reshape(-1)
        st = cuda_krylov.init(flat, r0, tol, m)

        def step(s):
            w = matvec(M(st.V[s].reshape(b.shape))).reshape(-1)
            cuda_krylov.step(st, w, s, tol)
    else:
        safe_bnorm = _safe_bnorm(b)
        st = _arnoldi_init(matvec, b, torch.zeros_like(b) if x0 is None
                           else x0, tol, m, False, safe_bnorm)

        def step(s):
            _arnoldi_step(st, matvec, M, b.shape, s, tol, False, orthog,
                          safe_bnorm)
    graphs.loop(st.done, st.j, m, step)
    x = M(cuda_krylov.solution(st).reshape(b.shape))
    return DeviceResult(x if x0 is None else x0 + x, st.j)


def _check_orthog(orthog: str) -> None:
    if orthog not in ("cgs2", "cgs1"):
        raise ValueError(f"unknown orthog {orthog!r}")


@metrics.spanned("krylov.solve")
def fgmres_resumable(matvec: Callable, b: torch.Tensor,
                     x0: torch.Tensor | None = None, tol: float = 1e-8,
                     maxiter: int = 100, M: Callable | None = None,
                     orthog: str = "cgs2", state: ArnoldiState | None = None,
                     max_steps: int | None = None, group=None
                     ) -> tuple[KrylovResult, ArnoldiState]:
    """Flexible GMRES that can stop mid-solve and resume exactly.

    Returns (result, state). Run with `max_steps=k` to advance at most k
    iterations; resume by passing the state back (with the same
    b/x0/maxiter/M). The steps are those of one uninterrupted `fgmres`
    cycle, so the iterates and history match it. The state is advanced in
    place (the JAX package returns a new one)."""
    _check_orthog(orthog)
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = _identity if M is None else M
    safe_bnorm = _safe_bnorm(b, group)
    if state is None:
        with metrics.span("krylov.init"):
            state = _arnoldi_init(matvec, b, x0, tol, maxiter, True,
                                  safe_bnorm, group)
            metrics.count("krylov.basis_bytes",
                          state.V.nbytes + state.Z.nbytes)
    elif state.H.shape[1] != maxiter:
        raise ValueError(f"state is of a {state.H.shape[1]}-iteration "
                         f"cycle, maxiter is {maxiter}")
    j0 = int(state.j)
    j_stop = maxiter if max_steps is None else min(j0 + max_steps, maxiter)
    _steps(state, j0, j_stop, lambda s: _arnoldi_step(
        state, matvec, M, b.shape, s, tol, True, orthog, safe_bnorm,
        group=group, traced=True))
    return _host_result(state, x0, M, True, safe_bnorm), state


@metrics.spanned("krylov.solve")
def fgmres(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
           tol: float = 1e-8, maxiter: int = 100,
           M: Callable | None = None, restart: int | None = None,
           orthog: str = "cgs2", aug_k: int = 0,
           group=None) -> KrylovResult:
    """Flexible right-preconditioned GMRES.

    No restarts by default: maxiter is the Krylov dimension. Pass `restart`
    to run restarted cycles. orthog: 'cgs2' (default) or 'cgs1'.

    aug_k > 0 (restarted solves only) enables LGMRES-style augmented
    restarts: the LAST aug_k flexible directions of each cycle are the
    normalized corrections dx of the previous cycles. `group`: the process
    group whose ranks hold the vectors' bands (module docstring)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = _identity if M is None else M
    if restart is None or restart >= maxiter:
        return _cycle(matvec, b, x0, tol, maxiter, M, True, orthog,
                      group=group)
    return _restarted(matvec, b, x0, tol, maxiter, restart, M, True, orthog,
                      aug_k, group)


@metrics.spanned("krylov.solve")
def gmres(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
          tol: float = 1e-8, maxiter: int = 100,
          M: Callable | None = None, restart: int | None = None,
          orthog: str = "cgs2", group=None) -> KrylovResult:
    """Right-preconditioned GMRES with a fixed preconditioner: no Z basis;
    M is applied once more at the solution update."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = _identity if M is None else M
    if restart is None or restart >= maxiter:
        return _cycle(matvec, b, x0, tol, maxiter, M, False, orthog,
                      group=group)
    return _restarted(matvec, b, x0, tol, maxiter, restart, M, False, orthog,
                      group=group)


def gmres_fixed(matvec: Callable, b: torch.Tensor,
                x0: torch.Tensor | None = None, tol: float = 1e-8,
                maxiter: int = 100, M: Callable | None = None,
                orthog: str = "cgs2") -> DeviceResult:
    """`gmres` (one cycle) as a fixed budget of maxiter steps
    (`graphs.loop`): x and the on-device count of an early-exit run."""
    M = _identity if M is None else M
    return _fixed_cycle(matvec, b, x0, tol, maxiter, M, orthog)


def residual_norm(matvec: Callable, b: torch.Tensor, x: torch.Tensor,
                  group=None):
    """(r, ||r||) = (b - A x, its 2-norm), both on the device."""
    r = b - matvec(x)
    return r, _vnorm(r, group)


def _restarted(matvec, b, x0, tol, maxiter, restart, M, use_z, orthog,
               aug_k: int = 0, group=None) -> KrylovResult:
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
        result = _cycle(matvec, b, x, tol, cycle, M, use_z, orthog, aug,
                        group)
        it = result.iters
        if aug_k > 0 and it > 0:
            dx = result.x - x
            nrm = float(_vnorm(dx, group))
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


@dataclasses.dataclass(eq=False)
class _CGState:
    """The CG carry (the JAX package's `_cg_jit` loop state, z apart: no
    step reads it), on the device. A step writes every field in place."""

    j: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rn: torch.Tensor
    hist: torch.Tensor
    done: torch.Tensor


def _cg_init(matvec, b, x0, tol, maxiter, M, safe_bnorm, group) -> _CGState:
    r = b - matvec(x0)
    z = M(r)
    rn = _vnorm(r, group)
    hist = torch.full((maxiter + 1,), float("nan"), dtype=b.dtype,
                      device=b.device)
    hist[0] = rn
    return _CGState(torch.zeros((), dtype=torch.int64, device=b.device),
                    x0.clone(), r, z.clone(), _vdot(r, z, group), rn, hist,
                    rn / safe_bnorm < tol)


def _cg_step(st: _CGState, matvec, M, s: int, tol, safe_bnorm,
             group) -> None:
    """CG iteration s on `st`, every update masked as `_arnoldi_step`'s."""
    live = ~st.done
    Ap = matvec(st.p)
    pAp = _vdot(st.p, Ap, group)
    zero = torch.zeros_like(pAp)
    alpha = torch.where(pAp != 0, st.rz / pAp, zero)
    x = st.x + alpha * st.p
    r = st.r - alpha * Ap
    z = M(r)
    rz = _vdot(r, z, group)
    beta = torch.where(st.rz != 0, rz / st.rz, zero)
    p = z + beta * st.p
    rn = _vnorm(r, group)
    for dst, new in ((st.x, x), (st.r, r), (st.p, p), (st.rz, rz),
                     (st.rn, rn), (st.hist[s + 1], rn)):
        _put(dst, new, live)
    st.j += live.to(torch.int64)
    st.done |= live & (rn / safe_bnorm < tol)


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
       tol: float = 1e-8, maxiter: int = 200, M: Callable = _identity,
       group=None) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD operators, exiting early
    (one host read of `done` an iteration)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    safe_bnorm = _safe_bnorm(b, group)
    st = _cg_init(matvec, b, x0, tol, maxiter, M, safe_bnorm, group)
    j = 0
    while j < maxiter and not bool(st.done):
        _cg_step(st, matvec, M, j, tol, safe_bnorm, group)
        j += 1
    host = torch.cat([st.hist, (st.rn / safe_bnorm)[None],
                      st.done.to(b.dtype)[None]]).cpu().numpy()
    return KrylovResult(st.x, j, float(host[maxiter + 1]), host[:maxiter + 1],
                        bool(host[maxiter + 2]))


def cg_fixed(matvec: Callable, b: torch.Tensor,
             x0: torch.Tensor | None = None, tol: float = 1e-8,
             maxiter: int = 200, M: Callable = _identity) -> DeviceResult:
    """`cg` as a fixed budget of maxiter steps (`graphs.loop`): x and the
    on-device count of an early-exit run."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    safe_bnorm = _safe_bnorm(b)
    st = _cg_init(matvec, b, x0, tol, maxiter, M, safe_bnorm, None)
    graphs.loop(st.done, st.j, maxiter, lambda s: _cg_step(
        st, matvec, M, s, tol, safe_bnorm, None))
    return DeviceResult(st.x, st.j)


def jacobi(matvec: Callable, diag: torch.Tensor, b: torch.Tensor,
           iters: int = 200, x0: torch.Tensor | None = None) -> torch.Tensor:
    """Jacobi sweeps x <- x + D^-1 (b - A x)."""
    x = torch.zeros_like(b) if x0 is None else x0
    inv_d = 1.0 / diag
    for _ in range(iters):
        x = x + inv_d * (b - matvec(x))
    return x
