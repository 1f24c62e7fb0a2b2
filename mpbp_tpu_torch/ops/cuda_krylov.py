"""Kernel K13 (the fixed-budget GMRES cycle's own work): hand-written CUDA
for Hopper, with its plain PyTorch versions.

In the JAX package a fixed-budget inner GMRES is one `lax.while_loop`
(`mpbp_tpu/solvers/gmres.py` `_arnoldi_body`, :184) that XLA compiles with
the rest of the preconditioner. Eager PyTorch runs its step as ~80
launches: the CGS2 projection's cuBLAS gemv calls and elementwise passes
over w, then the Givens tail's one-element updates and 2s rotation
launches at step s. `solvers/gmres._fixed_cycle` (`gmres_fixed`, the
preconditioners' `KrylovInner`) runs it through these wrappers instead
(`csrc/krylov_step.cu`); the K1 matvec and the preconditioner's V-cycle
stay outside them:
  * `init`: ||b||, beta = ||r0||, V[0] = r0 / beta and the whole small
    state of a fresh cycle (2 launches a cycle; V comes from
    `torch.empty`: a row at or past j reaches neither the state nor x,
    and a masked step past done discards what it computes from one);
  * `step`: CGS2 in three passes over rows 0..s (V_i . w and ||w||^2;
    V_i . w' with w' formed in registers; w'' into row s+1 and
    ||w''||^2), the scalar tail in one block, and the scale of row s+1
    (5 launches a step);
  * `solution`: the j x j triangular solve and dx = sum_{i<j} y_i V_i
    over the rows that exist (1 launch a cycle).

The plain versions are the per-op code the cycle ran before, moved here:
`project_reference` is `gmres._orthogonalize`'s CGS2 without a process
group, `tail_reference` the Arnoldi step's tail (which the early-exit
loops' `_arnoldi_step` runs too), `init_reference` and
`solution_reference` `_arnoldi_init` and the device back-substitution
(the cycle's fields filled in place, V zeroed). The kernels' projection
sums in its own order, so h and the basis differ from the plain version's
at rounding level; the tail rounds each operation as the plain tail does
and gives its bits on the same h, ||w|| and ||w|| before the projection.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernels or raises, after checking dtype, shape, device and
contiguity. A cycle keeps the way its `init` took. Inside `plain()` every
wrapper runs its plain version on any device: the A/B of the per-op code
against the kernels, which the package never enters. `LAUNCHES` counts
kernel launches only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from mpbp_tpu_torch.ops import _build

LAUNCHES = _build.Launches(cycle_norms=0, cycle_start=0, cgs2_dots=0,
                           cgs2_reorth=0, cgs2_update=0, givens_tail=0,
                           basis_scale=0, cycle_solution=0)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the largest budget m (kMaxBudget in csrc/krylov_step.cu: the tail's and
# the solution's shared memory)
MAX_BUDGET = 1024
# a pass's threads a block and blocks an SM (kThreads, kBlocksAnSm)
_THREADS, _BLOCKS_AN_SM = 256, 2
_plain = False


@contextlib.contextmanager
def plain():
    """Run every wrapper of this module as its plain version inside the
    block, on any device (the per-op code, for an A/B against the
    kernels)."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def put(dst: torch.Tensor, new: torch.Tensor, live) -> None:
    """dst <- new where `live` (a () bool tensor), in place."""
    torch.where(live, new, dst, out=dst)


def over(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """w / d for a () tensor d, rounded as a division by the host scalar
    float(d) rounds (on CUDA PyTorch multiplies by its reciprocal, on the
    CPU it divides): the basis keeps the bits it had when the norm was
    read back to the host."""
    return w * torch.reciprocal(d) if w.is_cuda else w / d


@dataclasses.dataclass(eq=False)
class Cycle:
    """One fixed-budget GMRES cycle of m steps on flat vectors of n: the
    fields of `gmres.ArnoldiState` but Z, in the working dtype (j: int64,
    done/lost: bool), the safe ||b|| of the stop test, and the kernels'
    scratch (None where the cycle runs its plain version): `parts`
    (2m+2, blocks), the passes' per-block partial sums, and `scal`
    (m+4,), the step's h (s+1 values), ||w''|| at m, ||w|| before the
    projection at m+1, and row s+1's scale and its flag
    (`csrc/krylov_step.cu`)."""

    V: torch.Tensor       # (m+1, n) orthonormal basis
    H: torch.Tensor       # (m+1, m) rotated Hessenberg (R factor)
    cs: torch.Tensor      # (m,) Givens cosines
    sn: torch.Tensor      # (m,) Givens sines
    g: torch.Tensor       # (m+1,) rotated rhs
    hist: torch.Tensor    # (m+1,) residual estimates, NaN-padded
    j: torch.Tensor       # () iterations completed
    done: torch.Tensor    # () convergence/breakdown flag
    lost: torch.Tensor    # () done on a column that was dropped
    bnorm: torch.Tensor   # () ||b||, 1 where b is 0
    parts: torch.Tensor | None = None
    scal: torch.Tensor | None = None


def _cycle(n: int, m: int, dtype, device, blocks: int = 0) -> Cycle:
    """A cycle's tensors, unfilled; with the kernels' scratch for `blocks`
    blocks, if any."""
    e = functools.partial(torch.empty, dtype=dtype, device=device)
    flag = functools.partial(torch.empty, (), dtype=torch.bool,
                             device=device)
    return Cycle(e((m + 1, n)), e((m + 1, m)), e(m), e(m), e(m + 1),
                 e(m + 1), torch.empty((), dtype=torch.int64, device=device),
                 flag(), flag(), e(()),
                 e((2 * m + 2, blocks)) if blocks else None,
                 e(m + 4) if blocks else None)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def init_reference(cy: Cycle, b: torch.Tensor, r0: torch.Tensor,
                   tol: float) -> None:
    """Plain K13 start (`gmres._arnoldi_init` from the residual r0, and
    `gmres._safe_bnorm(b)`), into the fields of `cy`."""
    b_norm = torch.sqrt(torch.sum(b * b))
    cy.bnorm.copy_(torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm))
    beta = torch.sqrt(torch.sum(r0 * r0))
    cy.V.zero_()
    cy.V[0] = over(r0, torch.where(beta > 0, beta, torch.ones_like(beta)))
    for t in (cy.H, cy.cs, cy.sn, cy.g, cy.j, cy.lost):
        t.zero_()
    cy.g[0] = beta
    cy.hist.fill_(float("nan"))
    cy.hist[0] = beta
    cy.done.copy_(beta / cy.bnorm < tol)


def project_reference(V: torch.Tensor, w: torch.Tensor, s: int):
    """Plain K13 projection: CGS2 of w off rows 0..s of V (`gmres.
    _orthogonalize` without a group): (w'', h, ||w''||, ||w|| before)."""
    Vj = V[:s + 1]
    # [h1, ||w||^2] in one product, then h2, then the new norm
    hw = torch.cat([Vj @ w, torch.sum(w * w)[None]])
    h1 = hw[:-1]
    w = w - h1 @ Vj
    h2 = Vj @ w
    w = w - h2 @ Vj
    return w, h1 + h2, torch.sqrt(torch.sum(w * w)), torch.sqrt(hw[-1])


def tail_reference(st, w: torch.Tensor, h: torch.Tensor, wnorm, wnorm_pre,
                   s: int, tol: float, safe_bnorm) -> None:
    """Plain K13 tail: step s of a cycle after its projection onto rows
    0..s gave (w, h, ||w||, ||w|| before), on `st` (a `Cycle` or a
    `gmres.ArnoldiState`), in place. Every update is taken only where the
    state was not done, so a step after done changes nothing."""
    V, H = st.V, st.H
    m = H.shape[1]
    live = ~st.done
    zero, one = torch.zeros_like(wnorm), torch.ones_like(wnorm)
    # breakdown: A z landed inside the current basis's span, and the column
    # ends the cycle
    breakdown = wnorm <= 1e-12 * wnorm_pre
    col = torch.zeros(m + 1, dtype=V.dtype, device=V.device)
    col[:s + 1] = h
    col[s + 1] = torch.where(breakdown, zero, wnorm)
    # through the rotations 0..s-1: each (c a + s b, -s a + c b) as products
    # rounded one by one and summed, as the host's loop rounds them
    R = torch.stack((torch.stack((st.cs, st.sn), 1),
                     torch.stack((-st.sn, st.cs), 1)), 1)
    for i in range(s):
        p = R[i] * col[i:i + 2]
        # an add, not a sum: the CPU sums f32 in f64
        torch.add(p[:, 0], p[:, 1], out=col[i:i + 2])
    a, b = col[s], col[s + 1]
    rho = torch.sqrt(a * a + b * b)
    scale = (wnorm_pre if s == 0
             else torch.maximum(H[:s, :s].abs().amax(), wnorm_pre))
    eps = torch.finfo(V.dtype).eps
    # F1, a lost column: a breakdown whose rotated diagonal is rounding
    # noise. z_s repeats a direction of Z (a variable preconditioner, or an
    # augmentation along an earlier z), so H is singular: the estimate
    # would read 0 and the back-substitution divide by that noise. The
    # cycle ends at the last good column without claiming convergence (the
    # JAX package's FGMRES does claim it here). A breakdown with H
    # nonsingular, augmentation column or not, is an exact solve.
    lost = live & breakdown & (rho <= _lost_tol(V.dtype) * scale)
    keep = live & ~lost

    rho_safe = torch.where(rho == 0, one, rho)
    c = torch.where(rho == 0, one, a / rho_safe)
    sn = torch.where(rho == 0, zero, b / rho_safe)
    put(V[s + 1], over(w, torch.where(wnorm > 0, wnorm, one)),
        keep & ~breakdown)
    col[s] = c * a + sn * b
    col[s + 1].zero_()        # a Python 0 would be a host-to-device copy
    put(H[:, s], col, keep)
    put(st.cs[s], c, keep)
    put(st.sn[s], sn, keep)

    g = st.g
    g_next = -sn * g[s]
    put(g[s], c * g[s], keep)
    put(g[s + 1], g_next, keep)
    res = g_next.abs()
    put(st.hist[s + 1], res, keep)
    st.j += keep.to(torch.int64)
    met = (res / safe_bnorm < tol) | breakdown
    st.done |= lost | (keep & met)
    st.lost |= lost


def _lost_tol(dtype) -> float:
    """The lost-column test's factor: rho <= this * scale."""
    return max(1e-12, 100 * torch.finfo(dtype).eps)


def step_reference(cy: Cycle, w: torch.Tensor, s: int, tol: float) -> None:
    """Plain K13 step s: the projection, then the tail."""
    w, h, wnorm, wnorm_pre = project_reference(cy.V, w, s)
    tail_reference(cy, w, h, wnorm, wnorm_pre, s, tol, cy.bnorm)


def solution_reference(st) -> torch.Tensor:
    """Plain K13 solution: the upper triangular system of the first j
    columns solved over all m, those past j masked to the identity and
    their entries of y set to 0; returns y @ V[:m]."""
    j, H, g = st.j, st.H, st.g
    m = H.shape[1]
    valid = torch.arange(m, device=j.device) < j
    R = torch.where(valid[:, None] & valid[None, :], H[:m],
                    torch.eye(m, dtype=H.dtype, device=H.device))
    rhs = torch.where(valid, g[:m], torch.zeros_like(g[:m]))
    y = torch.linalg.solve_triangular(R, rhs[:, None], upper=True)[:, 0]
    y = torch.where(valid, y, torch.zeros_like(y))
    return y @ st.V[:m]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def init(b: torch.Tensor, r0: torch.Tensor, tol: float, m: int) -> Cycle:
    """K13: a cycle of m steps on b (flat) from the residual r0 (b itself
    where x0 is 0). Kernels on CUDA, plain on CPU."""
    _check_vector(b, "b")
    _check_like(r0, b, "r0")
    if not 1 <= m <= MAX_BUDGET:
        raise ValueError(f"the budget m must be 1..{MAX_BUDGET}, got {m}")
    n = b.numel()
    if _plain or b.device.type == "cpu":
        cy = _cycle(n, m, b.dtype, b.device)
        init_reference(cy, b, r0, tol)
        return cy
    _device(b)
    blocks = _blocks(n, b)
    cy = _cycle(n, m, b.dtype, b.device, blocks)
    _launch("cycle_norms", b, b.data_ptr(), r0.data_ptr(),
            cy.parts.data_ptr(), n, blocks)
    _launch("cycle_start", b, r0.data_ptr(), cy.parts.data_ptr(),
            *_ptrs(cy, "V", "H", "cs", "sn", "g", "hist", "j", "done",
                   "lost", "bnorm"),
            n, m, blocks, int(r0.data_ptr() == b.data_ptr()), tol)
    return cy


def step(cy: Cycle, w: torch.Tensor, s: int, tol: float) -> None:
    """K13: step s of the cycle after its matvec gave w (flat): CGS2 of w
    off rows 0..s, then the tail, in place."""
    n, m = cy.V.shape[1], cy.H.shape[1]
    _check_like(w, cy.V[0], "w")
    if not 0 <= s < m:
        raise ValueError(f"step {s} of a {m}-step cycle")
    if cy.parts is None:
        step_reference(cy, w, s, tol)
        return
    _device(w)
    blocks = cy.parts.shape[1]
    V, parts = cy.V.data_ptr(), cy.parts.data_ptr()
    for name in ("cgs2_dots", "cgs2_reorth", "cgs2_update"):
        _launch(name, w, V, w.data_ptr(), cy.done.data_ptr(), parts, n, s, m,
                blocks)
    _launch("givens_tail", w, parts,
            *_ptrs(cy, "H", "cs", "sn", "g", "hist", "j", "done", "lost",
                   "bnorm", "scal"),
            s, m, blocks, tol, _lost_tol(w.dtype))
    _launch("basis_scale", w, V, cy.scal.data_ptr(), n, s, m, blocks)


def solution(st) -> torch.Tensor:
    """K13: dx = sum_{i<j} y_i V_i (flat) with R y = g on the first j
    columns of `st` (a `Cycle`, or a `gmres.ArnoldiState` without Z).
    Kernel on CUDA, plain on CPU."""
    V = st.V
    if V.dtype not in _SUFFIX:
        raise TypeError(f"dtype {V.dtype} not supported (float32/float64)")
    if V.dim() != 2 or st.H.shape != (V.shape[0], V.shape[0] - 1):
        raise ValueError(f"V {tuple(V.shape)} is no basis of H "
                         f"{tuple(st.H.shape)}")
    if not (V.is_contiguous() and st.H.is_contiguous()):
        raise ValueError("V and H must be contiguous")
    if _plain or V.device.type == "cpu":
        return solution_reference(st)
    _device(V)
    n, m = V.shape[1], st.H.shape[1]
    blocks = _blocks(n, V)
    out = torch.empty(n, dtype=V.dtype, device=V.device)
    _launch("cycle_solution", V, V.data_ptr(), st.H.data_ptr(),
            st.g.data_ptr(), st.j.data_ptr(), out.data_ptr(), n, m, blocks)
    return out


def _check_vector(x, name: str) -> None:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32/float64)")
    if x.dim() != 1:
        raise ValueError(f"{name} must be flat, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_like(x, ref, name: str) -> None:
    """x is contiguous and has ref's shape, dtype and device."""
    if x.dtype != ref.dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {ref.dtype}")
    if x.shape != ref.shape:
        raise ValueError(f"{name} must be {tuple(ref.shape)}, got "
                         f"{tuple(x.shape)}")
    if x.device != ref.device:
        raise ValueError(f"{name} is on {x.device}, expected {ref.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"K13: no kernel for device {x.device}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(n: int, x: torch.Tensor) -> int:
    """A pass's grid: two blocks an SM, fewer where n is small."""
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    packs = -(-n // (16 // x.element_size()))
    return max(1, min(_BLOCKS_AN_SM * _sms(index), -(-packs // _THREADS)))


def _ptrs(cy: Cycle, *names) -> list[int]:
    return [getattr(cy, name).data_ptr() for name in names]


def _launch(name: str, x: torch.Tensor, *args) -> None:
    _build.launch("krylov_step", f"{name}_{_SUFFIX[x.dtype]}", x.device,
                  *args)
    LAUNCHES.add(name)
