"""High-level solve workflows returning structured reports (port of
`mpbp_tpu/drivers.py`, the slice behind
`solve_multiphase(pc="lsc_mg_full", precision="hybrid")`).

Everything is assembled in f64 (or the requested dtype) directly on the
requested device. The outer matvec is kernel K2 and the F matvecs of the
inner solves are kernel K1 (`ops/cuda_stencil.py`); on a CPU device both
run their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.fields import constant_thn
from mpbp_tpu_torch.models.fused import make_f_apply, make_fused_apply
from mpbp_tpu_torch.models.multiphase import (ALL_FIELDS, MultiphaseOperator,
                                              make_multiphase_operator)
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers import preconditioners as pcs
from mpbp_tpu_torch.solvers.multigrid import MGPressureSolver, MGVelocitySolver
from mpbp_tpu_torch.utils.norms import norms_report

# kinds and modes of the JAX package that this port does not have yet, with
# the ROADMAP.md item that brings each
_NOT_PORTED = {
    "lsc_ilut": "queue 1 item 10 (reference-parity ILU path)",
    "lsc_ilu0": "queue 1 item 10 (reference-parity ILU path)",
    "lsc_mg": "queue 1 item 10 (reference-parity ILU path)",
    "block_diag": "queue 1 item 10 (reference-parity ILU path)",
    "block_tri": "queue 1 item 10 (reference-parity ILU path)",
    "exact_schur": "queue 1 item 7 (exact-Schur and block preconditioners)",
    "lsc_mg_krylov": "queue 1 item 8 (remaining driver kinds)",
    "ir": "queue 1 item 8 (precision='ir', solvers/mixed.py)",
    "true_res_monitor": "queue 1 item 8 (true_res_monitor, with "
                        "fgmres_resumable)",
}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what!r} is not ported to mpbp_tpu_torch yet: ROADMAP.md "
        f"{_NOT_PORTED[what]}")


@dataclasses.dataclass
class SolveReport:
    """Residual history, error norms and status of one solve, as data.

    status: 'converged' | 'stagnated' | 'maxiter'."""

    n: int
    pc: str
    iters: int
    relres: float
    converged: bool
    res_history: np.ndarray
    error_norms: dict          # weighted L1/L2/max vs the MMS exact solution
    x: torch.Tensor
    params: dict
    status: str = "converged"


def classify_status(converged: bool, hist: np.ndarray,
                    window: int = 10, factor: float = 0.95) -> str:
    """Stagnation = the last `window` residuals improved by < (1-factor)."""
    if converged:
        return "converged"
    h = hist[~np.isnan(hist)]
    if len(h) > window and h[-1] > factor * h[-1 - window]:
        return "stagnated"
    return "maxiter"


def pack_fields(op: MultiphaseOperator, state: dict) -> torch.Tensor:
    return torch.cat([state[f].reshape(-1) for f in ALL_FIELDS])


def unpack_fields(op: MultiphaseOperator, v: torch.Tensor) -> dict:
    n = op.grid.n
    n2 = n * n
    return {f: v[i * n2:(i + 1) * n2].reshape(n, n)
            for i, f in enumerate(ALL_FIELDS)}


def a_matvec(op: MultiphaseOperator) -> Callable:
    """Flat matrix-free matvec for the coupled operator A, through kernel
    K2: coefficients are recomputed from the theta planes instead of
    streaming the assembled planes."""
    fmv = make_fused_apply(op)
    nf = len(ALL_FIELDS)
    n = op.grid.n

    def mv(v):
        return fmv(v.reshape(nf, n, n)).reshape(v.shape)

    return mv


def make_preconditioner(op: MultiphaseOperator, kind: str,
                        ilut_fill: int = 400, ilut_tau: float = 3e-5,
                        ilut_refine: int = 0,
                        inner_tol: float = 1e-4, inner_iters: int = 60,
                        dtype: torch.dtype = torch.float64
                        ) -> Callable | None:
    """Build a named preconditioner configuration.

    kinds:
      none        - unpreconditioned
      lsc_mg_full - LSC with multigrid inner solves: MG-preconditioned GMRES
                    on F, three pressure-MG cycles on GtG
      lsc_krylov  - LSC with matrix-free inner Krylov (CG on GtG, GMRES on F)
    The ilut_* settings belong to the ILU kinds, which are not ported yet
    (ROADMAP.md queue 1 item 10)."""
    if kind == "none":
        return None
    f_inner, p_inner = lsc_inners(op, kind, inner_tol=inner_tol,
                                  inner_iters=inner_iters, dtype=dtype)
    return pcs.make_lsc_pc(op, f_inner, p_inner)


def lsc_inners(op: MultiphaseOperator, kind: str, inner_tol: float = 1e-4,
               inner_iters: int = 60, dtype: torch.dtype = torch.float64):
    """The (F-block, pressure-block) inner solvers for a named LSC kind,
    shared by the single- and mixed-precision assemblies. The F matvec is
    the flux form through kernel K1 (f32-safe on F's near-kernel)."""
    if kind in _NOT_PORTED:
        raise _not_ported(kind)

    if kind == "lsc_krylov":
        # Jacobi(diag F)-preconditioned GMRES on F; the diagonal PC is what
        # makes it work at viscosity contrast 100
        fdiag = torch.cat([op.F.terms[(f, f)][(0, 0)].reshape(-1)
                           for f in op.F.out_fields])
        f_inner = pcs.KrylovInner(make_f_apply(op), tol=inner_tol,
                                  maxiter=inner_iters, method="gmres",
                                  M=lambda v: v / fdiag)
        GtG, _ = pcs.lsc_products(op)
        g_mv = krylov.flatten_op(
            GtG.apply, {"p": torch.zeros(op.grid.shape, dtype=dtype,
                                         device=op.grid.device)}, ("p",))
        p_inner = pcs.KrylovInner(g_mv, tol=inner_tol, maxiter=inner_iters,
                                  method="cg")
        return f_inner, p_inner

    if kind == "lsc_mg_full":
        # MG V-cycles precondition an inner GMRES on F, MG solves the
        # pressure block: mesh-independent outer counts and inner cost
        p_inner = MGPressureSolver.of(op, cycles=3)
        mg_vel = MGVelocitySolver.of(op, cycles=1)
        f_inner = pcs.KrylovInner(make_f_apply(op), tol=inner_tol,
                                  maxiter=max(inner_iters // 4, 8),
                                  method="gmres", M=mg_vel)
        return f_inner, p_inner

    raise ValueError(f"unknown preconditioner kind: {kind}")


def make_preconditioner_mixed(op64: MultiphaseOperator,
                              op32: MultiphaseOperator, kind: str,
                              inner_tol: float = 1e-4,
                              inner_iters: int = 40,
                              **ilu_kwargs) -> Callable:
    """Mixed-precision LSC preconditioner: f64 formula glue (from op64)
    around f32 inner solves (from op32). Only LSC kinds: the glue is the
    LSC formula. `ilu_kwargs` (ilut_*) belong to the unported ILU kinds."""
    if not kind.startswith("lsc_"):
        raise ValueError(
            f"make_preconditioner_mixed builds LSC glue; kind={kind!r} is "
            "not an lsc_* kind")
    f_inner32, p_inner32 = lsc_inners(op32, kind, inner_tol=inner_tol,
                                      inner_iters=inner_iters,
                                      dtype=torch.float32)
    return pcs.make_lsc_pc_mixed(op64, f_inner32, p_inner32)


@dataclasses.dataclass(eq=False)
class _SolveSetup:
    """Memoized per-configuration solve setup (see _solve_setup)."""

    op: MultiphaseOperator
    M: Callable | None          # PC for the precision mode (None = no PC)
    mv: Callable                # flat matvec at the outer dtype
    b_vec: torch.Tensor
    u_vec: torch.Tensor


_SETUP_CACHE: dict = {}
_SETUP_CACHE_MAX = 4


def _solve_setup(n, c, d, xi, eta_n, eta_s, problem, dtype, pc, precision,
                 device, pc_kwargs: dict) -> _SolveSetup:
    """Build (or reuse) everything a solve needs except the Krylov loop:
    operators, MG hierarchies and the MMS vectors, all on `device`. A
    repeated solve of the same configuration reuses them (a warm solve)."""
    device = torch.device(device)
    key = (n, c, d, xi, eta_n, eta_s, problem, dtype, pc, precision,
           str(device), tuple(sorted(pc_kwargs.items())))
    hit = _SETUP_CACHE.get(key)
    if hit is not None:
        return hit

    thn_fn_kwargs = {}
    if problem == "constant":
        thn_fn_kwargs["thn_fn"] = constant_thn(0.75)
        prob = mms.constant_thn_problem(c, d, xi, eta_n, eta_s)
    else:
        prob = mms.variable_thn_problem(c, d, xi, eta_n, eta_s)

    op = make_multiphase_operator(n, c=c, d=d, xi=xi, eta_n=eta_n,
                                  eta_s=eta_s, dtype=dtype, device=device,
                                  **thn_fn_kwargs)
    u_exact, b = mms.fill_sol_and_rhs(op.grid, prob)
    if precision == "full":
        M = make_preconditioner(op, pc, dtype=dtype, **pc_kwargs)
    else:
        op32 = make_multiphase_operator(n, c=c, d=d, xi=xi, eta_n=eta_n,
                                        eta_s=eta_s, dtype=torch.float32,
                                        device=device, **thn_fn_kwargs)
        M = make_preconditioner_mixed(op, op32, pc, **pc_kwargs)
    setup = _SolveSetup(op=op, M=M, mv=a_matvec(op),
                        b_vec=pack_fields(op, b),
                        u_vec=pack_fields(op, u_exact))
    if len(_SETUP_CACHE) >= _SETUP_CACHE_MAX:
        _SETUP_CACHE.pop(next(iter(_SETUP_CACHE)))
    _SETUP_CACHE[key] = setup
    return setup


def solve_multiphase(n: int = 16, c: float = 1.0, d: float = -1.0,
                     xi: float = 1.0, eta_n: float = 1.0, eta_s: float = 1.0,
                     pc: str = "lsc_ilut", tol: float = 1e-8,
                     maxiter: int = 150, problem: str = "variable",
                     dtype: torch.dtype = torch.float64,
                     true_res_monitor: bool = False,
                     precision: str = "full", restart: int | None = None,
                     *, device: torch.device | str,
                     **pc_kwargs) -> SolveReport:
    """End-to-end MMS solve on `device`.

    `precision`:
      'full'   - everything at `dtype`;
      'hybrid' - one f64 FGMRES whose LSC PC runs its inner solves in f32
                 with an f64 refinement pass each
                 (make_preconditioner_mixed);
      'ir'     - not ported yet (raises NotImplementedError).

    `restart` bounds the Krylov basis memory with restarted outer cycles.
    The true residual ||b - A x|| / ||b|| is verified once at the end, in
    params['true_relres']."""
    if precision not in ("full", "ir", "hybrid"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "ir":
        raise _not_ported("ir")
    if true_res_monitor:
        raise _not_ported("true_res_monitor")
    if precision == "hybrid":
        dtype = torch.float64           # the certified outer dtype

    setup = _solve_setup(n, c, d, xi, eta_n, eta_s, problem, dtype, pc,
                         precision, device, pc_kwargs)
    op, b_vec = setup.op, setup.b_vec
    result = krylov.fgmres(setup.mv, b_vec, tol=tol, maxiter=maxiter,
                           M=setup.M, restart=restart)

    err = norms_report(result.x, setup.u_vec, op.grid.dx, op.grid.dy)
    hist = result.res_history[~np.isnan(result.res_history)]
    _, rn = krylov.residual_norm(setup.mv, b_vec, result.x)
    true_res = float(rn / torch.linalg.norm(b_vec))
    return SolveReport(
        n=n, pc=pc, iters=result.iters, relres=result.relres,
        converged=result.converged, res_history=hist,
        error_norms=err, x=result.x,
        params=dict(c=c, d=d, xi=xi, eta_n=eta_n, eta_s=eta_s, tol=tol,
                    maxiter=maxiter, problem=problem, true_relres=true_res,
                    precision=precision, device=str(device)),
        status=classify_status(result.converged, hist),
    )


def apply_report(n: int = 32, c: float = 1.0, d: float = -1.0,
                 xi: float = 1.0, eta_n: float = 1.0, eta_s: float = 1.0,
                 problem: str = "variable",
                 dtype: torch.dtype = torch.float64, *,
                 device: torch.device | str) -> dict:
    """Apply the assembled A to the exact MMS solution and report the error
    norms against the exact RHS."""
    kwargs = {}
    if problem == "constant":
        kwargs["thn_fn"] = constant_thn(0.75)
        prob = mms.constant_thn_problem(c, d, xi, eta_n, eta_s)
    else:
        prob = mms.variable_thn_problem(c, d, xi, eta_n, eta_s)
    op = make_multiphase_operator(n, c=c, d=d, xi=xi, eta_n=eta_n,
                                  eta_s=eta_s, dtype=dtype, device=device,
                                  **kwargs)
    u, b = mms.fill_sol_and_rhs(op.grid, prob)
    return norms_report(op.A.apply(u), b, op.grid.dx, op.grid.dy)
