"""High-level solve workflows returning structured reports (port of
`mpbp_tpu/drivers.py`: every preconditioner kind, precision
full/hybrid/ir, the per-iteration true-residual monitor, the spectrum
report and the row-sharded solve over `torch.distributed`).

Everything is assembled in f64 (or the requested dtype) directly on the
requested device. The outer matvec is kernel K2 and the F matvecs of the
matrix-free inner solves are kernel K1 (`ops/cuda_stencil.py`); the ILU
kinds factor on the host (`mpbp_tpu_torch.native`) and apply their triangular
solves on the device, each Neumann sweep one launch of kernel K7
(`ops/cuda_ell.py`). On a CPU device every kernel runs its plain PyTorch
version.

On a CUDA device the preconditioner a solve setup builds is captured once
as a CUDA graph and replayed on every outer iteration (`graph_pc`,
`solvers/graphs.py`: the port's counterpart of the JAX package's jitted
cycle, its inner Krylov loops exiting on the device through IF nodes);
`graphs.disabled()` runs it eagerly. The sharded driver runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.fields import constant_thn
from mpbp_tpu_torch.models.fused import make_f_apply, make_fused_apply
from mpbp_tpu_torch.models.multiphase import (ALL_FIELDS, MultiphaseOperator,
                                              make_multiphase_operator)
from mpbp_tpu_torch.solvers import eigen
from mpbp_tpu_torch.solvers import graphs
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers import preconditioners as pcs
from mpbp_tpu_torch.solvers.mixed import block_scales, fgmres_ir
from mpbp_tpu_torch.solvers.multigrid import MGPressureSolver, MGVelocitySolver
from mpbp_tpu_torch.utils import metrics
from mpbp_tpu_torch.utils.norms import norms_report

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


def a_matvec(op: MultiphaseOperator, fused: bool = True) -> Callable:
    """Flat matrix-free matvec for the coupled operator A.

    `fused=True` goes through kernel K2: coefficients are recomputed from
    the theta planes instead of streaming the assembled planes.
    `fused=False` is the plain `StencilOperator.apply` of the assembled
    planes (no kernel), e.g. for operators modified after assembly."""
    if not fused:
        def mv(v):
            return pack_fields(op, op.A.apply(unpack_fields(op, v)))

        return mv

    fmv = make_fused_apply(op)
    nf = len(ALL_FIELDS)
    n = op.grid.n

    def mv(v):
        return fmv(v.reshape(nf, n, n)).reshape(v.shape)

    return mv


@metrics.spanned("pc.build")
def make_preconditioner(op: MultiphaseOperator, kind: str,
                        ilut_fill: int = 400, ilut_tau: float = 3e-5,
                        ilut_refine: int = 0,
                        inner_tol: float = 1e-4, inner_iters: int = 60,
                        dtype: torch.dtype = torch.float64,
                        ilut_apply: str = "level", ilut_sweeps: int = 24
                        ) -> Callable | None:
    """Build a named preconditioner configuration.

    kinds:
      none        - unpreconditioned
      exact_schur - dense exact Schur complement (small grids only)
      lsc_ilut    - LSC with ILUT(fill, tau) inner solves: the reference-
                    parity configuration
      lsc_ilu0    - LSC with ILU(0) inner solves
      lsc_mg      - LSC with an ILUT F inner and a pressure-MG inner
      lsc_mg_full - LSC with multigrid inner solves: MG-preconditioned GMRES
                    on F, three pressure-MG cycles on GtG
      lsc_krylov  - LSC with matrix-free inner Krylov (CG on GtG, GMRES on F)
      lsc_mg_krylov - LSC with three pressure-MG cycles and the Jacobi-
                    preconditioned GMRES on F of lsc_krylov
      block_diag  - block-diagonal F/Schur PC (ILUT inners)
      block_tri   - block lower-triangular PC (ILUT inners)"""
    if kind == "none":
        return None
    if kind == "exact_schur":
        return pcs.make_exact_schur_pc(op)
    f_inner, p_inner = lsc_inners(op, kind, ilut_fill=ilut_fill,
                                  ilut_tau=ilut_tau, ilut_refine=ilut_refine,
                                  inner_tol=inner_tol,
                                  inner_iters=inner_iters, dtype=dtype,
                                  ilut_apply=ilut_apply,
                                  ilut_sweeps=ilut_sweeps)
    if kind == "block_diag":
        return pcs.make_block_diagonal_pc(op, f_inner, p_inner)
    if kind == "block_tri":
        return pcs.make_block_triangular_pc(op, f_inner, p_inner)
    return pcs.make_lsc_pc(op, f_inner, p_inner)


def lsc_inners(op: MultiphaseOperator, kind: str,
               ilut_fill: int = 400, ilut_tau: float = 3e-5,
               ilut_refine: int = 0, inner_tol: float = 1e-4,
               inner_iters: int = 60, dtype: torch.dtype = torch.float64,
               ilut_apply: str = "level", ilut_sweeps: int = 24):
    """The (F-block, pressure-block) inner solvers for a named kind, shared
    by the single- and mixed-precision assemblies. The matrix-free F matvec
    is the flux form through kernel K1 (f32-safe on F's near-kernel).

    ilut_apply: 'level' (exact level-scheduled triangular solves) or
    'neumann' (`ilut_sweeps` Jacobi sweeps per triangle, each one launch of
    kernel K7, at the cost of extra outer iterations)."""
    if kind in ("lsc_ilut", "lsc_ilu0", "block_diag", "block_tri"):
        GtG, _ = pcs.lsc_products(op)
        tri = dict(dtype=dtype, apply=ilut_apply, sweeps=ilut_sweeps)
        if kind == "lsc_ilu0":
            f_inner = pcs.ILUInner.ilu0_of(op.F, refine=ilut_refine, **tri)
            p_inner = pcs.ILUInner.ilu0_of(GtG, **tri)
        else:
            # F is the hard block (phase coupling, viscosity contrast):
            # deeper fill there buys outer iterations. GtG is Poisson-like
            # and keeps the reference's ILUT(100, 1e-3).
            f_inner = pcs.ILUInner.ilut_of(op.F, fill=ilut_fill, tau=ilut_tau,
                                           refine=ilut_refine, **tri)
            p_inner = pcs.ILUInner.ilut_of(GtG, fill=100, tau=1e-3, **tri)
        return f_inner, p_inner

    if kind == "lsc_krylov":
        f_inner = _f_krylov_inner(op, inner_tol, inner_iters)
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

    if kind in ("lsc_mg", "lsc_mg_krylov"):
        # pressure multigrid; lsc_mg with an ILUT F inner (level-scheduled,
        # as in the JAX package, whatever ilut_apply says), lsc_mg_krylov
        # with lsc_krylov's matrix-free F inner
        p_inner = MGPressureSolver.of(op, cycles=3)
        if kind == "lsc_mg":
            f_inner = pcs.ILUInner.ilut_of(op.F, fill=ilut_fill,
                                           tau=ilut_tau, dtype=dtype,
                                           refine=ilut_refine)
        else:
            f_inner = _f_krylov_inner(op, inner_tol, inner_iters)
        return f_inner, p_inner

    raise ValueError(f"unknown preconditioner kind: {kind}")


def _f_krylov_inner(op: MultiphaseOperator, inner_tol: float,
                    inner_iters: int) -> pcs.KrylovInner:
    """Matrix-free F inner solve: GMRES on F through kernel K1,
    preconditioned by Jacobi on diag F, which is what makes it work at
    viscosity contrast 100."""
    fdiag = torch.cat([op.F.terms[(f, f)][(0, 0)].reshape(-1)
                       for f in op.F.out_fields])
    return pcs.KrylovInner(make_f_apply(op), tol=inner_tol,
                           maxiter=inner_iters, method="gmres",
                           M=lambda v: v / fdiag)


@metrics.spanned("pc.build")
def make_preconditioner_mixed(op64: MultiphaseOperator,
                              op32: MultiphaseOperator, kind: str,
                              inner_tol: float = 1e-4,
                              inner_iters: int = 40,
                              **kwargs) -> Callable:
    """Mixed-precision LSC preconditioner: f64 formula glue (from op64)
    around f32 inner solves (from op32). Only LSC kinds: the glue is the
    LSC formula. `kwargs` (ilut_*) go to `lsc_inners`."""
    if not kind.startswith("lsc_"):
        raise ValueError(
            f"make_preconditioner_mixed builds LSC glue; kind={kind!r} is "
            "not an lsc_* kind")
    f_inner32, p_inner32 = lsc_inners(op32, kind, inner_tol=inner_tol,
                                      inner_iters=inner_iters,
                                      dtype=torch.float32, **kwargs)
    return pcs.make_lsc_pc_mixed(op64, f_inner32, p_inner32)


# kinds whose apply reads the host, which a CUDA graph cannot capture: the
# exact-Schur PC's inner GMRES exits early on its own stop test
EAGER_KINDS = ("exact_schur",)


def graph_pc(M: Callable | None, kind: str, device) -> Callable | None:
    """The preconditioner of kind `kind` as the solves run it: on a CUDA
    device a `graphs.GraphedApply`, unless its kind reads the host
    (EAGER_KINDS); unchanged on the CPU (None stays None)."""
    if M is None or kind in EAGER_KINDS or torch.device(device).type != "cuda":
        return M
    return graphs.GraphedApply(M)


@dataclasses.dataclass(eq=False)
class _SolveSetup:
    """Memoized per-configuration solve setup (see _solve_setup)."""

    op: MultiphaseOperator
    M: Callable | None          # PC for the precision mode (None = no PC)
    mv: Callable                # flat matvec at the outer dtype
    b_vec: torch.Tensor
    u_vec: torch.Tensor
    mv32: Callable | None = None        # f32 matvec, K2 (ir mode)
    scale: torch.Tensor | None = None   # block equilibration (ir mode)


_SETUP_CACHE: dict = {}
_SETUP_CACHE_MAX = 4


def _solve_setup(n, c, d, xi, eta_n, eta_s, problem, dtype, pc, precision,
                 device, pc_kwargs: dict) -> _SolveSetup:
    """Build (or reuse) everything a solve needs except the Krylov loop:
    operators, MG hierarchies and the MMS vectors, all on `device`, and
    the PC as `graph_pc` wraps it. A repeated solve of the same
    configuration reuses them (a warm solve), its PC's graph included."""
    device = torch.device(device)
    try:
        key = (n, c, d, xi, eta_n, eta_s, problem, dtype, pc, precision,
               str(device), tuple(sorted(pc_kwargs.items())))
        hit = _SETUP_CACHE.get(key)
    except TypeError:             # unhashable pc_kwargs value: no memo
        key, hit = None, None
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
    mv32, scale = None, None
    if precision == "full":
        M = make_preconditioner(op, pc, dtype=dtype, **pc_kwargs)
    else:
        op32 = make_multiphase_operator(n, c=c, d=d, xi=xi, eta_n=eta_n,
                                        eta_s=eta_s, dtype=torch.float32,
                                        device=device, **thn_fn_kwargs)
        if precision == "hybrid":
            M = make_preconditioner_mixed(op, op32, pc, **pc_kwargs)
        else:
            M = make_preconditioner(op32, pc, dtype=torch.float32,
                                    **pc_kwargs)
            mv32 = a_matvec(op32)
            scale = block_scales(op)
    setup = _SolveSetup(op=op, M=graph_pc(M, pc, device), mv=a_matvec(op),
                        b_vec=pack_fields(op, b),
                        u_vec=pack_fields(op, u_exact), mv32=mv32,
                        scale=scale)
    if key is not None:
        if len(_SETUP_CACHE) >= _SETUP_CACHE_MAX:
            _SETUP_CACHE.pop(next(iter(_SETUP_CACHE)))
        _SETUP_CACHE[key] = setup
    return setup


def _mixed_precision_solve(setup: _SolveSetup, tol: float, maxiter: int,
                           precision: str,
                           restart: int | None = None) -> krylov.KrylovResult:
    """The 'ir'/'hybrid' solve bodies behind solve_multiphase(precision=...),
    returning a KrylovResult; for 'ir', `iters` counts the inner f32
    iterations of all outer steps and the history holds the f64 relres
    after each outer step (see `bench_solve` for the card's runs)."""
    if precision == "hybrid":
        return krylov.fgmres(setup.mv, setup.b_vec, tol=tol, maxiter=maxiter,
                             M=setup.M, restart=restart)
    res = fgmres_ir(setup.mv, setup.mv32, setup.b_vec, tol=tol,
                    max_outer=max(maxiter // 25, 4), inner_tol=1e-6,
                    inner_maxiter=min(maxiter, 150), M32=setup.M,
                    scale=setup.scale, inner_restart=restart)
    return krylov.KrylovResult(
        x=res.x, iters=res.total_inner_iters, relres=res.relres,
        res_history=np.concatenate([res.history, [np.nan]]),
        converged=res.converged)


def _monitored_solve(setup: _SolveSetup, tol: float, maxiter: int):
    """FGMRES stepped one iteration at a time (`fgmres_resumable`), with
    the TRUE relative residual ||b - A x_k|| / ||b|| after every
    iteration. Returns (KrylovResult, per-iteration true residuals)."""
    b_vec = setup.b_vec
    bnorm = float(torch.linalg.norm(b_vec))
    state, result, true_hist = None, None, []
    for _ in range(maxiter):
        result, state = krylov.fgmres_resumable(
            setup.mv, b_vec, tol=tol, maxiter=maxiter, M=setup.M,
            state=state, max_steps=1)
        _, rn = krylov.residual_norm(setup.mv, b_vec, result.x)
        true_hist.append(float(rn) / bnorm)
        if result.converged or result.iters >= maxiter:
            break
    return result, true_hist


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
      'ir'     - f32 inner FGMRES cycles (f32 matvec K2, f32 PC) with f64
                 residual refinement (solvers/mixed.fgmres_ir with block
                 equilibration); `iters` counts the inner iterations.

    `restart` bounds the Krylov basis memory: restarted outer cycles for
    'full'/'hybrid', the inner f32 cycle length for 'ir'.

    `true_res_monitor=True` (precision 'full') steps fgmres_resumable one
    iteration at a time and recomputes the TRUE residual after each, into
    params['true_res_history'] (one extra matvec per iteration). It runs
    one unrestarted cycle: with `restart` it raises ValueError (the JAX
    package ignores `restart` there). Otherwise the true residual
    ||b - A x|| / ||b|| is verified once at the end, in
    params['true_relres']."""
    if precision not in ("full", "ir", "hybrid"):
        raise ValueError(f"unknown precision {precision!r}")
    if true_res_monitor and restart is not None:
        raise ValueError("true_res_monitor runs one unrestarted FGMRES "
                         "cycle; it takes no restart")
    if precision != "full":
        dtype = torch.float64           # the certified outer dtype

    setup = _solve_setup(n, c, d, xi, eta_n, eta_s, problem, dtype, pc,
                         precision, device, pc_kwargs)
    op, b_vec = setup.op, setup.b_vec
    true_hist = None
    if precision != "full":
        result = _mixed_precision_solve(setup, tol, maxiter, precision,
                                        restart)
    elif true_res_monitor:
        result, true_hist = _monitored_solve(setup, tol, maxiter)
    else:
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
                    precision=precision, device=str(device),
                    **({"true_res_history": true_hist}
                       if true_hist is not None else {})),
        status=classify_status(result.converged, hist),
    )


@dataclasses.dataclass(eq=False)
class _ShardedSetup:
    """What a sharded solve needs besides its Krylov loop (see
    `_sharded_setup`)."""

    op: MultiphaseOperator
    M: Callable
    mesh: object
    b: dict                      # the MMS rhs fields, whole on every rank
    u_exact: dict


def _sharded_setup(n, c, d, xi, eta_n, eta_s, pc, precision, inner_tol,
                   inner_iters, n_devices, problem, device,
                   axis: str | tuple[str, ...] = "x") -> _ShardedSetup:
    """Open (or join) the process group for `device`, build the mesh, the
    operators (whole on every rank) and the sharded PC."""
    from mpbp_tpu_torch.parallel import sharding as sh
    from mpbp_tpu_torch.parallel.distributed import init_distributed

    if pc not in ("mg", "cg", "block_ilu0"):
        raise ValueError(f"unknown sharded pc {pc!r} (mg | cg | block_ilu0)")
    if precision not in ("f64", "hybrid"):
        raise ValueError(f"unknown sharded precision {precision!r} "
                         "(f64 | hybrid)")
    if precision == "hybrid" and pc == "block_ilu0":
        raise ValueError(
            "precision='hybrid' builds the MG mixed PC; it has no "
            "block_ilu0 variant: use precision='f64' with pc='block_ilu0' "
            "or precision='hybrid' with pc='mg'")
    dev = torch.device(device)
    init_distributed(local_device_ids=None if dev.index is None
                     else [dev.index], device=dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = sh.make_mesh(n_devices, axis)

    thn_fn_kwargs = {}
    if problem == "constant":
        thn_fn_kwargs["thn_fn"] = constant_thn(0.75)
        prob = mms.constant_thn_problem(c, d, xi, eta_n, eta_s)
    else:
        prob = mms.variable_thn_problem(c, d, xi, eta_n, eta_s)
    kw = dict(c=c, d=d, xi=xi, eta_n=eta_n, eta_s=eta_s, device=dev,
              **thn_fn_kwargs)
    op = make_multiphase_operator(n, dtype=torch.float64, **kw)
    u_exact, b = mms.fill_sol_and_rhs(op.grid, prob)
    pc_kw = dict(inner_tol=inner_tol, inner_iters=inner_iters)
    if precision == "hybrid":
        op32 = make_multiphase_operator(n, dtype=torch.float32, **kw)
        M = sh.make_sharded_lsc_pc_mixed(op, op32, mesh=mesh, axis=axis,
                                         **pc_kw)
    elif pc == "block_ilu0":
        M = sh.make_sharded_lsc_pc_ilu(op, mesh, axis, **pc_kw)
    else:
        M = sh.make_sharded_lsc_pc(op, p_solver=pc, mesh=mesh, axis=axis,
                                   **pc_kw)
    return _ShardedSetup(op, M, mesh, b, u_exact)


def solve_multiphase_sharded(n: int = 256, c: float = 1.0, d: float = -1.0,
                             xi: float = 1.0, eta_n: float = 1.0,
                             eta_s: float = 1.0, pc: str = "mg",
                             tol: float = 1e-8, maxiter: int = 100,
                             precision: str = "f64",
                             restart: int | None = None, aug_k: int = 0,
                             inner_tol: float = 1e-4, inner_iters: int = 40,
                             n_devices: int | None = None,
                             problem: str = "variable", *,
                             device: torch.device | str,
                             axis: str | tuple[str, ...] = "x") -> SolveReport:
    """End-to-end MMS solve on the row-sharded mesh: the library entry
    point behind `python -m mpbp_tpu_torch solve --sharded`.

    Every rank of the process group calls it alike (SPMD): it joins or
    opens the group for `device` (`parallel.distributed.init_distributed`:
    NCCL on "cuda", where each rank runs on its own device, gloo on
    "cpu"), solves on its band of rows, and returns the same report on
    every rank, with x gathered whole.

    pc: 'mg' | 'cg' (`make_sharded_lsc_pc`'s pressure inner solve) or
        'block_ilu0' (block-Jacobi ILU(0) inners, `make_sharded_lsc_pc_ilu`);
    precision: 'f64' or 'hybrid' (f64 outer FGMRES and LSC glue around f32
        inner MG solves, `make_sharded_lsc_pc_mixed`; its pc is 'mg');
    n_devices: None or the number of ranks, which is the mesh's size (one
        device a rank; the JAX package takes the first n devices of one
        process);
    restart, aug_k: restarted outer cycles (bounding the basis memory) and
        LGMRES augmentation.
    params['true_relres'] is ||b - A x|| / ||b|| recomputed at the end.
    Convergence is certified by it: where FGMRES's estimate met tol but
    the recomputed residual did not, the solve goes on from x (within
    maxiter), so `converged` means true relres <= tol. (The JAX package
    reports its estimate alone.)"""
    from mpbp_tpu_torch.parallel import sharding as sh
    from mpbp_tpu_torch.parallel.halo import Ring
    from mpbp_tpu_torch.parallel.pallas_sharded import (
        make_fused_apply_pallas_sharded)

    setup = _sharded_setup(n, c, d, xi, eta_n, eta_s, pc, precision,
                           inner_tol, inner_iters, n_devices, problem,
                           device, axis)
    op, mesh = setup.op, setup.mesh
    ring = Ring.of(mesh, axis)
    b = ring.band(sh.stack_state(setup.b))
    mv = make_fused_apply_pallas_sharded(op, mesh, axis)
    bnorm = float(krylov._vnorm(b, ring.group))

    def true_relres(x):
        _, rn = krylov.residual_norm(mv, b, ring.band(x), ring.group)
        return float(rn) / bnorm

    res = sh.sharded_solve(op, setup.b, mesh, tol=tol, maxiter=maxiter,
                           pc=setup.M, axis=axis, restart=restart,
                           aug_k=aug_k)
    iters, hists = res.iters, [res.res_history[:res.iters + 1]]
    true_res = true_relres(res.x)
    # FGMRES stops on its residual estimate; the recomputed residual can
    # land a little above it (rounding in A Z y against V H y). Go on from
    # x until the recomputed residual meets tol as well
    while res.converged and true_res > tol and iters < maxiter:
        res = sh.sharded_solve(op, setup.b, mesh, tol=tol,
                               maxiter=maxiter - iters, pc=setup.M,
                               axis=axis, x0=res.x, restart=restart,
                               aug_k=aug_k)
        iters += res.iters
        hists.append(res.res_history[1:res.iters + 1])
        true_res = true_relres(res.x)
    converged = res.converged and true_res <= tol
    err = norms_report(res.x.reshape(-1),
                       sh.stack_state(setup.u_exact).reshape(-1),
                       op.grid.dx, op.grid.dy)
    hist = np.concatenate(hists)
    return SolveReport(
        n=n, pc=f"sharded_{pc}_{precision}", iters=iters,
        relres=res.relres, converged=converged, res_history=hist,
        error_norms=err, x=res.x,
        params=dict(c=c, d=d, xi=xi, eta_n=eta_n, eta_s=eta_s, tol=tol,
                    maxiter=maxiter, problem=problem, true_relres=true_res,
                    precision=precision, device=str(op.grid.device),
                    devices=ring.size,
                    **({"restart": restart} if restart else {})),
        status=classify_status(converged, hist),
    )


def spectrum_report(n: int = 16, c: float = 1.0, d: float = -1.0,
                    xi: float = 1.0, eta_n: float = 1.0, eta_s: float = 1.0,
                    pcs: Sequence[str] = ("exact_schur", "lsc_ilut"),
                    k: int = 10, tol: float = 1e-4, maxiter: int = 40,
                    exact: bool | None = None, *,
                    device: torch.device | str, **pc_kwargs) -> dict:
    """Plot-ready eigenvalue study of A against A*M^-1 for each named
    preconditioner, as a JSON-serializable dict: each spectrum as (re, im)
    lists with its residuals, converged and nullspace counts and the
    clustering radius around 1.

    `exact=True` takes the full dense spectrum (small n only: the matvec
    is applied to the identity's columns one at a time and the eigenvalues
    come from `np.linalg.eigvals` on the host); `exact=False` runs the
    matrix-free Arnoldi `eigen.eigs`; the default is exact when n <= 12.
    The matvecs run eagerly on `device`."""
    op = make_multiphase_operator(n, c=c, d=d, xi=xi, eta_n=eta_n,
                                  eta_s=eta_s, dtype=torch.float64,
                                  device=device)
    mv = a_matvec(op)
    N = 5 * n * n
    ex = torch.ones(N, dtype=torch.float64, device=op.grid.device)
    use_exact = (n <= 12) if exact is None else exact

    def _spectrum(matvec) -> dict:
        if use_exact:
            cols = torch.stack([matvec(e) for e in torch.eye(
                N, dtype=torch.float64, device=op.grid.device)], dim=1)
            ev = np.linalg.eigvals(cols.cpu().numpy())
            ev = ev[np.argsort(-np.abs(ev))]
            resid = np.zeros(len(ev))
            nconv = len(ev)
        else:
            res = eigen.eigs(matvec, ex, k=k, tol=tol, maxiter=maxiter)
            ev, resid, nconv = res.eigenvalues, res.residuals, res.n_converged
        evc = ev[:nconv]
        # the periodic problem's constant-pressure nullspace is an exact 0
        # eigenvalue of A*M^-1: counted apart so that it does not mask the
        # clustering
        nontrivial = evc[np.abs(evc) > 1e-8]
        out = {
            "eigenvalues_re": np.real(ev).tolist(),
            "eigenvalues_im": np.imag(ev).tolist(),
            "residuals": np.asarray(resid).tolist(),
            "n_converged": int(nconv),
            "n_nullspace": int(np.sum(np.abs(evc) <= 1e-8)),
            # for LSC preconditioners this is the outlier envelope: the
            # bulk of spec(A*M^-1) sits at 1 with a few large outliers
            "clustering_radius_1": (
                float(np.max(np.abs(nontrivial - 1.0)))
                if len(nontrivial) else float("inf")),
        }
        if use_exact and len(nontrivial):
            dev = np.abs(nontrivial - 1.0)
            out["frac_within_0p1_of_1"] = float(np.mean(dev < 0.1))
            out["frac_within_0p5_of_1"] = float(np.mean(dev < 0.5))
        return out

    report = {
        "n": n,
        "params": dict(c=c, d=d, xi=xi, eta_n=eta_n, eta_s=eta_s),
        "method": "dense" if use_exact else "arnoldi",
        "A": _spectrum(mv),
        "preconditioned": {},
    }
    for kind in pcs:
        M = make_preconditioner(op, kind, **pc_kwargs)
        if M is None:
            continue
        report["preconditioned"][kind] = _spectrum(lambda v: mv(M(v)))
    return report


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
