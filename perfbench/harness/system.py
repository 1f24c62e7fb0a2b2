"""The system under test, driven through the port's public calls: the
operator assembled from theta_n's planes, the preconditioner, its CUDA
graph and the Krylov solve (`mpbp_tpu_torch`). Nothing else of the
program is read but its results, its launch counts and the kernels whose
rooflines the per-layer metrics time.

A configuration file states the whole solve; no code here names one. Its
keys, besides `n` and the operator's scalars (PARAM_KEYS):

  precision     the path:
                hybrid  f64 operator and outer FGMRES (kernel K2), an LSC
                        preconditioner whose inner solves run in f32
                        (`make_preconditioner_mixed`);
                f32     everything in f32 (`make_preconditioner(dtype=
                        float32)`, the f32 outer matvec): the lower-precision
                        control of a configuration, never a cell of its own;
                ir      iterative refinement (`solvers.mixed.fgmres_ir`):
                        the residual in f64 (K2 in f64), each correction an
                        f32 FGMRES solve (K2 in f32) of the block-equilibrated
                        system (`block_scales`) with the f32 path's all-f32
                        preconditioner.
  pc, pc_inner_tol, pc_inner_iters
                the preconditioner's kind and its inner solves' tolerance
                and iterations.
  tol           the relative residual a solve stops at.
  maxiter       hybrid, f32: the outer FGMRES's iterations (ir: unread).
  restart       0: one unrestarted cycle; else the cycle's length (ir: of
                each inner f32 FGMRES).
  aug_k         optional, 0 if absent: LGMRES augmented restarts, the last
                aug_k directions of each cycle the previous cycles'
                normalised corrections; needs 0 < restart < maxiter, and
                hybrid or f32 (`fgmres` would run one plain cycle without
                it).
  ir_max_outer, ir_inner_tol, ir_inner_maxiter
                ir only, and then required: the refinement's outer steps,
                and each inner f32 solve's tolerance and iterations.
  limit_relres  the check's limit (`harness/check.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mpbp_tpu_torch import drivers
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers import graphs, mixed

PARAM_KEYS = ("c", "d", "xi", "eta_n", "eta_s", "d_p", "d_div")
PRECISIONS = ("hybrid", "f32", "ir")
IR_KEYS = ("ir_max_outer", "ir_inner_tol", "ir_inner_maxiter")


def params(config: dict) -> dict:
    """The operator's scalars of a configuration."""
    return {k: float(config[k]) for k in PARAM_KEYS}


def aug_k(config: dict) -> int:
    """The configuration's `aug_k` (0 if absent); ValueError where the
    solve would run without it."""
    k = int(config.get("aug_k", 0))
    if k == 0:
        return 0
    restart, maxiter = int(config["restart"]), int(config["maxiter"])
    if k < 0 or config["precision"] == "ir" or not 0 < restart < maxiter:
        raise ValueError(
            f"configuration {config['name']!r}: aug_k {k} needs a hybrid or "
            f"f32 solve with 0 < restart < maxiter (precision "
            f"{config['precision']!r}, restart {restart}, maxiter {maxiter})")
    return k


class SpannedApply(graphs.GraphedApply):
    """`GraphedApply` whose capture is the span setup.capture (traced runs
    only; the capture itself is the program's)."""

    def __init__(self, apply: Callable, spans):
        super().__init__(apply)
        self.spans = spans

    def _capture(self, v: torch.Tensor) -> None:
        with self.spans.span("setup.capture"):
            super()._capture(v)


@dataclasses.dataclass(eq=False)
class Solver:
    """One operator and everything a solve on it reuses. `mv` is the
    matvec of the answer's type (ir: the f64 residual's); `dtype` is the
    type of the Krylov basis and of M's input (ir: the inner solves' f32).
    ir alone has `mv32`, the inner solves' f32 matvec, and `scale`, the
    block equilibration."""

    op64: object
    op32: object
    M: Callable | None
    mv: Callable
    dtype: torch.dtype
    mv32: Callable | None = None
    scale: torch.Tensor | None = None


def build(config: dict, theta: dict, device: torch.device, spans) -> Solver:
    """Assemble the operators from theta_n's planes and build the
    preconditioner as the solves run it (a `GraphedApply` on a CUDA device,
    captured at its first apply). `spans` times the stages."""
    n, p = int(config["n"]), params(config)
    precision = config["precision"]
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    for key in IR_KEYS if precision == "ir" else ():
        if key not in config:
            raise KeyError(f"configuration {config['name']!r} states "
                           f"precision 'ir' without {key!r}")
    aug_k(config)
    inner = dict(inner_tol=float(config["pc_inner_tol"]),
                 inner_iters=int(config["pc_inner_iters"]))
    with spans.span("setup.assemble"):
        op32 = make_multiphase_operator(n, **p, dtype=torch.float32,
                                        device=device, theta_planes=theta)
        op64 = (make_multiphase_operator(n, **p, dtype=torch.float64,
                                         device=device, theta_planes=theta)
                if precision != "f32" else None)
    with spans.span("setup.pc"):
        if precision == "hybrid":
            M = drivers.make_preconditioner_mixed(op64, op32, config["pc"],
                                                  **inner)
        else:
            M = drivers.make_preconditioner(op32, config["pc"],
                                            dtype=torch.float32, **inner)
        graphed = drivers.graph_pc(M, config["pc"], device)
        if spans.on and type(graphed) is graphs.GraphedApply:
            graphed = SpannedApply(M, spans)
        M = graphed
    if precision == "hybrid":
        return Solver(op64, op32, M, drivers.a_matvec(op64), torch.float64)
    if precision == "ir":
        return Solver(op64, op32, M, drivers.a_matvec(op64), torch.float32,
                      mv32=drivers.a_matvec(op32),
                      scale=mixed.block_scales(op64))
    return Solver(None, op32, M, drivers.a_matvec(op32), torch.float32)


def solve(config: dict, solver: Solver, b: torch.Tensor,
          spans) -> krylov.KrylovResult:
    """One solve from x0 = 0 to the configuration's tolerance. For ir,
    `iters` counts the inner f32 iterations of every outer step."""
    with spans.span("solve.fgmres"):
        if config["precision"] == "ir":
            res = mixed.fgmres_ir(
                solver.mv, solver.mv32, b.to(torch.float64),
                tol=float(config["tol"]),
                max_outer=int(config["ir_max_outer"]),
                inner_tol=float(config["ir_inner_tol"]),
                inner_maxiter=int(config["ir_inner_maxiter"]), M32=solver.M,
                scale=solver.scale,
                inner_restart=int(config["restart"]) or None)
            return krylov.KrylovResult(
                x=res.x, iters=res.total_inner_iters, relres=res.relres,
                res_history=res.history, converged=res.converged)
        k = aug_k(config)
        return krylov.fgmres(solver.mv, b.to(solver.dtype),
                             tol=float(config["tol"]),
                             maxiter=int(config["maxiter"]), M=solver.M,
                             restart=int(config["restart"]) or None,
                             **({"aug_k": k} if k else {}))
