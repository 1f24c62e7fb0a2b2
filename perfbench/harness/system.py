"""The system under test, driven through the port's public calls: the
operator assembled from theta_n's planes, the preconditioner, its CUDA
graph and the outer FGMRES (`mpbp_tpu_torch`). Nothing else of the
program is read but its results, its launch counts and the kernels whose
rooflines the per-layer metrics time.

A configuration's `precision` picks the path:
  hybrid  f64 operator and outer FGMRES (kernel K2), an LSC preconditioner
          whose inner solves run in f32 (`make_preconditioner_mixed`);
  f32     everything in f32 (`make_preconditioner(dtype=float32)`, the f32
          outer matvec): the lower-precision control of a hybrid
          configuration, never a cell of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mpbp_tpu_torch import drivers
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers import graphs

PARAM_KEYS = ("c", "d", "xi", "eta_n", "eta_s", "d_p", "d_div")


def params(config: dict) -> dict:
    """The operator's scalars of a configuration."""
    return {k: float(config[k]) for k in PARAM_KEYS}


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
    """One operator and everything a solve on it reuses."""

    op64: object
    op32: object
    M: Callable | None
    mv: Callable
    dtype: torch.dtype


def build(config: dict, theta: dict, device: torch.device, spans) -> Solver:
    """Assemble the operators from theta_n's planes and build the
    preconditioner as the solves run it (a `GraphedApply` on a CUDA device,
    captured at its first apply). `spans` times the stages."""
    n, p = int(config["n"]), params(config)
    precision = config["precision"]
    if precision not in ("hybrid", "f32"):
        raise ValueError(f"unknown precision {precision!r}")
    inner = dict(inner_tol=float(config["pc_inner_tol"]),
                 inner_iters=int(config["pc_inner_iters"]))
    with spans.span("setup.assemble"):
        op32 = make_multiphase_operator(n, **p, dtype=torch.float32,
                                        device=device, theta_planes=theta)
        op64 = (make_multiphase_operator(n, **p, dtype=torch.float64,
                                         device=device, theta_planes=theta)
                if precision == "hybrid" else None)
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
    return Solver(None, op32, M, drivers.a_matvec(op32), torch.float32)


def solve(config: dict, solver: Solver, b: torch.Tensor,
          spans) -> krylov.KrylovResult:
    """One solve from x0 = 0 to the configuration's tolerance."""
    with spans.span("solve.fgmres"):
        return krylov.fgmres(solver.mv, b.to(solver.dtype),
                             tol=float(config["tol"]),
                             maxiter=int(config["maxiter"]), M=solver.M,
                             restart=int(config["restart"]) or None)
