"""Mixed-precision iterative refinement around the f32 Krylov solver (port
of `mpbp_tpu/solvers/mixed.py`).

The reference needs 1e-8 relative residuals, beyond single precision's
reach in one solve. Iterative refinement gets there with f32 hot loops:
compute the residual in f64 (one matvec and an axpy per outer step) and
correct with an f32 FGMRES solve. Each outer step multiplies the
achievable residual by the f32 solve's relative accuracy (~1e-5), so 2-3
steps reach 1e-8 with almost all the work in f32.

The JAX package jits each inner FGMRES cycle with its preconditioner. Here
the f32 preconditioner the drivers pass as `M32` is a CUDA graph on the
card (`drivers.graph_pc`), replayed at every inner iteration, and the
outer loop reads the host once an outer step and once an inner
iteration (the inner cycle's stop test). The closure-hoisting caches
have no counterpart: they existed for the JAX compiler.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from mpbp_tpu_torch.solvers import gmres as krylov


class RefinementResult(NamedTuple):
    x: torch.Tensor            # f64 solution
    outer_iters: int
    total_inner_iters: int
    relres: float              # true f64 relative residual
    history: np.ndarray        # f64 relres after each outer step
    converged: bool


def block_scales(op) -> torch.Tensor:
    """Two-sided block equilibration for the saddle-point system.

    The raw system mixes momentum rows of magnitude ~eta_max/dx^2 with
    divergence rows of magnitude ~1/dx, an imbalance that pushes kappa(A)
    past what f32 Krylov can contract against. Scaling velocities by
    dx/sqrt(eta_max) and pressure by sqrt(eta_max) makes every block O(1):

        F' = s_u^2 F ~ O(1),  G' = s_u s_p G ~ O(1),  D' likewise.

    Returns the flat (5 n^2,) f64 scaling vector d on the operator's
    device; the scaled system is (D A D) y = D b with x = D y."""
    n2 = op.grid.n * op.grid.n
    eta_max = max(float(op.params["eta_n"]), float(op.params["eta_s"]))
    su = op.grid.dx / np.sqrt(eta_max)
    sp = np.sqrt(eta_max)
    kw = dict(dtype=torch.float64, device=op.grid.device)
    return torch.cat([torch.full((4 * n2,), float(su), **kw),
                      torch.full((n2,), float(sp), **kw)])


def fgmres_ir(matvec64: Callable, matvec32: Callable, b: torch.Tensor,
              tol: float = 1e-8, max_outer: int = 4,
              inner_tol: float = 1e-6, inner_maxiter: int = 150,
              M32: Callable | None = None,
              scale: torch.Tensor | None = None,
              orthog: str = "cgs2",
              inner_restart: int | None = None) -> RefinementResult:
    """Solve A x = b to f64 accuracy with f32 inner FGMRES cycles.

    matvec64: f64 apply, used once per outer step for the residual;
    matvec32: f32 apply of the RAW (unscaled) operator (the hot path);
    M32: optional f32 preconditioner for the RAW operator;
    scale: optional symmetric two-sided equilibration vector d (see
      `block_scales`). The f64 outer loop stays in natural units; each
      inner f32 cycle solves the equilibrated system (D A D) y = D r with
      the preconditioner M32(v / d) / d, and the correction is x += D y.
      Without it, badly inter-block-scaled systems make the f32
      contraction factor ~1 and IR stalls.
    inner_restart: restart length of the inner f32 cycles (bounds the f32
      V/Z basis memory)."""
    b64 = b.to(torch.float64)
    x = torch.zeros_like(b64)
    bnorm = float(torch.sqrt(torch.sum(b64 * b64)))
    if bnorm == 0:
        return RefinementResult(x, 0, 0, 0.0, np.array([0.0]), True)

    if scale is None:
        scale64, mv32, Ms = None, matvec32, M32
    else:
        scale64 = scale.to(device=b64.device, dtype=torch.float64)
        d32 = scale64.to(torch.float32)

        def mv32(v):
            return d32 * matvec32(d32 * v)

        Ms = None if M32 is None else (lambda v: M32(v / d32) / d32)

    def residual():
        """The f64 residual's norm and the equilibrated f32 inner rhs."""
        r = b64 - matvec64(x)
        rnorm = float(torch.sqrt(torch.sum(r * r)))
        rs = r if scale64 is None else scale64 * r
        return rnorm, rs.to(torch.float32)

    hist = []
    total_inner = 0
    for k in range(max_outer):
        rnorm, r32 = residual()
        relres = rnorm / bnorm
        hist.append(relres)
        if relres < tol:
            return RefinementResult(x, k, total_inner, relres,
                                    np.array(hist), True)
        inner = krylov.fgmres(mv32, r32, tol=inner_tol,
                              maxiter=inner_maxiter, M=Ms, orthog=orthog,
                              restart=inner_restart)
        total_inner += int(inner.iters)
        corr = inner.x.to(torch.float64)
        x = x + (corr if scale64 is None else scale64 * corr)

    rnorm, _ = residual()
    relres = rnorm / bnorm
    hist.append(relres)
    return RefinementResult(x, max_outer, total_inner, relres,
                            np.array(hist), relres < tol)
