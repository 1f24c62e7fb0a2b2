"""Single-phase (variable-viscosity) Stokes saddle-point model family
(port of `mpbp_tpu/models/stokes.py`; BASELINE configs[0]-[1]).

The discretization reuses the multiphase stencil builders
(`models/multiphase.py`) with the coefficient plane in the viscosity role:
the phase Laplacian with cell plane eta is div(eta grad u) plus coupling,
and unit-weighted gradient/divergence give the standard Stokes B-blocks.

System (unknowns u, v, p):
    c u - d * div(eta grad) u + grad p = b_u
    -div u = b_p
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.models.fields import MACGrid, make_phase_fields
from mpbp_tpu_torch.models.multiphase import (divergence_operator,
                                              gradient_operator,
                                              laplacian_operator)
from mpbp_tpu_torch.ops.stencil import StencilOperator, diagonal_operator

STOKES_FIELDS = ("u", "v", "p")


@dataclasses.dataclass
class StokesOperator:
    grid: MACGrid
    A: StencilOperator
    F: StencilOperator
    G: StencilOperator
    D: StencilOperator
    minus_D: StencilOperator
    params: dict


def _full(value: float) -> Callable:
    def f(y, x):
        return torch.full(torch.broadcast_shapes(y.shape, x.shape), value,
                          dtype=y.dtype, device=y.device)
    return f


def make_stokes_operator(n: int, c: float = 1.0, d: float = -1.0,
                         eta_fn: Callable | None = None, eta: float = 1.0,
                         dtype: torch.dtype = torch.float64, *,
                         device: torch.device | str) -> StokesOperator:
    """Assemble the (variable-viscosity) Stokes saddle-point system on
    `device`. eta_fn(y, x) gives the viscosity field on torch coordinate
    planes; None means the constant `eta` (configs[0]). The unit-density
    gradient/divergence come from a constant-1 'phase'."""
    grid = MACGrid(n, dtype=dtype, device=device)
    eta_ph = make_phase_fields(grid, eta_fn if eta_fn is not None
                               else _full(eta))
    one_ph = make_phase_fields(grid, _full(1.0))

    L = laplacian_operator(eta_ph, grid, "u", "v")
    G = gradient_operator(one_ph, grid, "u", "v", "p")
    D = divergence_operator(one_ph, grid, "u", "v", "p")
    ones = torch.ones(grid.shape, dtype=dtype, device=device)
    M = diagonal_operator(("u", "v"), {"u": c * ones, "v": c * ones},
                          grid.shape)

    F = M + d * L
    minus_D = -1.0 * D
    A = F + G + minus_D
    A = StencilOperator(STOKES_FIELDS, STOKES_FIELDS, A.terms, grid.shape)

    return StokesOperator(grid=grid, A=A, F=F, G=G, D=D, minus_D=minus_D,
                          params=dict(n=n, c=c, d=d))


def stokes_mms(grid: MACGrid, c: float, d: float,
               eta_fn: Callable | None = None, eta: float = 1.0):
    """Manufactured solution for the Stokes system: divergence-free velocity
    u = sin(2pi x)cos(2pi y), v = -cos(2pi x)sin(2pi y), p = 0, with the
    RHS for the constant viscosity `eta` (`eta_fn` does not enter it)."""
    PI = np.pi
    s, co = torch.sin, torch.cos

    def u_fn(y, x):
        return s(2 * PI * x) * co(2 * PI * y)

    def v_fn(y, x):
        return -co(2 * PI * x) * s(2 * PI * y)

    # F = c I + d L with L = div(eta grad) (negative definite), so
    # F u = (c - d eta 8 pi^2) u for this eigenfunction
    def bu_fn(y, x):
        return (c - d * eta * 8 * PI * PI) * u_fn(y, x)

    def bv_fn(y, x):
        return (c - d * eta * 8 * PI * PI) * v_fn(y, x)

    zeros = torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
    u = {"u": grid.eval_at_ufaces(u_fn), "v": grid.eval_at_vfaces(v_fn),
         "p": zeros}
    b = {"u": grid.eval_at_ufaces(bu_fn), "v": grid.eval_at_vfaces(bv_fn),
         "p": zeros.clone()}
    return u, b
