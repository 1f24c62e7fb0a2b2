"""Method-of-manufactured-solutions (MMS) problems and vector fill (port of
`mpbp_tpu/models/mms.py`).

All functions take (y, x) in that order and are evaluated on whole staggered
coordinate grids at once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.models.fields import MACGrid

PI = np.pi


@dataclasses.dataclass(frozen=True)
class MMSProblem:
    """A manufactured solution: exact fields and the RHS they induce."""

    u_n_x: Callable
    u_n_y: Callable
    u_s_x: Callable
    u_s_y: Callable
    p: Callable
    b_n_x: Callable
    b_n_y: Callable
    b_s_x: Callable
    b_s_y: Callable
    b_p: Callable


def _zeros(y, x):
    return torch.zeros(torch.broadcast_shapes(y.shape, x.shape),
                       dtype=y.dtype, device=y.device)


def variable_thn_problem(c: float, d: float, xi: float,
                         eta_n: float, eta_s: float,
                         nu: float = 1.0) -> MMSProblem:
    """Manufactured problem for theta_n = 0.25 sin(2 pi x) sin(2 pi y) + 0.5.
    The RHS formulas are the images of the exact solution under the
    continuous multiphase operator."""
    s = torch.sin
    co = torch.cos

    def u_n_x(y, x):
        return s(2 * PI * x) * co(2 * PI * y)

    def u_n_y(y, x):
        return co(2 * PI * x) * s(2 * PI * y)

    def u_s_x(y, x):
        return -s(2 * PI * x) * co(2 * PI * y)

    def u_s_y(y, x):
        return -co(2 * PI * x) * s(2 * PI * y)

    def b_n_x(y, x):
        sx, sy = s(2 * PI * x), s(2 * PI * y)
        return (co(2 * PI * y) * sx *
                (4 * c * nu - 4 * d * (8 * eta_n * nu * PI * PI + xi)
                 + 2 * nu * (c - 16 * d * eta_n * PI * PI) * sx * sy
                 + d * xi * sx * sx * sy * sy)) / (8 * nu)

    def b_n_y(y, x):
        sx, sy = s(2 * PI * x), s(2 * PI * y)
        return (co(2 * PI * x) * sy *
                (4 * c * nu - 4 * d * (8 * eta_n * nu * PI * PI + xi)
                 + 2 * nu * (c - 16 * d * eta_n * PI * PI) * sx * sy
                 + d * xi * sx * sx * sy * sy)) / (8 * nu)

    def b_s_x(y, x):
        sx, sy = s(2 * PI * x), s(2 * PI * y)
        return (co(2 * PI * y) * sx *
                (-4 * c * nu + 4 * d * (8 * eta_s * nu * PI * PI + xi)
                 + 2 * nu * (c - 16 * d * eta_s * PI * PI) * sx * sy
                 - d * xi * sx * sx * sy * sy)) / (8 * nu)

    def b_s_y(y, x):
        sx, sy = s(2 * PI * x), s(2 * PI * y)
        return (co(2 * PI * x) * sy *
                (-4 * c * nu + 4 * d * (8 * eta_s * nu * PI * PI + xi)
                 + 2 * nu * (c - 16 * d * eta_s * PI * PI) * sx * sy
                 - d * xi * sx * sx * sy * sy)) / (8 * nu)

    def b_p(y, x):
        return -PI * torch.sin(4 * PI * x) * torch.sin(4 * PI * y)

    return MMSProblem(u_n_x, u_n_y, u_s_x, u_s_y, _zeros,
                      b_n_x, b_n_y, b_s_x, b_s_y, b_p)


def constant_thn_problem(c: float, d: float, xi: float,
                         eta_n: float, eta_s: float,
                         nu: float = 1.0) -> MMSProblem:
    """Manufactured problem for constant theta_n = 0.75."""
    s = torch.sin
    co = torch.cos

    def u_n_x(y, x):
        return s(2 * PI * x) * co(2 * PI * y)

    def u_n_y(y, x):
        return co(2 * PI * x) * s(2 * PI * y)

    def u_s_x(y, x):
        return -s(2 * PI * x) * co(2 * PI * y)

    def u_s_y(y, x):
        return -co(2 * PI * x) * s(2 * PI * y)

    def b_n_x(y, x):
        return (3 * (2 * c * nu - d * (16 * eta_n * nu * PI * PI + xi))
                * co(2 * PI * y) * s(2 * PI * x)) / (8 * nu)

    def b_n_y(y, x):
        return (3 * (2 * c * nu - d * (16 * eta_n * nu * PI * PI + xi))
                * co(2 * PI * x) * s(2 * PI * y)) / (8 * nu)

    def b_s_x(y, x):
        return ((-2 * c * nu + 16 * d * eta_s * nu * PI * PI + 3 * d * xi)
                * co(2 * PI * y) * s(2 * PI * x)) / (8 * nu)

    def b_s_y(y, x):
        return ((-2 * c * nu + 16 * d * eta_s * nu * PI * PI + 3 * d * xi)
                * co(2 * PI * x) * s(2 * PI * y)) / (8 * nu)

    def b_p(y, x):
        return -2 * PI * co(2 * PI * x) * co(2 * PI * y)

    return MMSProblem(u_n_x, u_n_y, u_s_x, u_s_y, _zeros,
                      b_n_x, b_n_y, b_s_x, b_s_y, b_p)


def fill_state(grid: MACGrid, ux_fn, uy_fn, u: str, v: str) -> dict:
    """Evaluate a velocity pair on the staggered faces."""
    return {
        u: grid.eval_at_ufaces(ux_fn),
        v: grid.eval_at_vfaces(uy_fn),
    }


def fill_sol_and_rhs(grid: MACGrid, prob: MMSProblem) -> tuple[dict, dict]:
    """(exact solution state, RHS state) as field dicts keyed by
    un/vn/us/vs/p."""
    u = {
        "un": grid.eval_at_ufaces(prob.u_n_x),
        "vn": grid.eval_at_vfaces(prob.u_n_y),
        "us": grid.eval_at_ufaces(prob.u_s_x),
        "vs": grid.eval_at_vfaces(prob.u_s_y),
        "p": grid.eval_at_cells(prob.p),
    }
    b = {
        "un": grid.eval_at_ufaces(prob.b_n_x),
        "vn": grid.eval_at_vfaces(prob.b_n_y),
        "us": grid.eval_at_ufaces(prob.b_s_x),
        "vs": grid.eval_at_vfaces(prob.b_s_y),
        "p": grid.eval_at_cells(prob.b_p),
    }
    return u, b
