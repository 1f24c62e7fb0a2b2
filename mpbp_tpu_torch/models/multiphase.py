"""Two-phase (network/solvent) variable-coefficient Stokes operator assembly
(port of `mpbp_tpu/models/multiphase.py`).

Every block is a `StencilOperator` whose coefficient planes come from the
theta planes by a handful of rolls. Blocks per phase:
  L  - variable-coefficient vector Laplacian on (u, v) faces, 9-point
  D  - weighted divergence, cell <- faces
  G  - weighted gradient, faces <- cells
  XI - drag diagonal xi*theta_n*theta_s at faces

Coupled saddle-point system:
  F = [[c*Thn_pt - d*XI,  d*XI           ],   + d * blockdiag(eta_n L_n, eta_s L_s)
       [d*XI,             c*Ths_pt - d*XI]]
  A = [[F, G], [-D, 0]]   with unknowns [un, vn, us, vs, p].

The coefficient derivation (one u-row and one v-row of L, term by term) is
written out in the JAX module's docstring; the algebra here is identical.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.models.fields import (MACGrid, PhaseFields, default_thn,
                                          make_phase_fields,
                                          make_phase_fields_from_planes)
from mpbp_tpu_torch.ops.stencil import StencilOperator, diagonal_operator, shift
from mpbp_tpu_torch.utils import metrics

VEL_FIELDS = ("un", "vn", "us", "vs")
ALL_FIELDS = ("un", "vn", "us", "vs", "p")


def laplacian_operator(ph: PhaseFields, grid: MACGrid,
                       u: str = "u", v: str = "v") -> StencilOperator:
    """Variable-coefficient vector Laplacian L for one phase."""
    dx, dy = grid.dx, grid.dy
    T = ph.cell
    tn = ph.node
    Tw = shift(T, 0, -1)     # T[r, c-1]
    Tu = shift(T, -1, 0)     # T[r-1, c]
    tnS = shift(tn, 1, 0)    # tn[r+1, c]
    tnE = shift(tn, 0, 1)    # tn[r, c+1]
    ix2, iy2, ixy = 1.0 / dx**2, 1.0 / dy**2, 1.0 / (dx * dy)

    terms = {
        (u, u): {
            (0, 0): -ix2 * (T + Tw) - iy2 * (tn + tnS),
            (0, -1): ix2 * Tw,
            (0, 1): ix2 * T,
            (-1, 0): iy2 * tn,
            (1, 0): iy2 * tnS,
        },
        (u, v): {
            (0, 0): ixy * (tn - T),
            (0, -1): ixy * (Tw - tn),
            (1, -1): ixy * (tnS - Tw),
            (1, 0): ixy * (T - tnS),
        },
        (v, v): {
            (0, 0): -iy2 * (Tu + T) - ix2 * (tnE + tn),
            (0, -1): ix2 * tn,
            (0, 1): ix2 * tnE,
            (-1, 0): iy2 * Tu,
            (1, 0): iy2 * T,
        },
        (v, u): {
            (0, 0): ixy * (tn - T),
            (0, 1): ixy * (T - tnE),
            (-1, 0): ixy * (Tu - tn),
            (-1, 1): ixy * (tnE - Tu),
        },
    }
    return StencilOperator((u, v), (u, v), terms, grid.shape)


def gradient_operator(ph: PhaseFields, grid: MACGrid,
                      u: str = "u", v: str = "v", p: str = "p") -> StencilOperator:
    """Weighted pressure gradient G: u-face (r,c): tx/dx * (p[r,c] -
    p[r,c-1]); v-face: ty/dy * (p[r-1,c] - p[r,c])."""
    dx, dy = grid.dx, grid.dy
    terms = {
        (u, p): {(0, 0): ph.xface / dx, (0, -1): -ph.xface / dx},
        (v, p): {(0, 0): -ph.yface / dy, (-1, 0): ph.yface / dy},
    }
    return StencilOperator((u, v), (p,), terms, grid.shape)


def divergence_operator(ph: PhaseFields, grid: MACGrid,
                        u: str = "u", v: str = "v", p: str = "p") -> StencilOperator:
    """Weighted divergence D: cell (r,c): (tx[r,c+1] u[r,c+1] - tx[r,c]
    u[r,c])/dx + (ty[r,c] v[r,c] - ty[r+1,c] v[r+1,c])/dy."""
    dx, dy = grid.dx, grid.dy
    terms = {
        (p, u): {(0, 1): shift(ph.xface, 0, 1) / dx, (0, 0): -ph.xface / dx},
        (p, v): {(0, 0): ph.yface / dy, (1, 0): -shift(ph.yface, 1, 0) / dy},
    }
    return StencilOperator((p,), (u, v), terms, grid.shape)


def drag_diagonal(ph: PhaseFields, xi: float, grid: MACGrid,
                  u: str = "u", v: str = "v") -> StencilOperator:
    """XI = xi * theta * (1 - theta) at faces from averaged theta (the same
    for both phases, since t(1-t) is symmetric under t -> 1-t)."""
    diags = {
        u: xi * ph.xface * (1.0 - ph.xface),
        v: xi * ph.yface * (1.0 - ph.yface),
    }
    return diagonal_operator((u, v), diags, grid.shape)


@dataclasses.dataclass
class MultiphaseOperator:
    """The assembled coupled system and its blocks, all as StencilOperators.

    A        : full saddle-point operator [[F, G], [-D, 0]] on ALL_FIELDS
    F        : velocity block (4 fields)
    G        : gradient block (velocity <- p), includes d_p scaling
    D        : divergence block (p <- velocity), the unsigned D
    minus_D  : d_div * D as used in A's bottom row
    Ln, Ls   : per-phase Laplacians (unscaled by eta/d)
    """

    grid: MACGrid
    A: StencilOperator
    F: StencilOperator
    G: StencilOperator
    D: StencilOperator
    minus_D: StencilOperator
    Ln: StencilOperator
    Ls: StencilOperator
    XIn: StencilOperator
    XIs: StencilOperator
    phase_n: PhaseFields
    phase_s: PhaseFields
    params: dict


def assemble_velocity_block(ph_n: PhaseFields, ph_s: PhaseFields,
                            grid: MACGrid, c: float, d: float, xi: float,
                            eta_n: float, eta_s: float) -> StencilOperator:
    """The coupled velocity block F = mass/drag coupling + d*blockdiag(
    eta_n Ln, eta_s Ls), from explicit phase fields (the main assembly and
    the multigrid coarse levels share it)."""
    Ln = laplacian_operator(ph_n, grid, "un", "vn")
    Ls = laplacian_operator(ph_s, grid, "us", "vs")
    XIn = drag_diagonal(ph_n, xi, grid, "un", "vn")
    XIs = drag_diagonal(ph_s, xi, grid, "us", "vs")

    # mass weights use theta evaluated pointwise at the faces
    Wn = diagonal_operator(("un", "vn"),
                           {"un": c * ph_n.xface_pt, "vn": c * ph_n.yface_pt},
                           grid.shape)
    Ws = diagonal_operator(("us", "vs"),
                           {"us": c * ph_s.xface_pt, "vs": c * ph_s.yface_pt},
                           grid.shape)

    # cross-phase drag: the off-diagonal +d*XI blocks act on the other
    # phase's velocity
    def renamed_diag(base: StencilOperator, out_in_pairs):
        terms = {}
        for (of, _), offmap in base.terms.items():
            terms[(of, out_in_pairs[of])] = dict(offmap)
        return StencilOperator(base.out_fields, tuple(out_in_pairs.values()),
                               terms, base.shape_grid)

    XIn_cross = renamed_diag(XIn, {"un": "us", "vn": "vs"})
    XIs_cross = renamed_diag(XIs, {"us": "un", "vs": "vn"})

    return (
        Wn + Ws
        + (-d) * XIn + d * XIn_cross
        + (-d) * XIs + d * XIs_cross
        + (d * eta_n) * Ln
        + (d * eta_s) * Ls
    )


@metrics.spanned("operator.assemble")
def make_multiphase_operator(
    n: int,
    c: float = 1.0,
    d: float = -1.0,
    xi: float = 1.0,
    eta_n: float = 1.0,
    eta_s: float = 1.0,
    d_p: float = 1.0,
    d_div: float = -1.0,
    thn_fn: Callable = default_thn,
    *,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str,
    theta_planes: dict | None = None,
) -> MultiphaseOperator:
    """Assemble the coupled multiphase Stokes operator on an n x n periodic
    MAC grid, on `device` in `dtype`.

    `theta_planes` injects explicit theta_n planes instead of evaluating
    `thn_fn`: "cell" (required, (n, n)), "xface_pt"/"yface_pt" (optional
    pointwise face planes for the mass term)."""
    grid = MACGrid(n, dtype=dtype, device=device)

    if theta_planes is not None:
        ph_n = make_phase_fields_from_planes(
            grid, theta_planes["cell"],
            xface_pt=theta_planes.get("xface_pt"),
            yface_pt=theta_planes.get("yface_pt"))
        ph_s = make_phase_fields_from_planes(
            grid, 1.0 - ph_n.cell,
            xface_pt=(1.0 - ph_n.xface_pt), yface_pt=(1.0 - ph_n.yface_pt))
    else:
        def ths_fn(y, x):
            return 1.0 - thn_fn(y, x)

        ph_n = make_phase_fields(grid, thn_fn)
        ph_s = make_phase_fields(grid, ths_fn)

    Gn = gradient_operator(ph_n, grid, "un", "vn", "p")
    Gs = gradient_operator(ph_s, grid, "us", "vs", "p")
    Dn = divergence_operator(ph_n, grid, "un", "vn", "p")
    Ds = divergence_operator(ph_s, grid, "us", "vs", "p")
    XIn = drag_diagonal(ph_n, xi, grid, "un", "vn")
    XIs = drag_diagonal(ph_s, xi, grid, "us", "vs")
    Ln = laplacian_operator(ph_n, grid, "un", "vn")
    Ls = laplacian_operator(ph_s, grid, "us", "vs")

    F = assemble_velocity_block(ph_n, ph_s, grid, c, d, xi, eta_n, eta_s)

    G = d_p * (Gn + Gs)
    D = Dn + Ds
    minus_D = d_div * D

    A = F + G + minus_D
    # normalize field ordering to the [un, vn, us, vs, p] layout
    A = StencilOperator(ALL_FIELDS, ALL_FIELDS, A.terms, grid.shape)
    F = StencilOperator(VEL_FIELDS, VEL_FIELDS, F.terms, grid.shape)
    G = StencilOperator(VEL_FIELDS, ("p",), G.terms, grid.shape)
    D = StencilOperator(("p",), VEL_FIELDS, D.terms, grid.shape)
    minus_D = StencilOperator(("p",), VEL_FIELDS, minus_D.terms, grid.shape)

    return MultiphaseOperator(
        grid=grid, A=A, F=F, G=G, D=D, minus_D=minus_D,
        Ln=Ln, Ls=Ls, XIn=XIn, XIs=XIs,
        phase_n=ph_n, phase_s=ph_s,
        params=dict(n=n, c=c, d=d, xi=xi, eta_n=eta_n, eta_s=eta_s,
                    d_p=d_p, d_div=d_div),
    )


def operator_from_numpy(cell: np.ndarray, xface_pt: np.ndarray,
                        yface_pt: np.ndarray, params: dict, *,
                        device: torch.device | str,
                        dtype: torch.dtype) -> MultiphaseOperator:
    """The port's operator from theta_n planes given as numpy arrays, through
    the `theta_planes` path. This system has no weights: the theta planes
    are its state, so this is how the port is put on exactly the inputs of
    another implementation (e.g. `np.asarray(op.phase_n.cell)` of the JAX
    package's operator). `params` holds c, d, xi, eta_n, eta_s and
    optionally d_p, d_div; an "n" entry must match the planes."""
    n = cell.shape[0]
    if cell.shape != (n, n) or xface_pt.shape != (n, n) \
            or yface_pt.shape != (n, n):
        raise ValueError(f"theta planes must all be (n, n): {cell.shape}, "
                         f"{xface_pt.shape}, {yface_pt.shape}")
    kw = dict(params)
    if kw.pop("n", n) != n:
        raise ValueError(f"params['n']={params['n']} but planes are {n}x{n}")
    planes = {k: torch.tensor(np.asarray(a, np.float64), device=device)
              for k, a in (("cell", cell), ("xface_pt", xface_pt),
                           ("yface_pt", yface_pt))}
    return make_multiphase_operator(n, **kw, dtype=dtype, device=device,
                                    theta_planes=planes)
