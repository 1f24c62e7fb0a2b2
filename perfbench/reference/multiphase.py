"""The plain reference of the two-phase Stokes operator and its residual.

A frozen, independent copy of the discretisation the benchmarked program
solves: A = [[F, G], [-D, 0]] on the periodic n x n MAC grid, unknowns
[un, vn, us, vs, p] stacked as (5, n, n), worked out from the network
volume fraction theta_n alone (its cell plane and its pointwise u-face and
v-face planes; the solvent's is 1 - theta_n) and the scalars c, d, xi,
eta_n, eta_s, d_p, d_div. dx = dy = 1/n.

Per phase (theta T on cells, its face means Tx, Ty and node mean Tc):
  momentum  c Tpt u - d XI (u - u_other) + d eta L(T) u + d_p T_face grad p
  XI        xi Tx (1 - Tx) on u-faces, xi Ty (1 - Ty) on v-faces
  L         the variable-coefficient vector Laplacian div(T (grad u +
            grad u^T)) in its 9-point MAC form (cell T on the normal
            fluxes, node Tc on the shear fluxes)
and the pressure row d_div * sum over phases of div(T_face u).

Plain PyTorch in float64, any device; it reads nothing of the program.
"""

from __future__ import annotations

import torch


def sh(a: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """y[r, c] = a[(r + dr) % n, (c + dc) % n] over the last two axes."""
    if dr == 0 and dc == 0:
        return a
    return torch.roll(a, shifts=(-dr, -dc), dims=(-2, -1))


def _phase(cell: torch.Tensor, xpt: torch.Tensor, ypt: torch.Tensor) -> dict:
    """The planes one phase's rows read, from its cell and pointwise face
    planes."""
    return dict(
        cell=cell, xpt=xpt, ypt=ypt,
        xf=0.5 * (sh(cell, 0, -1) + cell),
        yf=0.5 * (sh(cell, -1, 0) + cell),
        node=0.25 * (sh(cell, -1, -1) + sh(cell, -1, 0) + sh(cell, 0, -1)
                     + cell))


def _laplacian(ph: dict, u: torch.Tensor, v: torch.Tensor, n: int):
    """(L u)_x on u-faces and (L u)_y on v-faces for one phase."""
    ix2 = iy2 = ixy = float(n * n)
    T, tn = ph["cell"], ph["node"]
    Tw, Tu = sh(T, 0, -1), sh(T, -1, 0)
    tnS, tnE = sh(tn, 1, 0), sh(tn, 0, 1)
    lu = (ix2 * (Tw * (sh(u, 0, -1) - u) + T * (sh(u, 0, 1) - u))
          + iy2 * (tn * (sh(u, -1, 0) - u) + tnS * (sh(u, 1, 0) - u))
          + ixy * ((tn - T) * v + (Tw - tn) * sh(v, 0, -1)
                   + (tnS - Tw) * sh(v, 1, -1) + (T - tnS) * sh(v, 1, 0)))
    lv = (iy2 * (Tu * (sh(v, -1, 0) - v) + T * (sh(v, 1, 0) - v))
          + ix2 * (tn * (sh(v, 0, -1) - v) + tnE * (sh(v, 0, 1) - v))
          + ixy * ((tn - T) * u + (T - tnE) * sh(u, 0, 1)
                   + (Tu - tn) * sh(u, -1, 0) + (tnE - Tu) * sh(u, -1, 1)))
    return lu, lv


def apply(theta: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    """A x for x of shape (5, n, n) (or flat), in x's dtype.

    theta: {"cell", "xface_pt", "yface_pt"}, theta_n's (n, n) planes."""
    n = theta["cell"].shape[-1]
    x = x.reshape(5, n, n)
    c, d, xi = float(params["c"]), float(params["d"]), float(params["xi"])
    etas = (float(params["eta_n"]), float(params["eta_s"]))
    d_p = float(params.get("d_p", 1.0))
    d_div = float(params.get("d_div", -1.0))
    inv_h = float(n)
    cast = {k: theta[k].to(x.dtype) for k in ("cell", "xface_pt", "yface_pt")}
    phases = (_phase(cast["cell"], cast["xface_pt"], cast["yface_pt"]),
              _phase(1.0 - cast["cell"], 1.0 - cast["xface_pt"],
                     1.0 - cast["yface_pt"]))
    vel = ((x[0], x[1]), (x[2], x[3]))
    p = x[4]
    out = torch.empty_like(x)
    div = torch.zeros_like(p)
    for k, (ph, (u, v), eta) in enumerate(zip(phases, vel, etas)):
        u_o, v_o = vel[1 - k]
        xi_u = xi * ph["xf"] * (1.0 - ph["xf"])
        xi_v = xi * ph["yf"] * (1.0 - ph["yf"])
        lu, lv = _laplacian(ph, u, v, n)
        out[2 * k] = (c * ph["xpt"] * u - d * xi_u * (u - u_o) + d * eta * lu
                      + d_p * inv_h * ph["xf"] * (p - sh(p, 0, -1)))
        out[2 * k + 1] = (c * ph["ypt"] * v - d * xi_v * (v - v_o)
                          + d * eta * lv
                          + d_p * inv_h * ph["yf"] * (sh(p, -1, 0) - p))
        div = div + inv_h * (sh(ph["xf"], 0, 1) * sh(u, 0, 1) - ph["xf"] * u
                             + ph["yf"] * v - sh(ph["yf"], 1, 0) * sh(v, 1, 0))
    out[4] = d_div * div
    return out


def relative_residual(theta: dict, params: dict, b: torch.Tensor,
                      x: torch.Tensor) -> float:
    """||b - A x|| / ||b|| in float64."""
    b64 = b.to(torch.float64).reshape(5, *theta["cell"].shape)
    x64 = x.to(device=b64.device, dtype=torch.float64)
    r = b64 - apply(theta, params, x64)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))
