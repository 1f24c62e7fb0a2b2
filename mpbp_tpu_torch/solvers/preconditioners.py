"""LSC block preconditioners for the multiphase Stokes saddle-point system
(port of the LSC part of `mpbp_tpu/solvers/preconditioners.py`).

`make_lsc_pc` is the approximate-commutator / least-squares-commutator
Schur preconditioner: S^-1 ~ (GtG)^-1 (Gt F G) (GtG)^-1 with GtG = (-D) G,
applied with approximate inner solves of F and GtG. `make_lsc_pc_mixed`
keeps the LSC formula in f64 around f32 inner solves.

Preconditioners are flat-vector callables z = M(v) over the layout
[un, vn, us, vs, p], ready to pass as `M=` to `solvers.gmres.fgmres`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mpbp_tpu_torch.models.fused import make_f_apply
from mpbp_tpu_torch.models.multiphase import VEL_FIELDS, MultiphaseOperator
from mpbp_tpu_torch.solvers import gmres as krylov


def _sizes(op: MultiphaseOperator):
    n2 = op.grid.n * op.grid.n
    return 4 * n2, n2


def split_uv_p(op: MultiphaseOperator, v: torch.Tensor):
    nu, _ = _sizes(op)
    return v[:nu], v[nu:]


def unpack_vel(op: MultiphaseOperator, vu: torch.Tensor) -> dict:
    n = op.grid.n
    n2 = n * n
    return {f: vu[i * n2:(i + 1) * n2].reshape(n, n)
            for i, f in enumerate(VEL_FIELDS)}


def pack_vel(op: MultiphaseOperator, x: dict) -> torch.Tensor:
    return torch.cat([x[f].reshape(-1) for f in VEL_FIELDS])


def lsc_products(op: MultiphaseOperator):
    """Gt_G = (-D) G and Gt_F_G = (-D) F G as exact stencil operators."""
    GtG = op.minus_D @ op.G
    GtFG = (op.minus_D @ op.F) @ op.G
    return GtG, GtFG


@dataclasses.dataclass(eq=False)
class KrylovInner:
    """Fixed-budget inner Krylov solve (matrix-free). The outer driver is
    flexible GMRES, so a varying inner solve is legal."""

    matvec: Callable
    tol: float = 1e-6
    maxiter: int = 50
    method: str = "gmres"      # "gmres" | "cg"
    M: Callable | None = None

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if self.method == "cg":
            res = krylov.cg(self.matvec, v, tol=self.tol, maxiter=self.maxiter,
                            M=self.M if self.M is not None else (lambda x: x))
        else:
            res = krylov.gmres(self.matvec, v, tol=self.tol,
                               maxiter=self.maxiter, M=self.M)
        return res.x


def _lsc_apply(op: MultiphaseOperator, GtFG, f_inner: Callable,
               p_inner: Callable) -> Callable:
    n = op.grid.n

    def apply(v):
        vu, vp = split_uv_p(op, v)
        u_hat = f_inner(vu)
        rp = op.D.apply(unpack_vel(op, u_hat))["p"] + vp.reshape(n, n)
        x_a = p_inner(rp.reshape(-1))
        x_b = GtFG.apply({"p": x_a.reshape(n, n)})["p"]
        x_p = p_inner(x_b.reshape(-1))
        gxp = op.G.apply({"p": x_p.reshape(n, n)})
        u = u_hat - f_inner(pack_vel(op, gxp))
        return torch.cat([u, x_p])

    return apply


def make_lsc_pc(op: MultiphaseOperator, f_inner: Callable,
                p_inner: Callable) -> Callable:
    """Approximate-commutator Schur PC.

    apply(v):
      u_hat = F~^-1 v_u
      r_p   = D u_hat + v_p
      x_a   = (GtG)~^-1 r_p
      x_b   = (Gt F G) x_a
      x_p   = (GtG)~^-1 x_b
      u     = u_hat - F~^-1 (G x_p)
      return [u, x_p]
    """
    _, GtFG = lsc_products(op)
    return _lsc_apply(op, GtFG, f_inner, p_inner)


def scaled32_apply(inner32: Callable, v64: torch.Tensor) -> torch.Tensor:
    """Run an f32 inner solver on an f64 input: scale-normalize before the
    cast (Krylov solves are scale-invariant; the input magnitude after the
    LSC glue cancellations is not), solve in f32, rescale in f64."""
    s = torch.clamp(torch.max(torch.abs(v64)), min=1e-300)
    return inner32((v64 / s).to(torch.float32)).to(torch.float64) * s


def make_lsc_pc_mixed(op64: MultiphaseOperator, f_inner32: Callable,
                      p_inner32: Callable) -> Callable:
    """LSC apply with f64 glue and f32 inner solves.

    An all-f32 LSC apply has output error ~ eps_f32 * kappa(A) on rough
    inputs, and flexible GMRES stalls at that floor. Keeping the formula
    arithmetic (rp = D u_hat + v_p; u = u_hat - F~^-1 G x_p, the two
    cancellation-heavy lines) in f64 while the inner solves run in f32
    restores per-application quality to the inner-solve tolerance.

    Each f32 inner solve is wrapped in one f64 residual refinement pass
    (x += solve32(r - Op64 x)); the F residual goes through kernel K1 in
    f64. Without it the f32 inner noise floors the outer FGMRES. Cost: 2x
    the inner solves plus one f64 block matvec each. (The JAX package's
    `refine_inners=False` variant is not ported: nothing calls it.)"""
    GtG64, GtFG = lsc_products(op64)
    n = op64.grid.n
    fmv64 = make_f_apply(op64)

    def gtg_mv64(p):
        return GtG64.apply({"p": p.reshape(n, n)})["p"].reshape(-1)

    def f_inner(vu64):
        x = scaled32_apply(f_inner32, vu64)
        return x + scaled32_apply(f_inner32, vu64 - fmv64(x))

    def p_inner(rp64):
        x = scaled32_apply(p_inner32, rp64)
        return x + scaled32_apply(p_inner32, rp64 - gtg_mv64(x))

    return _lsc_apply(op64, GtFG, f_inner, p_inner)


def project_pressure_mean(op: MultiphaseOperator,
                          v: torch.Tensor) -> torch.Tensor:
    """Remove the constant-pressure component (the periodic problem's
    nullspace) from a flat [velocity, p] vector."""
    nu, _ = _sizes(op)
    vu, vp = v[:nu], v[nu:]
    return torch.cat([vu, vp - torch.mean(vp)])
