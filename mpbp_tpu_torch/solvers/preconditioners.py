"""Block preconditioners for the multiphase Stokes saddle-point system
(port of `mpbp_tpu/solvers/preconditioners.py`).

`make_exact_schur_pc` is the dense exact-Schur block back-substitution
(small grids only). `make_lsc_pc` is the approximate-commutator /
least-squares-commutator Schur preconditioner:
S^-1 ~ (GtG)^-1 (Gt F G) (GtG)^-1 with GtG = (-D) G, applied with
approximate inner solves of F and GtG (Krylov, multigrid, ILU:
`ILUInner`, fixed Jacobi sweeps: `JacobiInner`, or a dense inverse:
`DenseInner`). `make_lsc_pc_mixed` keeps the LSC formula in f64 around
f32 inner solves. `make_lsc_pc_from_dia` builds LSC from DIA matrices
alone. `make_block_diagonal_pc` / `make_block_triangular_pc` are the
classical block preconditioners.

Preconditioners are flat-vector callables z = M(v) over the layout
[un, vn, us, vs, p], ready to pass as `M=` to `solvers.gmres.fgmres`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from mpbp_tpu_torch.models.fused import make_f_apply
from mpbp_tpu_torch.models.multiphase import VEL_FIELDS, MultiphaseOperator
from mpbp_tpu_torch.ops.dia import DIAMatrix
from mpbp_tpu_torch.ops.ilu import ILUPreconditioner
from mpbp_tpu_torch.ops.spgemm import lsc_products_device
from mpbp_tpu_torch.ops.stencil import StencilOperator
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
class ILUInner:
    """ILUT/ILU(0) inner solve through triangular solves (`ops/ilu.py`).

    `refine` wraps the factor apply in steps of iterative refinement
    z <- z + M^-1 (v - A z) with the matrix-free stencil apply: legal under
    a flexible outer Krylov method."""

    ilu: ILUPreconditioner
    refine: int = 0
    matvec: Callable | None = None

    @classmethod
    def ilut_of(cls, A_stencil: StencilOperator, fill: int = 100,
                tau: float = 1e-3, dtype: torch.dtype = torch.float64,
                drop_tol: float = 1e-14, refine: int = 0,
                apply: str = "level", sweeps: int = 24) -> "ILUInner":
        csr = A_stencil.to_csr(drop_tol=drop_tol)
        mv = _stencil_matvec(A_stencil, dtype) if refine else None
        return cls(ILUPreconditioner.ilut(csr, fill=fill, tau=tau,
                                          dtype=dtype, apply=apply,
                                          sweeps=sweeps), refine, mv)

    @classmethod
    def ilu0_of(cls, A_stencil: StencilOperator,
                dtype: torch.dtype = torch.float64, drop_tol: float = 1e-14,
                refine: int = 0, apply: str = "level",
                sweeps: int = 24) -> "ILUInner":
        csr = A_stencil.to_csr(drop_tol=drop_tol)
        mv = _stencil_matvec(A_stencil, dtype) if refine else None
        return cls(ILUPreconditioner.ilu0(csr, dtype=dtype, apply=apply,
                                          sweeps=sweeps), refine, mv)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        z = self.ilu.solve(v)
        for _ in range(self.refine):
            z = z + self.ilu.solve(v - self.matvec(z))
        return z


def _stencil_matvec(A_stencil: StencilOperator, dtype) -> Callable:
    tmpl = {f: torch.zeros(A_stencil.shape_grid, dtype=dtype,
                           device=A_stencil.device)
            for f in A_stencil.in_fields}
    return krylov.flatten_op(A_stencil.apply, tmpl, A_stencil.in_fields)


@dataclasses.dataclass(eq=False)
class KrylovInner:
    """Fixed-budget inner Krylov solve (matrix-free). The outer driver is
    flexible GMRES, so a varying inner solve is legal. It runs
    `gmres_fixed` / `cg_fixed`, a budget of `maxiter` steps that stops at
    convergence (`solvers/graphs.loop`): on the device inside a CUDA graph
    (an IF node a step), by a read of `done` a step when eager, as the
    JAX package's exits under jit and under disable_jit.

    `census`, where set to a (maxiter+1,) int64 tensor on the solve's
    device, counts each call's converged iterations: call c adds one at
    index iters_c, on the device (one launch a call, captured with the
    rest). maxiter - iters_c budgeted steps of that call did not run
    (inside `graphs.masked()`: ran masked)."""

    matvec: Callable
    tol: float = 1e-6
    maxiter: int = 50
    method: str = "gmres"      # "gmres" | "cg"
    M: Callable | None = None
    census: torch.Tensor | None = None

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if self.method == "cg":
            res = krylov.cg_fixed(self.matvec, v, tol=self.tol,
                                  maxiter=self.maxiter,
                                  M=self.M if self.M is not None
                                  else (lambda x: x))
        else:
            res = krylov.gmres_fixed(self.matvec, v, tol=self.tol,
                                     maxiter=self.maxiter, M=self.M)
        if self.census is not None:
            it = res.iters.view(1)
            self.census.index_add_(0, it, torch.ones_like(it))
        return res.x


@dataclasses.dataclass(eq=False)
class JacobiInner:
    """Fixed Jacobi sweeps x <- x + D^-1 (v - A x) (`gmres.jacobi`)."""

    matvec: Callable
    diag: torch.Tensor
    iters: int = 200

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return krylov.jacobi(self.matvec, self.diag, v, iters=self.iters)


@dataclasses.dataclass(eq=False)
class DenseInner:
    """Precomputed dense (pseudo-)inverse, small grids and tests only: the
    inverse is taken on the host in f64 and applied as one matmul on the
    operator's device."""

    inv: torch.Tensor

    @classmethod
    def of(cls, A_stencil: StencilOperator, pseudo: bool = False
           ) -> "DenseInner":
        d = A_stencil.to_dense()
        inv = np.linalg.pinv(d) if pseudo else np.linalg.inv(d)
        return cls(torch.as_tensor(inv, device=A_stencil.device))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.inv, v)


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


def scaled32_apply(inner32: Callable, v64: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Run an f32 inner solver on an f64 input: scale-normalize before the
    cast (Krylov solves are scale-invariant; the input magnitude after the
    LSC glue cancellations is not), solve in f32, rescale in f64. On a
    rank's band (`group`: the ranks holding the other bands) the scale is
    the max over all of them."""
    s = torch.max(torch.abs(v64))
    if group is not None:
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
    s = torch.clamp(s, min=1e-300)
    return inner32((v64 / s).to(torch.float32)).to(torch.float64) * s


def make_lsc_pc_mixed(op64: MultiphaseOperator, f_inner32: Callable,
                      p_inner32: Callable,
                      refine_inners: bool = True) -> Callable:
    """LSC apply with f64 glue and f32 inner solves.

    An all-f32 LSC apply has output error ~ eps_f32 * kappa(A) on rough
    inputs, and flexible GMRES stalls at that floor. Keeping the formula
    arithmetic (rp = D u_hat + v_p; u = u_hat - F~^-1 G x_p, the two
    cancellation-heavy lines) in f64 while the inner solves run in f32
    restores per-application quality to the inner-solve tolerance.

    refine_inners=True (the default) wraps each f32 inner solve in one f64
    residual refinement pass (x += solve32(r - Op64 x)); the F residual
    goes through kernel K1 in f64. Without it the f32 inner noise floors
    the outer FGMRES. Cost: 2x the inner solves plus one f64 block matvec
    each. refine_inners=False runs each inner solve once, scaled to f32
    and back, with no refinement pass."""
    GtG64, GtFG = lsc_products(op64)
    if not refine_inners:
        return _lsc_apply(op64, GtFG,
                          lambda vu64: scaled32_apply(f_inner32, vu64),
                          lambda rp64: scaled32_apply(p_inner32, rp64))
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


def make_lsc_pc_from_dia(minus_D: DIAMatrix, F: DIAMatrix, G: DIAMatrix,
                         inner_tol: float = 1e-4,
                         inner_iters: int = 60) -> Callable:
    """LSC preconditioner built from banded (DIA) matrix data alone: no
    stencil closures, no host factorization. GtG = (-D) G and GtFG =
    (-D) F G come from the device SpGEMM (`ops/spgemm.py`); the inner
    solves are Krylov solves on DIA matvecs, so every matvec of the apply
    is kernel K5/K6 on the card. The path for operators that arrive as
    matrices.

    minus_D: (np, nu) DIA;  F: (nu, nu) DIA;  G: (nu, np) DIA
    (flat non-periodic offsets, DIAMatrix.from_csr(periodic=False))."""
    GtG, GtFG = lsc_products_device(minus_D, F, G)
    nu = F.shape[0]

    fdiag = F.data[F.offsets.index(0)]
    f_inner = KrylovInner(F.matvec, tol=inner_tol, maxiter=inner_iters,
                          method="gmres", M=lambda v: v / fdiag)
    p_inner = KrylovInner(GtG.matvec, tol=inner_tol, maxiter=inner_iters,
                          method="cg")

    def apply(v):
        vu, vp = v[:nu], v[nu:]
        u_hat = f_inner(vu)
        rp = -minus_D.matvec(u_hat) + vp          # D = -minus_D
        x_a = p_inner(rp)
        x_p = p_inner(GtFG.matvec(x_a))
        u = u_hat - f_inner(G.matvec(x_p))
        return torch.cat([u, x_p])

    return apply


def make_exact_schur_pc(op: MultiphaseOperator, inner_tol: float = 1e-5,
                        inner_maxiter: int = 200,
                        project_nullspace: bool = True) -> Callable:
    """Dense exact-Schur block back-substitution, small grids only:
    u_hat = F^+ v_u; x_p = -GMRES(S, D u_hat + v_p); u = u_hat - F^+ G x_p,
    with S = -D F^+ G formed densely on the host in f64 and the products
    applied as matmuls on the operator's device.

    `project_nullspace` removes the constant-pressure component from the
    inner Schur rhs and solution: S is singular on the periodic domain
    (constants), and without the projection the inner GMRES residual
    recurrence drifts from the true residual on an inconsistent rhs."""
    F = op.F.to_dense()
    G = op.G.to_dense()
    D = op.D.to_dense()
    Finv = np.linalg.pinv(F)
    S = (-D) @ Finv @ G
    dev = op.grid.device
    Fi, Sj, Gj, Dj = (torch.as_tensor(a, device=dev) for a in (Finv, S, G, D))

    def s_matvec(x):
        return torch.matmul(Sj, x)

    def apply(v):
        vu, vp = split_uv_p(op, v)
        u_hat = torch.matmul(Fi, vu)
        rhs = torch.matmul(Dj, u_hat) + vp
        if project_nullspace:
            rhs = rhs - torch.mean(rhs)
        x_p = -krylov.gmres(s_matvec, rhs, tol=inner_tol,
                            maxiter=inner_maxiter).x
        if project_nullspace:
            x_p = x_p - torch.mean(x_p)
        u = u_hat - torch.matmul(Fi, torch.matmul(Gj, x_p))
        return torch.cat([u, x_p])

    return apply


def make_block_diagonal_pc(op: MultiphaseOperator, f_inner: Callable,
                           schur_inner: Callable) -> Callable:
    """M = blockdiag(F~, S~): z_u = F~^-1 v_u, z_p = S~^-1 v_p."""

    def apply(v):
        vu, vp = split_uv_p(op, v)
        return torch.cat([f_inner(vu), schur_inner(vp)])

    return apply


def make_block_triangular_pc(op: MultiphaseOperator, f_inner: Callable,
                             schur_inner: Callable) -> Callable:
    """Block lower-triangular M = [[F, 0], [-D, S~]]:
    z_u = F~^-1 v_u; z_p = S~^-1 (v_p + D z_u)."""

    def apply(v):
        vu, vp = split_uv_p(op, v)
        zu = f_inner(vu)
        rp = op.D.apply(unpack_vel(op, zu))["p"].reshape(-1) + vp
        return torch.cat([zu, schur_inner(rp)])

    return apply


def make_mass_schur_inner(op: MultiphaseOperator) -> Callable:
    """Viscosity-weighted pressure-mass approximation of the Schur inverse:
    S~^-1 v = -eta_mix v, with eta_mix = eta_n theta_n + eta_s theta_s at
    the cells."""
    p = op.params
    eta_mix = p["eta_n"] * op.phase_n.cell + p["eta_s"] * op.phase_s.cell
    scale = (-(p["d"] * -1.0) * eta_mix).reshape(-1)

    def apply(v):
        return scale * v

    return apply


def project_pressure_mean(op: MultiphaseOperator,
                          v: torch.Tensor) -> torch.Tensor:
    """Remove the constant-pressure component (the periodic problem's
    nullspace) from a flat [velocity, p] vector."""
    nu, _ = _sizes(op)
    vu, vp = v[:nu], v[nu:]
    return torch.cat([vu, vp - torch.mean(vp)])


def wrap_with_pressure_projection(op: MultiphaseOperator,
                                  pc: Callable) -> Callable:
    """The preconditioner `pc` followed by the pressure-mean projection."""

    def apply(v):
        return project_pressure_mean(op, pc(v))

    return apply
