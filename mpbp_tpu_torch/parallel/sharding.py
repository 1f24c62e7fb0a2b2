"""Row-band layout of grid states, the sharded LSC preconditioners and the
sharded FGMRES (port of `mpbp_tpu/parallel/sharding.py`).

The JAX package shards vectors P(None, 'x', None) over a mesh and lets
XLA turn every roll, mean and dot into halo permutes and psums. The port
is SPMD over `torch.distributed` (`parallel/distributed.py`), one rank a
device:

  * every solver vector is stacked (n_fields, n, n), and each rank holds
    its band of rows, (n_fields, n/P, n): a field never straddles ranks,
    so an inner product is one local sum and one all-reduce;
  * every rank holds the theta planes and operator coefficients whole
    (the JAX package's default `shard_multiphase(commit=False)`, where the
    planes are replicated setup data) and each apply cuts its band of
    them once, when it is built;
  * stencil applies receive their +-H halo rows from the ring neighbours
    (`parallel/halo.py`); the outer matvec and every F apply are kernel K3
    on the halo-extended band (`parallel/pallas_sharded.py`);
  * the Krylov solvers take the axis's process group and all-reduce every
    reduction (`solvers/gmres.py`); the multigrid hierarchies are built
    whole on every rank and applied on bands down to the level where the
    bands get too thin, then gathered (`solvers/multigrid.py`).
Every rank branches on all-reduced values only, so all ranks take the same
path and meet in the same collectives.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from mpbp_tpu_torch.models.fused import make_f_apply_stacked
from mpbp_tpu_torch.models.multiphase import ALL_FIELDS, MultiphaseOperator
from mpbp_tpu_torch.ops.stencil import StencilOperator
from mpbp_tpu_torch.parallel.distributed import (global_mesh_1d,
                                                  global_mesh_2d)
from mpbp_tpu_torch.parallel.halo import Axis, Ring, halo_stencil_apply
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers.multigrid import MGPressureSolver, MGVelocitySolver
from mpbp_tpu_torch.solvers.preconditioners import (lsc_products,
                                                    scaled32_apply)


def make_mesh(n_devices: int | None = None, axis: Axis = "x"):
    """`DeviceMesh` over every rank of the open process group: 1-D with the
    axis's name, or for a pair of names the 2-D (hosts, devices-per-host)
    `global_mesh_2d`, whose rows the pair shards over both dimensions. Each
    rank is one device, so `n_devices` must be None or the world size (the
    JAX package takes the first n devices of one process)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed."
                           "init_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but {world} ranks are "
                         "running: one device a rank")
    if isinstance(axis, str):
        return global_mesh_1d(axis)
    if len(axis) != 2 or len(set(axis)) != 2:
        raise ValueError(f"axis {axis!r}: one name, or two distinct names "
                         "(hosts, devices-per-host)")
    return global_mesh_2d(tuple(axis))


def stack_state(state: dict, fields: Sequence[str] = ALL_FIELDS
                ) -> torch.Tensor:
    """Field dict -> stacked (n_fields, n, n) tensor (the vector form)."""
    return torch.stack([state[f] for f in fields])


def unstack_state(v: torch.Tensor, fields: Sequence[str] = ALL_FIELDS
                  ) -> dict:
    return {f: v[i] for i, f in enumerate(fields)}


def vector_band(v: torch.Tensor, mesh, axis: Axis = "x") -> torch.Tensor:
    """This rank's band of rows of a replicated stacked vector (the JAX
    package's `device_put` with `vector_sharding`)."""
    return Ring.of(mesh, axis).band(v)


def gather_vector(v: torch.Tensor, mesh, axis: Axis = "x") -> torch.Tensor:
    """The whole stacked vector on every rank from its bands (the inverse
    of `vector_band`): an all-gather over the axis."""
    return Ring.of(mesh, axis).gather(v)


def shard_multiphase(mop: MultiphaseOperator, mesh,
                     axis: Axis = "x") -> MultiphaseOperator:
    """The system as the sharded solve takes it: every rank keeps the
    planes whole (each apply cuts its band when built), so this only checks
    that the grid's rows split evenly over the axis. (The JAX package's
    `commit=True`, planes committed to the mesh, has no counterpart.)"""
    Ring.of(mesh, axis).rows(mop.grid.n)
    return mop


def _block_apply(op: StencilOperator, mesh, axis: Axis) -> Callable:
    """op.apply on field dicts, on this rank's bands under a mesh."""
    return op.apply if mesh is None else halo_stencil_apply(op, mesh, axis)


def stacked_matvec(op: StencilOperator,
                   in_fields: Sequence[str] | None = None,
                   out_fields: Sequence[str] | None = None,
                   mesh=None, axis: Axis = "x") -> Callable:
    """Matrix-free matvec on stacked vectors: whole (n_fields, n, n)
    without a mesh, this rank's band through `halo_stencil_apply` on one.
    Handles rectangular blocks (e.g. D: velocities -> p)."""
    in_fields = tuple(in_fields) if in_fields is not None else op.in_fields
    out_fields = tuple(out_fields) if out_fields is not None else op.out_fields
    apply = _block_apply(op, mesh, axis)

    def mv(v):
        y = apply(unstack_state(v, in_fields))
        return torch.stack([y[f] for f in out_fields])

    return mv


def _lsc_apply(sop: MultiphaseOperator, GtFG, f_inner: Callable,
               p_inner: Callable, mesh=None, axis: Axis = "x") -> Callable:
    """The LSC formula on stacked (5, n, n) vectors or a rank's band of
    them, shared by the f64, mixed and block-ILU assemblies."""
    vel = sop.F.out_fields
    D, G = _block_apply(sop.D, mesh, axis), _block_apply(sop.G, mesh, axis)
    gtfg = _block_apply(GtFG, mesh, axis)

    def pc(v):
        vu, vp = v[:4], v[4]
        u_hat = f_inner(vu)
        rp = D(unstack_state(u_hat, vel))["p"] + vp
        x_a = p_inner(rp)
        x_b = gtfg({"p": x_a})["p"]
        x_p = p_inner(x_b)
        gxp = G({"p": x_p})
        u = u_hat - f_inner(torch.stack([gxp[f] for f in vel]))
        return torch.cat([u, x_p[None]])

    return pc


def _ring(mesh, axis: Axis):
    ring = None if mesh is None else Ring.of(mesh, axis)
    return ring, (None if ring is None else ring.group)


def make_sharded_lsc_pc(sop: MultiphaseOperator,
                        inner_tol: float = 1e-4, inner_iters: int = 40,
                        p_solver: str = "mg", mg_cycles: int = 3,
                        setup_op: MultiphaseOperator | None = None, *,
                        mesh=None, axis: Axis = "x") -> Callable:
    """LSC preconditioner on stacked (5, n, n) vectors, or on this rank's
    band of them under `mesh`: the form sharded_solve's FGMRES carries.

      * F inner solve: GMRES on the flux-form F (`make_f_apply_stacked`:
        K3 at p = 0 on the band), preconditioned by one velocity-MG V-cycle
        (p_solver 'mg') or by diag(F) ('cg');
      * pressure inner solve: pressure-MG V-cycles on GtG ('mg') or CG on
        GtG ('cg');
      * the GtFG, D and G applies are halo stencil applies.

    `setup_op` is the operator the MG hierarchies are built from (in the
    JAX package an unsharded twin; here every rank holds the operator
    whole, so it defaults to `sop`)."""
    if p_solver not in ("mg", "cg"):
        raise ValueError(f"unknown p_solver {p_solver!r} (mg | cg)")
    ring, group = _ring(mesh, axis)
    GtG, GtFG = lsc_products(sop)
    f_mv = make_f_apply_stacked(sop, mesh, axis)
    vel = sop.F.out_fields

    if p_solver == "mg":
        mg_src = setup_op if setup_op is not None else sop
        p_inner = MGPressureSolver.of(mg_src, cycles=mg_cycles, ring=ring)
        f_M = MGVelocitySolver.of(mg_src, cycles=1, ring=ring)
        f_iters = max(inner_iters // 4, 8)
    else:
        fdiag = torch.stack([sop.F.terms[(f, f)][(0, 0)] for f in vel])
        fdiag = fdiag if ring is None else ring.band(fdiag)
        f_M = lambda v: v / fdiag
        f_iters = inner_iters
        gtg = _block_apply(GtG, mesh, axis)

        def p_inner(rp):
            return krylov.cg(lambda p: gtg({"p": p})["p"], rp,
                             tol=inner_tol, maxiter=inner_iters,
                             group=group).x

    def f_inner(v4):
        return krylov.gmres(f_mv, v4, tol=inner_tol, maxiter=f_iters,
                            M=f_M, group=group).x

    return _lsc_apply(sop, GtFG, f_inner, p_inner, mesh, axis)


def make_sharded_lsc_pc_mixed(sop64: MultiphaseOperator,
                              sop32: MultiphaseOperator,
                              inner_tol: float = 1e-4,
                              inner_iters: int = 40,
                              mg_cycles: int = 3,
                              setup_op32: MultiphaseOperator | None = None,
                              *, mesh=None, axis: Axis = "x") -> Callable:
    """The HYBRID LSC preconditioner on stacked vectors (or bands): the
    sharded counterpart of `solvers.preconditioners.make_lsc_pc_mixed`.
    The f64 formula glue around f32 inner MG/Krylov solves, each wrapped in
    one f64 refinement pass; the f32 inputs are scaled by their global max
    (`scaled32_apply` with the axis's group)."""
    ring, group = _ring(mesh, axis)
    GtG64, GtFG64 = lsc_products(sop64)
    f_mv64 = make_f_apply_stacked(sop64, mesh, axis)
    f_mv32 = make_f_apply_stacked(sop32, mesh, axis)
    mg_src = setup_op32 if setup_op32 is not None else sop32
    p_mg32 = MGPressureSolver.of(mg_src, cycles=mg_cycles, ring=ring)
    f_M32 = MGVelocitySolver.of(mg_src, cycles=1, ring=ring)
    f_iters = max(inner_iters // 4, 8)
    gtg64 = _block_apply(GtG64, mesh, axis)

    def f_inner32(v4):
        return krylov.gmres(f_mv32, v4, tol=inner_tol, maxiter=f_iters,
                            M=f_M32, group=group).x

    def f_inner(v4):
        x = scaled32_apply(f_inner32, v4, group)
        return x + scaled32_apply(f_inner32, v4 - f_mv64(x), group)

    def p_inner(rp):
        x = scaled32_apply(p_mg32, rp, group)
        return x + scaled32_apply(p_mg32, rp - gtg64({"p": x})["p"], group)

    return _lsc_apply(sop64, GtFG64, f_inner, p_inner, mesh, axis)


def make_sharded_lsc_pc_ilu(sop: MultiphaseOperator, mesh,
                            axis: Axis = "x", dtype=torch.float64,
                            inner_tol: float = 1e-4,
                            inner_iters: int = 40) -> Callable:
    """LSC preconditioner whose inner GMRES solves are preconditioned by
    block-Jacobi ILU(0) (`parallel/block_ilu.BlockJacobiILU`): each rank
    factors only its band's diagonal block and applies it with no
    communication. GtG is singular on the periodic domain, so the pressure
    inner solve projects its rhs and its result off the constant
    nullspace (global means). The JAX package measured this PC too weak
    for the velocity block at viscosity contrast 100 (its docstring); MG
    is the production inner solve."""
    from mpbp_tpu_torch.parallel.block_ilu import BlockJacobiILU

    ring = Ring.of(mesh, axis)
    n = sop.grid.n
    GtG, GtFG = lsc_products(sop)
    f_ilu = BlockJacobiILU.of(sop.F, mesh, axis, dtype=dtype)
    p_ilu = BlockJacobiILU.of(GtG, mesh, axis, dtype=dtype)
    f_mv = make_f_apply_stacked(sop, mesh, axis)
    gtg = _block_apply(GtG, mesh, axis)

    def f_inner(v4):
        return krylov.gmres(f_mv, v4, tol=inner_tol, maxiter=inner_iters,
                            M=f_ilu, group=ring.group).x

    def p_inner(rp):
        rp = rp - ring.mean(rp, n * n)
        x = krylov.gmres(lambda p: gtg({"p": p})["p"], rp, tol=inner_tol,
                         maxiter=inner_iters, M=lambda r: p_ilu(r[None])[0],
                         group=ring.group).x
        return x - ring.mean(x, n * n)

    return _lsc_apply(sop, GtFG, f_inner, p_inner, mesh, axis)


def sharded_solve(mop: MultiphaseOperator, b_state: dict, mesh,
                  tol: float = 1e-8, maxiter: int = 100,
                  pc: Callable | None = None, axis: Axis = "x",
                  orthog: str = "cgs2", fused: bool = True,
                  pallas: bool = False, x0=None,
                  restart: int | None = None, aug_k: int = 0
                  ) -> krylov.KrylovResult:
    """FGMRES on the row-sharded multiphase system: every rank runs it on
    its band, the Arnoldi reductions all-reduce over the axis and the
    Hessenberg/Givens work is replicated on the host. `pc` works on bands
    (`make_sharded_lsc_pc*` with this mesh).

    The matvec is K3 on the halo-extended band
    (`make_fused_apply_pallas_sharded`) with `fused=True` (default) or
    `pallas=True`, which are one path here (the JAX package's are the XLA
    fused apply and the Pallas kernel); `fused=False` is the plain
    `stacked_matvec(op.A)` through `halo_stencil_apply`.

    `x0`, a replicated stacked (5, n, n) iterate (a checkpoint), restarts
    the solve from it. `restart` runs restarted cycles of that length,
    `aug_k` LGMRES augmentation. Returns the KrylovResult with x gathered
    whole, (5, n, n), on every rank."""
    from mpbp_tpu_torch.parallel.pallas_sharded import (
        make_fused_apply_pallas_sharded)

    ring = Ring.of(mesh, axis)
    sop = shard_multiphase(mop, mesh, axis)
    b_full = stack_state(b_state)
    b = ring.band(b_full)
    if fused or pallas:
        mv = make_fused_apply_pallas_sharded(sop, mesh, axis)
    else:
        mv = stacked_matvec(sop.A, mesh=mesh, axis=axis)
    x0s = None
    if x0 is not None:
        x0s = ring.band(torch.as_tensor(x0, dtype=b.dtype, device=b.device)
                        .reshape(b_full.shape))
    res = krylov.fgmres(mv, b, x0=x0s, tol=tol, maxiter=maxiter, M=pc,
                        orthog=orthog, restart=restart, aug_k=aug_k,
                        group=ring.group)
    return res._replace(x=ring.gather(res.x))
