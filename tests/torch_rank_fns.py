"""Rank functions of the port's multi-process tests, and the harness that
spawns them. Imports no JAX: each rank is a fresh `spawn`ed interpreter
that loads this module by name, and the tests' parent process (which
imports JAX) only reads back what the ranks return.

`run_ranks(name, world, tmp_path, timeout, contract, **kwargs)` starts
`world` gloo ranks, runs `name(**kwargs)` on each and returns their
results, rank by rank (gloo ranks, or with device="cuda" NCCL ranks, one
card each). The ranks meet through `init_distributed` under one
of its launch contracts: "args" (a `file://` store under tmp_path, passed
as arguments), "mpbp" (the same store through the MPBP_* variables) or
"torch" (env://: RANK, WORLD_SIZE, MASTER_ADDR and a free local port). A rank that raises fails
the call with its traceback; a group that has not finished within
`timeout` seconds is killed and the call raises TimeoutError, so a
deadlock fails a test instead of hanging the run.
"""

from __future__ import annotations

import pathlib
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank, world, store, name, kwargs, out_dir, contract, device):
    import os

    from mpbp_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    if contract == "mpbp":
        os.environ.update(MPBP_COORDINATOR=f"file://{store}",
                          MPBP_NUM_PROCS=str(world), MPBP_PROC_ID=str(rank))
        init_distributed(device=device)
    elif contract == "torch":
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(kwargs.pop("_port")))
        init_distributed(device=device)
    else:
        init_distributed(f"file://{store}", world, rank, device=device)
    try:
        res = globals()[name](**kwargs)
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(name: str, world: int, tmp_path, timeout: float = 300,
              contract: str = "args", device: str = "cpu",
              **kwargs) -> list:
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix=f"{name}_{world}_",
                                            dir=tmp_path))
    if contract == "torch":
        kwargs["_port"] = _free_port()
    ctx = mp.start_processes(_child, args=(world, str(out_dir / "store"),
                                           name, kwargs, str(out_dir),
                                           contract, device),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{name} on {world} ranks: not done in "
                               f"{timeout} s")
    out = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _mesh():
    from mpbp_tpu_torch.parallel import sharding as sh

    return sh.make_mesh()


def _mms(n, eta_n, dtype=torch.float64):
    from mpbp_tpu_torch.models import mms
    from mpbp_tpu_torch.models.multiphase import make_multiphase_operator

    op = make_multiphase_operator(n, c=1.0, d=-1.0, xi=1.0, eta_n=eta_n,
                                  eta_s=1.0, dtype=dtype, device="cpu")
    u, b = mms.fill_sol_and_rhs(op.grid, mms.variable_thn_problem(
        1.0, -1.0, 1.0, eta_n, 1.0))
    return op, u, b


def halo_applies(x16: np.ndarray) -> dict:
    """A at n=16 (eta_n 100) on x16 and the composed GtFG on its pressure
    plane, through `halo_stencil_apply` with and without overlap; each
    gathered whole."""
    from mpbp_tpu_torch.models.multiphase import ALL_FIELDS
    from mpbp_tpu_torch.parallel.halo import Ring, halo_stencil_apply
    from mpbp_tpu_torch.solvers.preconditioners import lsc_products

    mesh = _mesh()
    ring = Ring.of(mesh)
    op, _, _ = _mms(16, 100.0)
    _, GtFG = lsc_products(op)
    x = ring.band(torch.as_tensor(x16))
    out = {}
    for overlap in (False, True):
        y = halo_stencil_apply(op.A, mesh, overlap=overlap)(
            dict(zip(ALL_FIELDS, x)))
        out[("A", overlap)] = _np(ring.gather(torch.stack(
            [y[f] for f in ALL_FIELDS])))
        y = halo_stencil_apply(GtFG, mesh, overlap=overlap)({"p": x[4]})
        out[("GtFG", overlap)] = _np(ring.gather(y["p"]))
    return out


def k3_sharded(v32: np.ndarray) -> dict:
    """`make_fused_apply_pallas_sharded` (K3 a band; its plain version on
    the CPU) at n=32 on v32, f32 and f64, gathered; and the band F-apply
    (K3 at p = 0) on its velocity planes."""
    from mpbp_tpu_torch.models.fused import make_f_apply_stacked
    from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
    from mpbp_tpu_torch.parallel import sharding as sh
    from mpbp_tpu_torch.parallel.pallas_sharded import (
        make_fused_apply_pallas_sharded, pallas_sharded_supported)

    mesh = _mesh()
    out = {}
    for dtype in (torch.float32, torch.float64):
        op = make_multiphase_operator(32, c=1.0, d=-1.0, xi=1.0, eta_n=100.0,
                                      eta_s=1.0, dtype=dtype, device="cpu")
        out["supported"] = pallas_sharded_supported(op, mesh)
        v = sh.vector_band(torch.as_tensor(v32, dtype=dtype), mesh)
        out[("A", dtype)] = _np(sh.gather_vector(
            make_fused_apply_pallas_sharded(op, mesh)(v), mesh))
        out[("F", dtype)] = _np(sh.gather_vector(
            make_f_apply_stacked(op, mesh)(v[:4].contiguous()), mesh))
    return out


def _record(op, u, res) -> dict:
    from mpbp_tpu_torch.parallel import sharding as sh
    from mpbp_tpu_torch.utils.norms import norms_report

    err = norms_report(res.x.reshape(-1), sh.stack_state(u).reshape(-1),
                       op.grid.dx, op.grid.dy)
    return dict(iters=res.iters, converged=res.converged, relres=res.relres,
                l2=err["l2"], x=_np(res.x))


def unpreconditioned() -> dict:
    """sharded_solve without a PC at n=16 (eta_n 1), tol 1e-8: K3 with
    cgs2 and cgs1, and the plain stacked_matvec (fused=False)."""
    from mpbp_tpu_torch.parallel import sharding as sh

    mesh = _mesh()
    op, u, b = _mms(16, 1.0)
    kw = dict(tol=1e-8, maxiter=60)
    return {"cgs2": _record(op, u, sh.sharded_solve(op, b, mesh, **kw)),
            "cgs1": _record(op, u, sh.sharded_solve(op, b, mesh,
                                                    orthog="cgs1", **kw)),
            "plain": _record(op, u, sh.sharded_solve(op, b, mesh,
                                                     fused=False, **kw))}


def pc_solve(case: str, n: int, tols: tuple, maxiter: int) -> dict:
    """The sharded LSC PC `case` (mg | cg: make_sharded_lsc_pc, hybrid:
    make_sharded_lsc_pc_mixed) at eta_n=100, solved to each of `tols`."""
    from mpbp_tpu_torch.parallel import sharding as sh

    mesh = _mesh()
    op, u, b = _mms(n, 100.0)
    if case == "hybrid":
        op32, _, _ = _mms(n, 100.0, torch.float32)
        M = sh.make_sharded_lsc_pc_mixed(op, op32, inner_tol=1e-4,
                                         inner_iters=40, mesh=mesh)
    else:
        M = sh.make_sharded_lsc_pc(op, inner_tol=1e-4, inner_iters=40,
                                   p_solver=case, mesh=mesh)
    return {tol: _record(op, u, sh.sharded_solve(op, b, mesh, tol=tol,
                                                 maxiter=maxiter, pc=M))
            for tol in tols}


def resume() -> dict:
    """A solve (n=16, eta_n 1) stopped after 5 iterations, then resumed
    from its gathered x with `sharded_solve(x0=...)`."""
    from mpbp_tpu_torch.parallel import sharding as sh

    mesh = _mesh()
    op, u, b = _mms(16, 1.0)
    part = sh.sharded_solve(op, b, mesh, tol=1e-8, maxiter=5)
    out = _record(op, u, sh.sharded_solve(op, b, mesh, tol=1e-8, maxiter=60,
                                          x0=part.x))
    out["part_iters"] = part.iters
    return out


def driver(**kw) -> dict:
    """`solve_multiphase_sharded` on the ranks' device type, with this
    rank's K3 launches."""
    from mpbp_tpu_torch.drivers import solve_multiphase_sharded
    from mpbp_tpu_torch.ops.cuda_stencil import LAUNCHES
    from mpbp_tpu_torch.parallel.distributed import device_type

    before = LAUNCHES["a_apply_band"]
    rep = solve_multiphase_sharded(device=device_type(), **kw)
    return dict(iters=rep.iters, converged=rep.converged, pc=rep.pc,
                l2=rep.error_norms["l2"], devices=rep.params["devices"],
                true_relres=rep.params["true_relres"],
                k3_launches=LAUNCHES["a_apply_band"] - before)



def several(calls: list) -> list:
    """[name(**kwargs) for (name, kwargs) in calls], in one rank group."""
    return [globals()[name](**kwargs) for name, kwargs in calls]


def dia_products(cases: list, fgmres_case: tuple) -> dict:
    """`sharded_dia_matvec` on each (offsets, data (K, N), x) of `cases`
    (whole on entry; each rank takes its band through `shard_dia`), and an
    FGMRES solve of (offsets, data, b) through it; gathered whole."""
    from mpbp_tpu_torch.ops.dia import DIAMatrix
    from mpbp_tpu_torch.parallel.halo import Ring
    from mpbp_tpu_torch.parallel.sharded_dia import (shard_dia,
                                                     sharded_dia_matvec)
    from mpbp_tpu_torch.solvers import gmres as krylov

    mesh = _mesh()
    ring = Ring.of(mesh)

    def band_mv(offsets, data):
        N = data.shape[1]
        A = DIAMatrix.from_numpy((N, N), offsets, data, device="cpu")
        return sharded_dia_matvec(shard_dia(A, mesh), mesh)

    out = {"y": [_np(ring.gather(band_mv(o, d)(ring.band(
        torch.as_tensor(x), dim=0)), dim=0)) for o, d, x in cases]}
    offsets, data, b = fgmres_case
    res = krylov.fgmres(band_mv(offsets, data),
                        ring.band(torch.as_tensor(b), dim=0), tol=1e-10,
                        maxiter=80, group=ring.group)
    out["fgmres"] = dict(iters=res.iters, converged=res.converged,
                         x=_np(ring.gather(res.x, dim=0)))
    return out


def halo_2d(x16: np.ndarray) -> dict:
    """`halo_stencil_apply_2d` of A (n=16, eta_n 100) on a 2x2 mesh: each
    rank's (8, 8) patch of x16, gathered whole; and `global_mesh_2d`'s
    shape (all ranks on one host: LOCAL_WORLD_SIZE is unset)."""
    from torch.distributed.device_mesh import init_device_mesh

    from mpbp_tpu_torch.models.multiphase import ALL_FIELDS
    from mpbp_tpu_torch.parallel.distributed import global_mesh_2d
    from mpbp_tpu_torch.parallel.halo import Ring, halo_stencil_apply_2d

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("x", "y"))
    rows, cols = Ring.of(mesh, "x"), Ring.of(mesh, "y")
    op, _, _ = _mms(16, 100.0)
    x = cols.band(rows.band(torch.as_tensor(x16)), dim=-1)
    y = halo_stencil_apply_2d(op.A, mesh, ("x", "y"))(dict(zip(ALL_FIELDS,
                                                               x)))
    y = torch.stack([y[f] for f in ALL_FIELDS])
    hosts = global_mesh_2d()
    return {"y": _np(rows.gather(cols.gather(y, dim=-1))),
            "mesh_2d": (tuple(hosts.mesh.shape), hosts.mesh_dim_names)}


def block_ilu(v16: np.ndarray, solve_n: int) -> dict:
    """`BlockJacobiILU` of F (n=16, eta_n 100) on each rank's band of v16,
    gathered; and the block-ILU LSC solve at n=solve_n (tol 1e-6, 150
    iterations at most)."""
    from mpbp_tpu_torch.parallel import sharding as sh
    from mpbp_tpu_torch.parallel.block_ilu import BlockJacobiILU
    from mpbp_tpu_torch.parallel.halo import Ring

    mesh = _mesh()
    ring = Ring.of(mesh)
    op, _, _ = _mms(16, 100.0)
    bj = BlockJacobiILU.of(op.F, mesh)
    out = {"apply": _np(ring.gather(bj(ring.band(torch.as_tensor(v16)))))}
    op, u, b = _mms(solve_n, 100.0)
    M = sh.make_sharded_lsc_pc_ilu(op, mesh, inner_tol=1e-4, inner_iters=40)
    out["solve"] = _record(op, u, sh.sharded_solve(op, b, mesh, tol=1e-6,
                                                   maxiter=150, pc=M))
    return out
