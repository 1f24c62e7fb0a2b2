"""Time to solve the 512^2 variable-coefficient multiphase Stokes system to
1e-8 on one NVIDIA GPU (port of `benchmarks/solve_tpu.py`).

    python -m mpbp_tpu_torch.bench_solve --mode ir [--n 512] [--halo inkernel]

Modes:
  ir     - f32 inner FGMRES cycles (the f32 A-apply kernel chosen by --halo,
           the f32 preconditioner) with f64 residual refinement and block
           equilibration (solvers/mixed.fgmres_ir);
  f64    - one f64 FGMRES with an f64 preconditioner;
  hybrid - one f64 FGMRES whose LSC preconditioner runs its inner solves in
           f32 (make_preconditioner_mixed).
--halo picks the ir f32 matvec: inkernel (kernel K2), extend (the wrap rows
appended by torch.cat, then kernel K3) or pipelined (kernel K4). It is
held against the plain apply first; a mismatch raises.

The setup (assembly, MMS vectors, preconditioner) is timed on its own;
then one cold solve and one warm solve, each ending in a host sync. On a
CUDA device the preconditioner is a CUDA graph (`drivers.graph_pc`),
captured in the cold solve and replayed in the warm one. Prints
one JSON line with the keys of `benchmarks/solve_tpu.py` and a few more
(the cold time, the true relres, the device and its peak memory).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.drivers import (a_matvec, graph_pc, make_preconditioner,
                                    make_preconditioner_mixed, pack_fields)
from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.fused import make_fused_apply_kernel
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.ops.cuda_stencil import a_apply_reference
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers.mixed import block_scales, fgmres_ir
from mpbp_tpu_torch.utils.norms import norms_report

METRIC = "time_to_solve_multiphase"
HALOS = ("inkernel", "extend", "pipelined")
# the ir matvec against the plain apply, relative to max|plain|
PARITY_BOUND = 1e-5


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="mpbp_tpu_torch.bench_solve")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--pc", default="lsc_mg_full")
    ap.add_argument("--inner-tol", type=float, default=1e-6,
                    help="ir mode: f32 inner FGMRES cycle tolerance")
    ap.add_argument("--pc-inner-tol", type=float, default=1e-4,
                    help="LSC preconditioner's inner-solve tolerance")
    ap.add_argument("--inner-maxiter", type=int, default=40)
    ap.add_argument("--max-outer", type=int, default=5)
    ap.add_argument("--restart", type=int, default=0,
                    help="f64/hybrid: restarted FGMRES cycle length "
                         "(0 = no restart)")
    ap.add_argument("--aug-k", type=int, default=0,
                    help="f64/hybrid with --restart: LGMRES augmented "
                         "restarts with the last k cycle corrections")
    ap.add_argument("--eta-n", type=float, default=100.0)
    ap.add_argument("--eta-s", type=float, default=1.0)
    ap.add_argument("--mode", choices=["ir", "f64", "hybrid"], default="ir")
    ap.add_argument("--halo", choices=HALOS, default="inkernel",
                    help="ir mode: the f32 A-apply kernel (K2, K3 on the "
                         "row-extended state, K4)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@dataclasses.dataclass(eq=False)
class Setup:
    """Everything a timed solve reuses: operators, rhs/exact vectors, the
    f64 matvec and the mode's preconditioner."""

    op32: object
    op64: object
    b64: torch.Tensor
    u64: torch.Tensor
    mv64: Callable
    M: Callable | None
    scale: torch.Tensor | None
    setup_s: float
    pc_s: float


def build(args: argparse.Namespace) -> Setup:
    """Assembly, MMS vectors and the mode's preconditioner on args.device."""
    device = torch.device(args.device)
    p = dict(c=1.0, d=-1.0, xi=1.0, eta_n=args.eta_n, eta_s=args.eta_s)
    t0 = time.perf_counter()
    op32 = make_multiphase_operator(args.n, **p, dtype=torch.float32,
                                    device=device)
    op64 = make_multiphase_operator(args.n, **p, dtype=torch.float64,
                                    device=device)
    u_exact, b = mms.fill_sol_and_rhs(op64.grid, mms.variable_thn_problem(
        1.0, -1.0, 1.0, args.eta_n, args.eta_s))
    b64, u64 = pack_fields(op64, b), pack_fields(op64, u_exact)
    _sync(device)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inner = dict(inner_tol=args.pc_inner_tol, inner_iters=40)
    scale = None
    if args.mode == "f64":
        M = make_preconditioner(op64, args.pc, dtype=torch.float64, **inner)
    elif args.mode == "hybrid":
        M = make_preconditioner_mixed(op64, op32, args.pc, **inner)
    else:
        M = make_preconditioner(op32, args.pc, dtype=torch.float32, **inner)
        scale = block_scales(op64)
    _sync(device)
    return Setup(op32, op64, b64, u64, a_matvec(op64),
                 graph_pc(M, args.pc, device), scale, setup_s,
                 time.perf_counter() - t0)


def ir_matvec(setup: Setup, halo: str) -> Callable:
    """The flat f32 matvec of the ir mode through the kernel `halo` picks,
    held against the plain apply on a seeded random state (raises
    RuntimeError beyond PARITY_BOUND of max|plain|)."""
    op = setup.op32
    n = op.grid.n
    fmv = make_fused_apply_kernel(op, halo)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=(5, n, n)),
                        dtype=torch.float32, device=op.grid.device)
    got = fmv(v)
    want = a_apply_reference(op.phase_n.cell, op.phase_n.xface_pt,
                             op.phase_n.yface_pt, v, op.params, op.grid.dx,
                             op.grid.dy)
    err = float((got - want).abs().max() / want.abs().max())
    if not err < PARITY_BOUND:
        raise RuntimeError(f"ir matvec ({halo}) differs from the plain apply "
                           f"by {err:.3e} of max (bound {PARITY_BOUND:.0e})")
    log(f"ir matvec: {halo} kernel, {err:.2e} of max from the plain apply")

    def mv(x):
        return fmv(x.reshape(5, n, n)).reshape(x.shape)

    return mv


def solve(args: argparse.Namespace, setup: Setup,
          mv32: Callable | None = None) -> dict:
    """One timed solve (a host sync at the end); mv32 is the ir mode's f32
    matvec. Returns counts, residuals, the solution and the seconds."""
    device = setup.b64.device
    _sync(device)
    t0 = time.perf_counter()
    if args.mode == "ir":
        res = fgmres_ir(setup.mv64, mv32, setup.b64, tol=args.tol,
                        max_outer=args.max_outer, inner_tol=args.inner_tol,
                        inner_maxiter=args.inner_maxiter, M32=setup.M,
                        scale=setup.scale)
        outer, inner = res.outer_iters, res.total_inner_iters
        relres, converged, x = res.relres, res.converged, res.x
        history = [float(h) for h in res.history]
    else:
        res = krylov.fgmres(setup.mv64, setup.b64, tol=args.tol,
                            maxiter=8 * args.max_outer, M=setup.M,
                            restart=args.restart or None, aug_k=args.aug_k)
        outer = inner = res.iters
        x = res.x
        _, rn = krylov.residual_norm(setup.mv64, setup.b64, x)
        relres = float(rn / torch.linalg.norm(setup.b64))
        converged = res.converged and relres < args.tol * 10
        history = [float(h) for h in res.res_history[:res.iters + 1]]
    _sync(device)
    seconds = time.perf_counter() - t0
    _, rn = krylov.residual_norm(setup.mv64, setup.b64, x)
    true_relres = float(rn / torch.linalg.norm(setup.b64))
    return dict(outer_iters=outer, inner_iters=inner, relres=relres,
                true_relres=true_relres, converged=bool(converged), x=x,
                history=history, seconds=seconds)


def record(args: argparse.Namespace, setup: Setup, cold: dict,
           warm: dict) -> dict:
    """The JSON record: `benchmarks/solve_tpu.py`'s keys (counts and
    residuals of the warm run), then the halo, the cold time, the true
    relres and the device."""
    op = setup.op64
    err = norms_report(warm["x"].to(torch.float64), setup.u64, op.grid.dx,
                       op.grid.dy)
    device = setup.b64.device
    return {
        "metric": METRIC, "n": args.n, "pc": args.pc, "mode": args.mode,
        "tol": args.tol, "outer_iters": warm["outer_iters"],
        "inner_iters": warm["inner_iters"], "relres": warm["relres"],
        "converged": warm["converged"], "solve_s": round(warm["seconds"], 3),
        "error_l2": err["l2"],
        "halo": args.halo if args.mode == "ir" else None,
        "cold_s": round(cold["seconds"], 3),
        "true_relres": warm["true_relres"],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        # the device's peak allocation over the setup and both solves
        "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                    if device.type == "cuda" else None),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    log(f"bench_solve: device={args.device}, n={args.n}, pc={args.pc}, "
        f"mode={args.mode}")
    setup = build(args)
    log(f"assembly+MMS: {setup.setup_s:.2f}s, preconditioner setup: "
        f"{setup.pc_s:.2f}s")
    mv32 = ir_matvec(setup, args.halo) if args.mode == "ir" else None
    cold = solve(args, setup, mv32)
    log(f"cold solve: {cold['seconds']:.2f}s -> relres {cold['relres']:.2e}; "
        "history: " + " ".join(f"{h:.2e}" for h in cold["history"]))
    warm = solve(args, setup, mv32)
    out = record(args, setup, cold, warm)
    print(json.dumps(out), flush=True)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
