"""Command-line drivers, as `python -m mpbp_tpu_torch <cmd>` (port of
`mpbp_tpu/cli.py`).

Commands:
  solve   - assemble and FGMRES-solve the MMS multiphase system on
            --device (precision full, hybrid or ir), print a structured
            report; --metrics-json writes a SolveMetrics record,
            --checkpoint the solution as a Krylov-state npz
  apply   - apply A to the exact MMS solution, print error norms
  eigs    - spectra of A and of the preconditioned operator (--report
            writes a spectrum_report JSON, --plot renders it: needs
            matplotlib)
  export  - CSV dump of one phase's block matrices
  solve --sharded - the row-sharded solve (drivers.solve_multiphase_sharded)
            over every rank of the process group, one device a rank:
            under `python -m torch.distributed.run --nproc-per-node P`
            (the env:// contract) or the MPBP_* variables, else one rank;
            rank 0 prints the report
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from mpbp_tpu_torch.utils import config as cfg

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mpbp_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_solve = sub.add_parser("solve", help="MMS solve with a block PC")
    cfg.add_dataclass_args(p_solve, cfg.ProblemConfig)
    cfg.add_dataclass_args(p_solve, cfg.SolverConfig)
    p_solve.add_argument("--true-res-monitor", action="store_true",
                         help="recompute and print the TRUE residual "
                              "||b - A x_k|| / ||b|| every iteration (one "
                              "extra matvec per iteration; precision full, "
                              "no --restart)")
    p_solve.add_argument("--restart", type=int, default=None,
                         help="restarted outer cycles (bounds the Krylov "
                              "basis memory; the inner f32 cycle length "
                              "with --precision ir)")
    p_solve.add_argument("--metrics-json", default="",
                         help="write SolveMetrics JSON to this path")
    p_solve.add_argument("--checkpoint", default="",
                         help="write the solution checkpoint (npz, "
                              "utils/checkpoint.save_krylov_state) to this "
                              "path")
    p_solve.add_argument("--sharded", action="store_true",
                         help="row-shard the solve over every rank of the "
                              "process group, one device a rank "
                              "(drivers.solve_multiphase_sharded)")
    p_solve.add_argument("--sharded-pc", default="mg",
                         choices=["mg", "cg", "block_ilu0"],
                         help="sharded LSC inner-solve family (block_ilu0 = "
                              "block-Jacobi ILU(0) triangular solves)")
    cfg.add_dataclass_args(p_solve, cfg.MeshConfig)

    p_apply = sub.add_parser("apply", help="operator-apply MMS check")
    cfg.add_dataclass_args(p_apply, cfg.ProblemConfig)
    p_apply.add_argument("--device", default="cuda",
                         help="torch device to assemble and apply on")

    p_eigs = sub.add_parser("eigs", help="spectral analysis of A and A*M^-1")
    cfg.add_dataclass_args(p_eigs, cfg.ProblemConfig)
    cfg.add_dataclass_args(p_eigs, cfg.SolverConfig)
    p_eigs.add_argument("--k", type=int, default=10)
    p_eigs.add_argument("--report", default="",
                        help="write a plot-ready spectrum report (JSON: "
                             "spec(A) and spec(A*M^-1) per PC with their "
                             "clustering radii) to this path")
    p_eigs.add_argument("--pcs", default="",
                        help="comma-separated PC kinds for --report "
                             "(default: the --pc value, or exact_schur,"
                             "lsc_ilut)")
    p_eigs.add_argument("--exact", action="store_true",
                        help="dense full spectrum (small n only) instead of "
                             "matrix-free Arnoldi")
    p_eigs.add_argument("--plot", default="",
                        help="also render the --report spectra to this image "
                             "path (needs matplotlib)")

    p_exp = sub.add_parser("export", help="CSV dump of block matrices")
    cfg.add_dataclass_args(p_exp, cfg.ProblemConfig)
    p_exp.add_argument("--outdir", default=".")
    p_exp.add_argument("--phase", default="n", choices=["n", "s"])
    p_exp.add_argument("--device", default="cuda",
                       help="torch device to assemble on")

    args = parser.parse_args(argv)
    prob = cfg.dataclass_from_args(cfg.ProblemConfig, args)
    if args.cmd == "eigs":
        return _eigs(args, prob)
    if args.cmd == "export":
        from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
        from mpbp_tpu_torch.utils.csv_export import write_blocks_to_csv

        op = make_multiphase_operator(prob.n, c=prob.c, d=prob.d, xi=prob.xi,
                                      eta_n=prob.eta_n, eta_s=prob.eta_s,
                                      device=args.device)
        for p in write_blocks_to_csv(op, args.outdir, args.phase):
            print("wrote", p)
        return 0

    if args.cmd == "solve":
        from mpbp_tpu_torch.drivers import solve_multiphase
        from mpbp_tpu_torch.utils.metrics import Timer, collect_solve_metrics

        sol = cfg.dataclass_from_args(cfg.SolverConfig, args)
        if args.sharded:
            if sol.precision == "ir":
                parser.error("--sharded supports precision full (f64) or "
                             "hybrid; 'ir' has no sharded configuration "
                             "(use --precision hybrid: the same "
                             "f32-dominant inner work, f64-certified outer)")
            return _solve_sharded(args, prob, sol)
        if sol.dtype not in _DTYPES:
            parser.error(f"--dtype must be one of {sorted(_DTYPES)}")
        with Timer() as t_all:
            rep = solve_multiphase(
                n=prob.n, c=prob.c, d=prob.d, xi=prob.xi, eta_n=prob.eta_n,
                eta_s=prob.eta_s, problem=prob.problem, pc=sol.pc,
                tol=sol.tol, maxiter=sol.maxiter, dtype=_DTYPES[sol.dtype],
                ilut_fill=sol.ilut_fill, ilut_tau=sol.ilut_tau,
                ilut_refine=sol.ilut_refine, inner_tol=sol.inner_tol,
                inner_iters=sol.inner_iters, precision=sol.precision,
                restart=args.restart, true_res_monitor=args.true_res_monitor,
                device=sol.device)
        print(f"solve: n={rep.n} pc={rep.pc} precision={sol.precision} "
              f"device={sol.device} iters={rep.iters} "
              f"relres={rep.relres:.3e} "
              f"true_relres={rep.params['true_relres']:.3e} "
              f"converged={rep.converged} seconds={t_all.elapsed:.3f}")
        print(f"error norms vs MMS exact: "
              f"L1={rep.error_norms['l1']:.6e} "
              f"L2={rep.error_norms['l2']:.6e} "
              f"max={rep.error_norms['max']:.6e}")
        print("residual history:",
              " ".join(f"{r:.3e}" for r in rep.res_history[:10]),
              "..." if len(rep.res_history) > 10 else "")
        if "true_res_history" in rep.params:
            print("true residual history:", " ".join(
                f"{r:.3e}" for r in rep.params["true_res_history"]))
        if args.metrics_json:
            nnz = 11 * 5 * prob.n * prob.n  # stencil-tap estimate
            m = collect_solve_metrics(rep, nnz, 0.0, t_all.elapsed)
            with open(args.metrics_json, "w") as f:
                f.write(m.to_json())
        if args.checkpoint:
            from mpbp_tpu_torch.utils.checkpoint import save_krylov_state
            save_krylov_state(args.checkpoint, rep.x, rep.res_history,
                              rep.iters, meta=rep.params)
        return 0 if rep.converged else 2

    from mpbp_tpu_torch.drivers import apply_report

    rep = apply_report(n=prob.n, c=prob.c, d=prob.d, xi=prob.xi,
                       eta_n=prob.eta_n, eta_s=prob.eta_s,
                       problem=prob.problem, device=args.device)
    print(f"apply: n={prob.n} "
          f"L1={rep['l1']:.6e} L2={rep['l2']:.6e} max={rep['max']:.6e}")
    return 0


def _solve_sharded(args: argparse.Namespace, prob: cfg.ProblemConfig,
                   sol: cfg.SolverConfig) -> int:
    """`solve --sharded`: every rank solves its band; rank 0 prints. The
    process group is closed on the way out."""
    import torch.distributed as dist

    from mpbp_tpu_torch.drivers import solve_multiphase_sharded
    from mpbp_tpu_torch.utils.metrics import Timer

    mesh = cfg.dataclass_from_args(cfg.MeshConfig, args)
    try:
        with Timer() as t_all:
            rep = solve_multiphase_sharded(
                n=prob.n, c=prob.c, d=prob.d, xi=prob.xi, eta_n=prob.eta_n,
                eta_s=prob.eta_s, problem=prob.problem, pc=args.sharded_pc,
                tol=sol.tol, maxiter=sol.maxiter,
                precision="hybrid" if sol.precision == "hybrid" else "f64",
                restart=args.restart, inner_tol=sol.inner_tol,
                inner_iters=sol.inner_iters,
                n_devices=mesh.n_devices or None, device=sol.device,
                axis=mesh.axis)
        if dist.get_rank() == 0:
            print(f"solve (sharded over {rep.params['devices']} devices): "
                  f"n={rep.n} pc={rep.pc} iters={rep.iters} "
                  f"relres={rep.relres:.3e} "
                  f"true_relres={rep.params['true_relres']:.3e} "
                  f"converged={rep.converged} "
                  f"seconds={t_all.elapsed:.3f}")
            print(f"error norms vs MMS exact: "
                  f"L1={rep.error_norms['l1']:.6e} "
                  f"L2={rep.error_norms['l2']:.6e} "
                  f"max={rep.error_norms['max']:.6e}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0 if rep.converged else 2


def _eigs(args: argparse.Namespace, prob: cfg.ProblemConfig) -> int:
    """The `eigs` command: with --report a spectrum_report JSON (and
    --plot its figure), else the Arnoldi spectra of A and of A*M^-1."""
    from mpbp_tpu_torch import drivers
    from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
    from mpbp_tpu_torch.solvers import eigen

    sol = cfg.dataclass_from_args(cfg.SolverConfig, args)
    if args.report:
        pcs = ([p for p in args.pcs.split(",") if p] if args.pcs
               else ([sol.pc] if sol.pc != "none"
                     else ["exact_schur", "lsc_ilut"]))
        rep = drivers.spectrum_report(
            n=prob.n, c=prob.c, d=prob.d, xi=prob.xi, eta_n=prob.eta_n,
            eta_s=prob.eta_s, pcs=pcs, k=args.k, exact=args.exact or None,
            ilut_fill=sol.ilut_fill, ilut_tau=sol.ilut_tau,
            device=sol.device)
        with open(args.report, "w") as f:
            json.dump(rep, f, indent=1)
        for kind, spec in rep["preconditioned"].items():
            print(f"pc={kind}: clustering radius around 1 = "
                  f"{spec['clustering_radius_1']:.3g} "
                  f"(n_converged={spec['n_converged']})")
        print("wrote", args.report)
        if args.plot:
            from mpbp_tpu_torch.utils.plots import render_spectrum_report
            print("wrote", render_spectrum_report(rep, args.plot))
        return 0

    op = make_multiphase_operator(
        prob.n, c=prob.c, d=prob.d, xi=prob.xi, eta_n=prob.eta_n,
        eta_s=prob.eta_s, device=sol.device)
    mv = drivers.a_matvec(op)
    ex = torch.ones(5 * prob.n * prob.n, dtype=torch.float64,
                    device=op.grid.device)
    res = eigen.eigs(mv, ex, k=args.k, tol=1e-4, maxiter=40)
    print("eigenvalues of A (largest |.|):")
    for ev in res.eigenvalues[: res.n_converged]:
        print(f"  {ev:.6g}")
    if sol.pc != "none":
        pc = drivers.make_preconditioner(op, sol.pc, ilut_fill=sol.ilut_fill,
                                         ilut_tau=sol.ilut_tau)
        pres = eigen.preconditioned_spectrum(mv, pc, ex, k=args.k, tol=1e-4,
                                             maxiter=40)
        print(f"eigenvalues of A*M^-1 (pc={sol.pc}):")
        for ev in pres.eigenvalues[: pres.n_converged]:
            print(f"  {ev:.6g}")
        print(f"clustering radius around 1: {pres.clustering(1.0):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
