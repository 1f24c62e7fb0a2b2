"""Command-line drivers, as `python -m mpbp_tpu_torch <cmd>` (port of
`mpbp_tpu/cli.py`).

Commands:
  solve   - assemble and FGMRES-solve the MMS multiphase system on
            --device (precision full, hybrid or ir), print a structured
            report; --metrics-json writes a SolveMetrics record
  apply   - apply A to the exact MMS solution, print error norms
  eigs, export, solve --sharded - not ported yet: they raise
            NotImplementedError naming their ROADMAP.md item
"""

from __future__ import annotations

import argparse
import sys

import torch

from mpbp_tpu_torch.utils import config as cfg

_DTYPES = {"float64": torch.float64, "float32": torch.float32}

# commands and options of the JAX CLI that this port does not have yet
_NOT_PORTED = {
    "eigs": "queue 1 item 11 (solvers/eigen.py)",
    "export": "queue 1 item 11 (utils/csv_export.py)",
    "--sharded": "queue 1 item 13 (parallel/)",
}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what!r} is not ported to mpbp_tpu_torch yet: ROADMAP.md "
        f"{_NOT_PORTED[what]}")


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
    p_solve.add_argument("--sharded", action="store_true",
                         help="row-shard the solve over several devices "
                              "(not ported yet: raises)")

    p_apply = sub.add_parser("apply", help="operator-apply MMS check")
    cfg.add_dataclass_args(p_apply, cfg.ProblemConfig)
    p_apply.add_argument("--device", default="cuda",
                         help="torch device to assemble and apply on")

    for cmd, what in (("eigs", "spectral analysis of A and A*M^-1"),
                      ("export", "CSV dump of block matrices")):
        p = sub.add_parser(cmd, help=f"{what} (not ported yet: raises)")
        cfg.add_dataclass_args(p, cfg.ProblemConfig)

    args = parser.parse_args(argv)
    if args.cmd in ("eigs", "export"):
        raise _not_ported(args.cmd)
    prob = cfg.dataclass_from_args(cfg.ProblemConfig, args)

    if args.cmd == "solve":
        from mpbp_tpu_torch.drivers import solve_multiphase
        from mpbp_tpu_torch.utils.metrics import Timer, collect_solve_metrics

        if args.sharded:
            raise _not_ported("--sharded")
        sol = cfg.dataclass_from_args(cfg.SolverConfig, args)
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
        return 0 if rep.converged else 2

    from mpbp_tpu_torch.drivers import apply_report

    rep = apply_report(n=prob.n, c=prob.c, d=prob.d, xi=prob.xi,
                       eta_n=prob.eta_n, eta_s=prob.eta_s,
                       problem=prob.problem, device=args.device)
    print(f"apply: n={prob.n} "
          f"L1={rep['l1']:.6e} L2={rep['l2']:.6e} max={rep['max']:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
