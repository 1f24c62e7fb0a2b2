"""Command-line drivers, as `python -m mpbp_tpu_torch <cmd>` (port of the
`solve` and `apply` commands of `mpbp_tpu/cli.py`).

Commands:
  solve   - assemble and FGMRES-solve the MMS multiphase system on
            --device, print a structured report
  apply   - apply A to the exact MMS solution, print error norms
"""

from __future__ import annotations

import argparse
import sys
import time

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
                         help="recompute the TRUE residual every iteration "
                              "(not ported yet: raises)")
    p_solve.add_argument("--restart", type=int, default=None,
                         help="restarted outer cycles (bounds the Krylov "
                              "basis memory)")

    p_apply = sub.add_parser("apply", help="operator-apply MMS check")
    cfg.add_dataclass_args(p_apply, cfg.ProblemConfig)
    p_apply.add_argument("--device", default="cuda",
                         help="torch device to assemble and apply on")

    args = parser.parse_args(argv)
    prob = cfg.dataclass_from_args(cfg.ProblemConfig, args)

    if args.cmd == "solve":
        from mpbp_tpu_torch.drivers import solve_multiphase

        sol = cfg.dataclass_from_args(cfg.SolverConfig, args)
        if sol.dtype not in _DTYPES:
            parser.error(f"--dtype must be one of {sorted(_DTYPES)}")
        t0 = time.perf_counter()
        rep = solve_multiphase(
            n=prob.n, c=prob.c, d=prob.d, xi=prob.xi, eta_n=prob.eta_n,
            eta_s=prob.eta_s, problem=prob.problem, pc=sol.pc,
            tol=sol.tol, maxiter=sol.maxiter, dtype=_DTYPES[sol.dtype],
            ilut_fill=sol.ilut_fill, ilut_tau=sol.ilut_tau,
            ilut_refine=sol.ilut_refine, inner_tol=sol.inner_tol,
            inner_iters=sol.inner_iters, precision=sol.precision,
            restart=args.restart, true_res_monitor=args.true_res_monitor,
            device=sol.device)
        elapsed = time.perf_counter() - t0
        print(f"solve: n={rep.n} pc={rep.pc} precision={sol.precision} "
              f"device={sol.device} iters={rep.iters} "
              f"relres={rep.relres:.3e} "
              f"true_relres={rep.params['true_relres']:.3e} "
              f"converged={rep.converged} seconds={elapsed:.3f}")
        print(f"error norms vs MMS exact: "
              f"L1={rep.error_norms['l1']:.6e} "
              f"L2={rep.error_norms['l2']:.6e} "
              f"max={rep.error_norms['max']:.6e}")
        print("residual history:",
              " ".join(f"{r:.3e}" for r in rep.res_history[:10]),
              "..." if len(rep.res_history) > 10 else "")
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
