"""Config dataclasses and their CLI binding (port of
`mpbp_tpu/utils/config.py`)."""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class ProblemConfig:
    """Physical and discretization parameters."""

    n: int = 16
    c: float = 1.0
    d: float = -1.0
    xi: float = 1.0
    eta_n: float = 100.0
    eta_s: float = 1.0
    problem: str = "variable"      # "variable" | "constant" theta_n MMS


@dataclasses.dataclass
class SolverConfig:
    """Krylov and preconditioner settings. `device` names the torch device
    the solve runs on; the kernels are chosen by it."""

    pc: str = "lsc_ilut"
    tol: float = 1e-8
    maxiter: int = 150
    ilut_fill: int = 400
    ilut_tau: float = 3e-5
    ilut_refine: int = 0
    inner_tol: float = 1e-4
    inner_iters: int = 60
    dtype: str = "float64"
    precision: str = "full"        # full | ir | hybrid
    device: str = "cuda"


def add_dataclass_args(parser: argparse.ArgumentParser, dc):
    for f in dataclasses.fields(dc):
        parser.add_argument(f"--{f.name.replace('_', '-')}",
                            type=type(f.default), default=f.default)


def dataclass_from_args(cls, args: argparse.Namespace):
    return cls(**{f.name: getattr(args, f.name)
                  for f in dataclasses.fields(cls)})
