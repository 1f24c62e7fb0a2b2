"""Config dataclasses, their CLI binding and their JSON form (port of
`mpbp_tpu/utils/config.py`)."""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any


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


@dataclasses.dataclass
class MeshConfig:
    """Device-mesh layout for the sharded paths."""

    n_devices: int = 0             # 0 = all available
    axis: str = "x"


def add_dataclass_args(parser: argparse.ArgumentParser, dc,
                       prefix: str = ""):
    """One option `--{prefix}{name-with-dashes}` per field of `dc`, typed
    and defaulted by the field's default. The prefix is kept as given, and
    `dataclass_from_args` reads attribute `{prefix}{name}` back, so a
    prefix that should read back spells its separators as underscores
    ("pc_" registers --pc_inner-tol); a dash in it does not read back
    (AttributeError), as in the JAX package."""
    for f in dataclasses.fields(dc):
        parser.add_argument(f"--{prefix}{f.name.replace('_', '-')}",
                            type=type(f.default), default=f.default)


def dataclass_from_args(cls, args: argparse.Namespace, prefix: str = ""):
    """`cls` from the options `add_dataclass_args(..., prefix)` added:
    attribute `{prefix}{name}` of `args` for each field."""
    return cls(**{f.name: getattr(args, f"{prefix}{f.name}")
                  for f in dataclasses.fields(cls)})


def to_json(*configs) -> str:
    """The configs as one JSON object keyed by class name."""
    out: dict[str, Any] = {}
    for c in configs:
        out[type(c).__name__] = dataclasses.asdict(c)
    return json.dumps(out, indent=2)


def from_json(s: str) -> tuple:
    """The configs of a `to_json` string, in its order; unknown keys are
    skipped."""
    data = json.loads(s)
    mapping = {"ProblemConfig": ProblemConfig, "SolverConfig": SolverConfig,
               "MeshConfig": MeshConfig}
    return tuple(mapping[k](**v) for k, v in data.items() if k in mapping)
