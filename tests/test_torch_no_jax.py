"""The port runs without JAX: importing its entry points (the drivers, the
CLI, the two benchmarks, every ops module, the
mixed-precision solver and the eigensolver, the Stokes model, the
checkpoint, plot, CSV and metrics utilities, every module of `parallel/`
and `chip_smoke.py`) in a
fresh interpreter where
`import jax` fails loads no JAX module, and no module of the JAX package
`mpbp_tpu` either, not even one that does not import JAX: the port keeps
its own copy of the host setup library (`mpbp_tpu_torch/native`)."""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = """
import json, sys
sys.modules["jax"] = None      # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import chip_smoke
import mpbp_tpu_torch.bench
import mpbp_tpu_torch.bench_solve
import mpbp_tpu_torch.cli
import mpbp_tpu_torch.drivers
from mpbp_tpu_torch import native
from mpbp_tpu_torch.ops import (cuda_dia, cuda_ell, cuda_stencil, dia,
                                dispatch, ilu, sparse, spgemm, stencil,
                                trisolve)
from mpbp_tpu_torch.models import stokes
from mpbp_tpu_torch.parallel import (block_ilu, distributed, halo,
                                     pallas_sharded, sharded_dia, sharding)
from mpbp_tpu_torch.solvers import eigen, mixed
from mpbp_tpu_torch.utils import checkpoint, csv_export, metrics, plots
print(json.dumps({
    "jax": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib")
                  and sys.modules[m] is not None),
    "jax_package": sorted(m for m in sys.modules
                          if m.split(".")[0] == "mpbp_tpu")}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded["jax"] == []
    assert loaded["jax_package"] == []
