"""The harness end to end on the CPU at n=16 (the kernels' plain paths):
a sound run is correct, and each fault a solve cell can have makes it not
correct."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import control, run
from perfbench.harness import spec, system
from perfbench.tests.conftest import CELLS

ROOT = spec.ROOT


def _run(cell, cpu, traced=False, seed=2**33 + 5):
    return run.run(cell, seed, 0.0, traced, cpu, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", (False, True))
def test_run_is_correct(tiny_cell, cpu, name, traced):
    cell = tiny_cell(name)
    out, _ = _run(cell, cpu, traced)
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] == 2
    assert list(out)[-1] == "checks"
    assert out["checks"]["relres_max"]["value"] < \
        out["checks"]["relres_max"]["limit"] == cell.config["limit_relres"]
    want = cell.per_layer if traced else cell.end_to_end
    host_only = {"solve_s", "solve_p95_s", "step_s", "solve_p95_s.step",
                 "setup_s", "krylov.outer_iters.solve",
                 "krylov.outer_iters.step", "setup.rebuild_s"}
    # no device metric is read on the CPU
    assert set(out["metrics"]) == {m["name"] for m in want} & host_only
    for m in out["metrics"].values():
        assert m["value"] > 0
    json.dumps(out, allow_nan=False)


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def _unchanged(config, solver, b, spans):
    """A solve that returns its starting state."""
    res = _solve(config, solver, b, spans)
    return res._replace(x=torch.zeros_like(res.x))


def _altered(config, solver, b, spans):
    """A solve whose answer is altered where it is produced."""
    res = _solve(config, solver, b, spans)
    x = res.x.clone()
    x[x.numel() // 3] += 1e-3 * x.abs().max()
    return res._replace(x=x)


_solve = system.solve


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", (_unchanged, _altered))
def test_faults_fail(tiny_cell, cpu, monkeypatch, name, fault):
    monkeypatch.setattr(system, "solve", fault)
    out, _ = _run(tiny_cell(name), cpu)
    assert out["correct"] is False
    assert out["checks"]["relres_max"]["value"] > \
        out["checks"]["relres_max"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_early_stop_fails(tiny_cell, cpu, monkeypatch, name):
    """A solve that stops at 1e-6, far short of the configuration's tol,
    and flags itself converged: the program's own flag passes it, the
    reference does not."""
    def early(config, solver, b, spans):
        res = _solve(dict(config, tol=1e-6), solver, b, spans)
        assert res.converged
        return res

    monkeypatch.setattr(system, "solve", early)
    out, _ = _run(tiny_cell(name), cpu)
    assert out["checks"]["unconverged"]["value"] == 0
    assert out["correct"] is False
    assert out["checks"]["relres_max"]["value"] > \
        out["checks"]["relres_max"]["limit"]


def test_stale_operator_fails(tiny_cell, cpu, monkeypatch):
    """A step that keeps the last step's operator instead of its own."""
    build = system.build
    kept = {}

    def stale(config, theta, device, spans):
        if "solver" not in kept:
            kept["solver"] = build(config, theta, device, spans)
        return kept["solver"]

    monkeypatch.setattr(system, "build", stale)
    cell = tiny_cell(CELLS[1], loads=3)
    cell.params["check_share"] = 1.0
    out, _ = _run(cell, cpu)
    assert out["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(tiny_cell, cpu, name):
    """The control (every part in float32) reads above the limit, the
    program below it, at n=16 (the control's reading grows with n: 2.3e-6
    to 2.7e-6 here, 3e-2 at the cells' 1024)."""
    cell = tiny_cell(name)
    limit = float(cell.config["limit_relres"])
    sound = control.readings(cell, [7], 1, "hybrid", cpu, log=lambda s: None)
    ctrl = control.readings(cell, [7], 1, "f32", cpu, log=lambda s: None)
    assert sound[0]["relres_max"] < limit < ctrl[0]["relres_max"]


@pytest.mark.gpu
def test_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
