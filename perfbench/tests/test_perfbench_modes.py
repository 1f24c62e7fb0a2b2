"""Every option of the single-device solve that a configuration file can
state reaches the program, on the CPU at n=16 (the kernels' plain paths):
the cells' configurations call `fgmres` as they always did, `aug_k` runs
LGMRES restarts, `precision: "ir"` runs iterative refinement, and a
configuration that states an option the solve would drop is refused."""

import time

import numpy as np
import pytest
import torch

from mpbp_tpu_torch.solvers import gmres
from perfbench import run
from perfbench.harness import system, trace, traffic
from perfbench.tests.conftest import CELLS

ALL_CELLS = CELLS + ("hyb2048.fixed_theta",)
# the 1024^2 configuration as iterative refinement: the source row's tol
# (SOLVE_r05.json "1024 ir"), the driver's settings for maxiter 150
IR = dict(precision="ir", tol=1e-8, limit_relres=3e-8, maxiter=150,
          ir_max_outer=6, ir_inner_tol=1e-6, ir_inner_maxiter=150)
OFF = trace.Spans(False, torch.device("cpu"))


def _run(cell, cpu, traced=False, seed=2**33 + 23):
    return run.run(cell, seed, 0.0, traced, cpu, time.perf_counter())


def _cell(tiny_cell, name, **config):
    cell = tiny_cell(name)
    cell.config.update(config)
    return cell


@pytest.mark.parametrize("name", ALL_CELLS)
def test_cells_call_fgmres_as_before(tiny_cell, cpu, monkeypatch, name):
    """Each cell's configuration reaches `fgmres` with the arguments the
    harness passed before `aug_k` and ir: no `aug_k`, no other key."""
    cell = tiny_cell(name)
    cfg = cell.config
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return gmres.KrylovResult(args[1], 1, 0.0, np.zeros(2), True)

    theta = traffic.Traffic(cell.traffic, 16, cpu, 1).theta(0)
    solver = system.build(cfg, theta, cpu, OFF)
    monkeypatch.setattr(system.krylov, "fgmres", spy)
    b = torch.ones(5 * 16 * 16, dtype=torch.float64)
    system.solve(cfg, solver, b, OFF)
    (args, kwargs), = calls
    assert args[0] is solver.mv
    assert torch.equal(args[1], b.to(solver.dtype))
    assert kwargs == dict(tol=float(cfg["tol"]), maxiter=int(cfg["maxiter"]),
                          M=solver.M, restart=int(cfg["restart"]) or None)


@pytest.mark.parametrize("traced", (False, True))
def test_aug_k_runs_lgmres_restarts(tiny_cell, cpu, monkeypatch, traced):
    """aug_k 2 at restart 4: correct, and a later cycle gets the
    corrections of the cycles before it as its last flexible directions."""
    cycle, augs = gmres._cycle, []

    def spy(*args, **kwargs):
        augs.append(args[8] if len(args) > 8 else kwargs.get("aug"))
        return cycle(*args, **kwargs)

    monkeypatch.setattr(gmres, "_cycle", spy)
    cell = _cell(tiny_cell, "hyb2048.fixed_theta", restart=4, aug_k=2)
    out, _ = _run(cell, cpu, traced)
    assert out["correct"] is True and out["failed"] == 0
    assert augs[0] is None
    assert any(a is not None and a.shape[0] == 2 for a in augs[1:])


@pytest.mark.parametrize("restart", (0, 350, 400))
def test_aug_k_without_a_restarted_cycle_is_refused(tiny_cell, cpu, restart):
    """fgmres would run one plain cycle and drop aug_k: build refuses."""
    cell = _cell(tiny_cell, "hyb2048.fixed_theta", restart=restart, aug_k=2)
    with pytest.raises(ValueError, match="mp_hybrid_lsc_mg_full_2048"):
        system.build(cell.config, None, cpu, OFF)


def test_aug_k_with_ir_is_refused(tiny_cell, cpu):
    """fgmres_ir has no augmented restarts: build refuses."""
    cell = _cell(tiny_cell, CELLS[0], restart=4, aug_k=2, **IR)
    with pytest.raises(ValueError, match="aug_k"):
        system.build(cell.config, None, cpu, OFF)


def test_ir_runs_refinement(tiny_cell, cpu, monkeypatch):
    """precision ir: correct at its limit, an f64 answer, and `iters` the
    inner f32 iterations of every outer step together."""
    fgmres, solve = gmres.fgmres, system.solve
    inner, seen = [], []

    def spy_fgmres(*args, **kwargs):
        res = fgmres(*args, **kwargs)
        assert res.x.dtype == torch.float32
        inner[-1] += res.iters
        return res

    def spy_solve(config, solver, b, spans):
        inner.append(0)
        res = solve(config, solver, b, spans)
        seen.append(res)
        return res

    monkeypatch.setattr(gmres, "fgmres", spy_fgmres)
    monkeypatch.setattr(system, "solve", spy_solve)
    cell = _cell(tiny_cell, CELLS[0], **IR)
    out, ctx = _run(cell, cpu)
    assert out["correct"] is True and out["failed"] == 0
    relres = out["checks"]["relres_max"]
    assert relres["value"] < relres["limit"] == 3e-8
    assert all(r.x.dtype == torch.float64 for r in seen)
    assert [r.iters for r in seen] == inner
    assert [s["iters"] for s in ctx.solves] == inner[1:]     # the warm-up
    assert all(i > 0 for i in inner)


def test_ir_stopped_short_fails(tiny_cell, cpu):
    """One outer step of a loose inner solve falls short of tol: the check
    fails it."""
    cell = _cell(tiny_cell, CELLS[0], **dict(IR, ir_max_outer=1,
                                             ir_inner_tol=1e-3))
    out, _ = _run(cell, cpu)
    assert out["correct"] is False
    assert out["checks"]["relres_max"]["value"] > \
        out["checks"]["relres_max"]["limit"]


@pytest.mark.parametrize("key", system.IR_KEYS)
def test_ir_needs_its_keys(tiny_cell, cpu, key):
    cell = _cell(tiny_cell, CELLS[0], **IR)
    del cell.config[key]
    with pytest.raises(KeyError, match=key):
        system.build(cell.config, None, cpu, OFF)


def test_unknown_precision_is_refused(tiny_cell, cpu):
    cell = _cell(tiny_cell, CELLS[0], precision="f16")
    with pytest.raises(ValueError, match="f16"):
        system.build(cell.config, None, cpu, OFF)

