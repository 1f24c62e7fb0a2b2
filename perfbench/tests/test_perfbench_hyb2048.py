"""The 2048^2 cell end to end on the CPU at n=16 (the kernels' plain
paths): a sound run is correct, traced and untraced, and reports no
device metric here (the outer FGMRES's trace reads nothing without a
card); a solve stopped at 1e-6 fails the check."""

import time

import pytest

from perfbench import run
from perfbench.harness import krylov_trace, roofline, spec, system

CELL = "hyb2048.fixed_theta"
HOST_ONLY = {"solve_s", "solve_p95_s", "setup_s", "krylov.outer_iters.solve"}


def _run(cell, cpu, traced=False, seed=2**33 + 19):
    return run.run(cell, seed, 0.0, traced, cpu, time.perf_counter())


def test_the_cell_is_the_2048_deployment():
    cell = spec.load_cell(CELL)
    cfg = cell.config
    assert cfg["n"] == 2048 and cfg["reduced"] == []
    assert cfg["restart"] == 15 and cfg["maxiter"] >= 1.25 * 279
    assert cfg["limit_relres"] == 3 * cfg["tol"] == 3e-10
    assert cell.params == {"check_share": 0.1, "trace_steps": 1}
    assert cell.traffic == spec.load_cell("hyb1024.fixed_theta").traffic
    names = {m["name"] for m in cell.end_to_end}
    assert {"solve_s", "peak_gb", "setup_s"} <= names
    assert {m["name"] for m in cell.per_layer} >= {
        "krylov.orthog_ms", "krylov.orthog_roofline",
        "memory.krylov_basis_gb", "kernel.f_sweep_roofline"}


def test_projection_bytes_count_every_pass_of_cgs2():
    """(4 (s + 1) + 16) vectors a projection: the basis rows four times,
    w and its temporaries 16 times."""
    row = 5 * 2048 * 2048 * 8
    for rows in (1, 15):
        assert krylov_trace._least_s(rows, row) * roofline.HBM_BYTES_PER_S \
            == pytest.approx((4 * rows + 16) * row)


@pytest.mark.parametrize("traced", (False, True))
def test_run_is_correct(tiny_cell, cpu, traced):
    cell = tiny_cell(CELL)
    out, ctx = _run(cell, cpu, traced)
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] == 2
    assert out["checks"]["relres_max"]["value"] < \
        out["checks"]["relres_max"]["limit"] == 3e-10
    want = cell.per_layer if traced else cell.end_to_end
    # no device metric is read on the CPU, the new readers' included
    assert set(out["metrics"]) == {m["name"] for m in want} & HOST_ONLY
    assert krylov_trace.read(ctx) is None


def test_early_stop_fails(tiny_cell, cpu, monkeypatch):
    """A solve that stops at 1e-6 and flags itself converged."""
    solve = system.solve

    def early(config, solver, b, spans):
        res = solve(dict(config, tol=1e-6), solver, b, spans)
        assert res.converged
        return res

    monkeypatch.setattr(system, "solve", early)
    out, _ = _run(tiny_cell(CELL), cpu)
    assert out["checks"]["unconverged"]["value"] == 0
    assert out["correct"] is False
    assert out["checks"]["relres_max"]["value"] > \
        out["checks"]["relres_max"]["limit"]

