"""The port's end-to-end MMS solves and CLI against the JAX package at n=16:
the lsc_mg_full slice in full f64 and hybrid precision, the lsc_krylov
and lsc_mg_krylov kinds, and the ILU and block kinds (lsc_ilut with level
and Neumann triangular solves, lsc_ilu0, lsc_mg, block_diag, block_tri);
the CLI's solve, apply, eigs and export, and the config's JSON."""

import json
import os

import numpy as np
import pytest
import torch

from mpbp_tpu.drivers import solve_multiphase as jax_solve
from mpbp_tpu_torch import cli
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_operator
from mpbp_tpu.utils.csv_export import write_blocks_to_csv
from mpbp_tpu_torch.drivers import (make_preconditioner,
                                    make_preconditioner_mixed,
                                    solve_multiphase)
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.utils import checkpoint as ckpt
from mpbp_tpu_torch.utils import config as cfg

torch.set_num_threads(1)

KW = dict(n=16, eta_n=100.0, tol=1e-8, maxiter=100, inner_tol=1e-4,
          inner_iters=40)


def test_lsc_mg_full_full_precision_matches_jax():
    got = solve_multiphase(pc="lsc_mg_full", precision="full", **KW,
                           device="cpu")
    want = jax_solve(pc="lsc_mg_full", precision="full", **KW)
    assert got.converged and got.status == "converged"
    assert got.iters == want.iters
    assert got.error_norms["l2"] == pytest.approx(want.error_norms["l2"],
                                                  rel=1e-6)
    assert got.params["true_relres"] <= 10 * KW["tol"]
    assert got.x.dtype == torch.float64 and got.x.shape == (5 * 16 * 16,)


def test_lsc_mg_full_hybrid_matches_jax():
    got = solve_multiphase(pc="lsc_mg_full", precision="hybrid", **KW,
                           device="cpu")
    want = jax_solve(pc="lsc_mg_full", precision="hybrid", **KW)
    assert got.converged
    assert abs(got.iters - want.iters) <= 1
    assert got.error_norms["l2"] == pytest.approx(want.error_norms["l2"],
                                                  rel=1e-4)
    assert got.params["true_relres"] <= 10 * KW["tol"]
    # a repeated solve reuses the memoized setup and gives the same answer
    again = solve_multiphase(pc="lsc_mg_full", precision="hybrid", **KW,
                             device="cpu")
    assert again.iters == got.iters
    np.testing.assert_array_equal(again.res_history, got.res_history)


def test_lsc_krylov_matches_jax():
    got = solve_multiphase(pc="lsc_krylov", **KW, device="cpu")
    want = jax_solve(pc="lsc_krylov", **KW)
    assert got.converged and got.iters == want.iters
    np.testing.assert_allclose(got.res_history, want.res_history,
                               rtol=1e-6)
    assert got.error_norms["l2"] == pytest.approx(want.error_norms["l2"],
                                                  rel=1e-6)


# (kind, eta_n, iterations the JAX package takes): lsc_ilut's 45 and 74
# are README.md's; ILU(0) stalls at contrast 100, so it and the block PCs
# run at equal viscosities, as tests/test_solver_parity.py runs block_tri
ILU_KINDS = [
    ("lsc_ilut", {}, 100.0, 45),
    ("lsc_ilut", {"ilut_apply": "neumann"}, 100.0, 74),
    ("lsc_mg", {}, 100.0, 44),
    ("lsc_ilu0", {}, 1.0, 150),
    ("block_diag", {}, 1.0, 43),
    ("block_tri", {}, 1.0, 39),
]


@pytest.mark.parametrize("kind,extra,eta_n,iters", ILU_KINDS)
def test_ilu_and_block_kinds_match_jax(kind, extra, eta_n, iters):
    """Full f64 at n=16: the same count and status as the JAX package (ILU
    factors are equal, from the same native library on bit-identical
    CSR), residual history within rtol 1e-6 and L2 within 1e-6."""
    kw = dict(n=16, eta_n=eta_n, pc=kind, tol=1e-8, maxiter=150, **extra)
    got = solve_multiphase(**kw, device="cpu")
    want = jax_solve(**kw)
    assert int(want.iters) == iters
    assert got.iters == iters and got.status == want.status
    assert got.converged == (want.status == "converged")
    np.testing.assert_allclose(got.res_history, want.res_history, rtol=1e-6)
    assert got.error_norms["l2"] == pytest.approx(want.error_norms["l2"],
                                                  rel=1e-6)


def test_lsc_ilut_neumann_hybrid_matches_jax():
    """Hybrid precision runs the Neumann sweeps in f32. Its outer count is
    sensitive to f32 rounding alone. With the sweep's sum over slots taken
    in other orders (same seed, CPU, one thread) the port took: 61 (the
    plain version's reduction), 57 (row-major), 72 (slot by slot, the CUDA
    kernel's order), 57 (f64 accumulation); the JAX package takes 64
    (ROADMAP.md queue 3). So the count is held to that band, and the
    answer to the JAX package's L2 and to the outer tolerance."""
    kw = dict(n=16, eta_n=100.0, pc="lsc_ilut", ilut_apply="neumann",
              precision="hybrid", tol=1e-8, maxiter=150)
    got = solve_multiphase(**kw, device="cpu")
    want = jax_solve(**kw)
    assert got.converged and want.status == "converged"
    assert abs(got.iters - int(want.iters)) <= 8
    assert got.params["true_relres"] <= kw["tol"]
    assert got.error_norms["l2"] == pytest.approx(want.error_norms["l2"],
                                                  rel=1e-3)


def test_cli_default_solve_runs_lsc_ilut(capsys):
    """No --pc: the CLI's default kind, lsc_ilut, as the JAX CLI runs it."""
    assert cli.main(["solve", "--n", "16", "--eta-n", "100",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "pc=lsc_ilut" in out and "iters=45" in out
    assert "converged=True" in out and "L2=2.2719" in out


MGK = dict(eta_n=100.0, eta_s=1.0, pc="lsc_mg_krylov", tol=1e-8,
           maxiter=60, inner_tol=1e-5, inner_iters=60)


@pytest.mark.parametrize("n", [16, 32])
def test_lsc_mg_krylov_matches_jax(n):
    """Stiff, full f64: converged within 2 iterations of the JAX package's
    count (17 at both n) and at most 25, L2 within 1% of JAX's."""
    got = solve_multiphase(n=n, **MGK, device="cpu")
    want = jax_solve(n=n, **MGK)
    assert got.converged and got.iters <= 25
    assert abs(got.iters - want.iters) <= 2, (got.iters, want.iters)
    assert got.error_norms["l2"] == pytest.approx(want.error_norms["l2"],
                                                  rel=1e-2)
    assert got.params["true_relres"] <= 10 * MGK["tol"]


def test_lsc_mg_krylov_hybrid_converges():
    """Hybrid precision through make_preconditioner_mixed at n=16: converged
    with the true relres at most tol, L2 within 1% of the f64 solve's."""
    got = solve_multiphase(n=16, **MGK, precision="hybrid", device="cpu")
    want = jax_solve(n=16, **MGK)
    assert got.converged and got.params["true_relres"] <= MGK["tol"]
    assert got.error_norms["l2"] == pytest.approx(want.error_norms["l2"],
                                                  rel=1e-2)


def test_unported_modes_raise_and_bad_names_are_rejected():
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 1 item 13"):
        cli.main(["solve", "--sharded", "--n", "8", "--device", "cpu"])
    with pytest.raises(ValueError, match="restart"):
        solve_multiphase(n=8, pc="lsc_mg_full", true_res_monitor=True,
                         restart=5, device="cpu")
    with pytest.raises(ValueError):
        solve_multiphase(n=8, pc="lsc_mg_full", precision="bf16",
                         device="cpu")
    op = make_multiphase_operator(8, device="cpu")
    with pytest.raises(ValueError):
        make_preconditioner(op, "no_such_pc")
    with pytest.raises(ValueError):
        make_preconditioner_mixed(op, op, "none")


def test_cli_solve_and_apply(capsys):
    assert cli.main(["solve", "--n", "16", "--device", "cpu",
                     "--pc", "lsc_mg_full", "--precision", "hybrid",
                     "--tol", "1e-8", "--maxiter", "40",
                     "--inner-iters", "40"]) == 0
    out = capsys.readouterr().out
    assert "converged=True" in out and "device=cpu" in out
    assert cli.main(["apply", "--n", "8", "--eta-n", "1",
                     "--device", "cpu"]) == 0
    assert "L2=4.736938e+00" in capsys.readouterr().out


def test_cli_ir_monitor_and_metrics_json(capsys, tmp_path):
    path = tmp_path / "metrics.json"
    assert cli.main(["solve", "--n", "16", "--device", "cpu",
                     "--pc", "lsc_mg_full", "--precision", "ir",
                     "--maxiter", "100", "--inner-iters", "40",
                     "--metrics-json", str(path)]) == 0
    out = capsys.readouterr().out
    assert "precision=ir" in out and "converged=True" in out
    assert "L2=2.2709" in out
    rec = json.loads(path.read_text())
    assert rec["converged"] and rec["n"] == 16 and rec["iters"] > 0
    assert rec["nnz"] == 11 * 5 * 16 * 16 and rec["res_history"][0] == 1.0
    assert cli.main(["solve", "--n", "16", "--device", "cpu",
                     "--pc", "lsc_ilut", "--true-res-monitor"]) == 0
    out = capsys.readouterr().out
    assert "iters=45" in out and "true residual history:" in out


def test_vector_layout_helpers_match_jax():
    import jax.numpy as jnp

    from mpbp_tpu.drivers import unpack_fields as jax_unpack
    from mpbp_tpu.models.multiphase import \
        make_multiphase_operator as jax_make_operator
    from mpbp_tpu.solvers import preconditioners as jax_pcs
    from mpbp_tpu_torch.drivers import pack_fields, unpack_fields
    from mpbp_tpu_torch.solvers import preconditioners as pcs

    n = 8
    top = make_multiphase_operator(n, device="cpu")
    jop = jax_make_operator(n)
    v = np.random.default_rng(9).normal(size=5 * n * n)
    tv, jv = torch.as_tensor(v), jnp.asarray(v)
    fields = unpack_fields(top, tv)
    for f, want in jax_unpack(jop, jv).items():
        np.testing.assert_array_equal(fields[f].numpy(), np.asarray(want))
    torch.testing.assert_close(pack_fields(top, fields), tv, rtol=0, atol=0)
    vu, vp = pcs.split_uv_p(top, tv)
    assert vu.shape == (4 * n * n,) and vp.shape == (n * n,)
    torch.testing.assert_close(pcs.pack_vel(top, pcs.unpack_vel(top, vu)),
                               vu, rtol=0, atol=0)
    np.testing.assert_allclose(pcs.project_pressure_mean(top, tv).numpy(),
                               np.asarray(jax_pcs.project_pressure_mean(
                                   jop, jv)), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("d", [-1.0, 0.5])
def test_mass_schur_inner_matches_jax(d):
    import jax.numpy as jnp

    from mpbp_tpu.models.multiphase import \
        make_multiphase_operator as jax_make_operator
    from mpbp_tpu.solvers import preconditioners as jax_pcs
    from mpbp_tpu_torch.solvers import preconditioners as pcs

    kw = dict(c=1.0, d=d, xi=1.0, eta_n=100.0, eta_s=1.0)
    top = make_multiphase_operator(8, **kw, device="cpu")
    jop = jax_make_operator(8, **kw)
    v = np.random.default_rng(10).normal(size=64)
    got = pcs.make_mass_schur_inner(top)(torch.as_tensor(v))
    want = np.asarray(jax_pcs.make_mass_schur_inner(jop)(jnp.asarray(v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0)


def test_pressure_projected_block_pc_matches_jax():
    """wrap_with_pressure_projection around a block-diagonal PC with the
    mass Schur inner (and an identity F inner): equal to the JAX package's,
    and the pressure part of the output has zero mean."""
    import jax.numpy as jnp

    from mpbp_tpu.models.multiphase import \
        make_multiphase_operator as jax_make_operator
    from mpbp_tpu.solvers import preconditioners as jax_pcs
    from mpbp_tpu_torch.solvers import preconditioners as pcs

    n = 8
    top = make_multiphase_operator(n, eta_n=100.0, device="cpu")
    jop = jax_make_operator(n, eta_n=100.0)
    v = np.random.default_rng(11).normal(size=5 * n * n)
    M = pcs.wrap_with_pressure_projection(top, pcs.make_block_diagonal_pc(
        top, lambda x: 2.0 * x, pcs.make_mass_schur_inner(top)))
    jM = jax_pcs.wrap_with_pressure_projection(
        jop, jax_pcs.make_block_diagonal_pc(
            jop, lambda x: 2.0 * x, jax_pcs.make_mass_schur_inner(jop)))
    got = M(torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(jM(jnp.asarray(v))),
                               rtol=1e-13, atol=1e-13)
    assert abs(float(got[4 * n * n:].mean())) < 1e-14


def test_unhashable_pc_kwargs_skip_the_setup_memo():
    """A list-valued pc_kwargs entry cannot key the setup memo: the solve
    runs unmemoized (the JAX package's guard) and takes the same iterations
    as the memoized solve with the same value as an int."""
    from mpbp_tpu_torch import drivers

    kw = dict(n=8, eta_n=100.0, pc="lsc_mg_full", tol=1e-8, maxiter=50,
              device="cpu")
    drivers._SETUP_CACHE.clear()
    got = solve_multiphase(**kw, ilut_fill=[400])
    assert not drivers._SETUP_CACHE
    want = solve_multiphase(**kw, ilut_fill=400)
    assert len(drivers._SETUP_CACHE) == 1
    assert got.converged and got.iters == want.iters
    assert got.error_norms["l2"] == want.error_norms["l2"]
    drivers._SETUP_CACHE.clear()


def test_config_json_roundtrip():
    """to_json/from_json round trip of the three configs, MeshConfig
    included; the ProblemConfig and MeshConfig JSON read in the JAX
    package's from_json."""
    from mpbp_tpu.utils import config as jax_cfg

    p = cfg.ProblemConfig(n=32, eta_n=7.0)
    s = cfg.SolverConfig(pc="block_tri", tol=1e-6, device="cpu")
    m = cfg.MeshConfig(n_devices=4)
    assert cfg.from_json(cfg.to_json(p, s, m)) == (p, s, m)
    jp, jm = jax_cfg.from_json(cfg.to_json(p, m))
    assert (jp.n, jp.eta_n, jm.n_devices, jm.axis) == (32, 7.0, 4, "x")


def test_cli_eigs_prints_converged_values(capsys):
    assert cli.main(["eigs", "--n", "8", "--pc", "exact_schur", "--k", "4",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    a_part, pc_part = out.split("eigenvalues of A*M^-1 (pc=exact_schur):")
    assert len(a_part.splitlines()) >= 2       # header + a converged value
    assert len(pc_part.splitlines()) >= 2
    assert "clustering radius around 1:" in out


def test_cli_eigs_report_and_plot(capsys, tmp_path):
    """--report writes the spectrum JSON, --plot its figure (matplotlib)."""
    rpath, ppath = tmp_path / "spec.json", tmp_path / "spec.png"
    assert cli.main(["eigs", "--n", "6", "--eta-n", "1", "--pcs",
                     "exact_schur", "--exact", "--device", "cpu", "--report",
                     str(rpath), "--plot", str(ppath)]) == 0
    rep = json.loads(rpath.read_text())
    es = rep["preconditioned"]["exact_schur"]
    assert rep["method"] == "dense" and es["n_nullspace"] == 1
    assert ppath.stat().st_size > 0
    assert "pc=exact_schur: clustering radius" in capsys.readouterr().out


def test_cli_export_matches_jax_csv(tmp_path):
    """export --n 8 writes L, D, XI, G_matrix.csv, equal under np.loadtxt
    to the JAX package's write_blocks_to_csv files."""
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    assert cli.main(["export", "--n", "8", "--outdir", str(mine),
                     "--device", "cpu"]) == 0
    write_blocks_to_csv(jax_operator(8, eta_n=100.0), str(theirs))
    for name in ("L", "D", "XI", "G"):
        f = f"{name}_matrix.csv"
        got = np.loadtxt(os.path.join(mine, f), delimiter=",")
        want = np.loadtxt(os.path.join(theirs, f), delimiter=",")
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_cli_solve_checkpoint(tmp_path, capsys):
    """solve --checkpoint writes a Krylov state the loader reads back."""
    path = tmp_path / "sol.npz"
    assert cli.main(["solve", "--n", "8", "--eta-n", "1", "--pc",
                     "exact_schur", "--device", "cpu", "--checkpoint",
                     str(path)]) == 0
    x, hist, iters, meta = ckpt.load_krylov_state(str(path), device="cpu")
    assert x.shape == (5 * 64,) and bool(torch.isfinite(x).all())
    assert iters == len(hist) - 1 and meta["device"] == "cpu"
    assert "converged=True" in capsys.readouterr().out
