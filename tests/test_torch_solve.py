"""The port's end-to-end MMS solves and CLI against the JAX package at n=16,
eta_n=100: the lsc_mg_full slice in full f64 and hybrid precision, and the
lsc_krylov kind."""

import numpy as np
import pytest
import torch

from mpbp_tpu.drivers import solve_multiphase as jax_solve
from mpbp_tpu_torch import cli
from mpbp_tpu_torch.drivers import (make_preconditioner,
                                    make_preconditioner_mixed,
                                    solve_multiphase)
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator

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


@pytest.mark.parametrize("kind", ["lsc_ilut", "lsc_ilu0", "exact_schur",
                                  "block_diag", "lsc_mg_krylov"])
def test_unported_kinds_name_their_roadmap_item(kind):
    op = make_multiphase_operator(8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        make_preconditioner(op, kind)


def test_unported_modes_raise_and_bad_names_are_rejected():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        solve_multiphase(n=8, pc="lsc_mg_full", precision="ir", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        solve_multiphase(n=8, pc="lsc_mg_full", true_res_monitor=True,
                         device="cpu")
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
