"""The port's mixed-precision iterative refinement (`solvers/mixed.py`) and
solve_multiphase(precision='ir') against the JAX package (ports of
tests/test_mixed.py)."""

import numpy as np
import pytest
import torch

from mpbp_tpu.drivers import solve_multiphase as jax_solve
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu.solvers.mixed import block_scales as jax_block_scales
from mpbp_tpu_torch.drivers import (a_matvec, make_preconditioner,
                                    pack_fields, solve_multiphase)
from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.solvers.mixed import block_scales, fgmres_ir

torch.set_num_threads(1)

# the n=16 ir solve of solve_multiphase (JAX: 72 inner iterations)
IR16 = dict(n=16, eta_n=100.0, pc="lsc_mg_full", tol=1e-8, maxiter=100,
            inner_tol=1e-4, inner_iters=40)
# The inner count moves with f32 rounding alone: under rhs perturbations
# of 1e-14 to 1e-10 relative, both packages take 48-75 inner iterations at
# n=16 (ROADMAP.md queue 3), so the count is held to that band around JAX.
INNER_BAND = (0.6, 1.15)


def system(n, pc="lsc_ilut", **pc_kwargs):
    """(f64 matvec, f32 matvec, f32 preconditioner, f64 rhs, f64 op)."""
    op64 = make_multiphase_operator(n, eta_n=100.0, device="cpu")
    op32 = make_multiphase_operator(n, eta_n=100.0, dtype=torch.float32,
                                    device="cpu")
    _, b = mms.fill_sol_and_rhs(op64.grid, mms.variable_thn_problem(
        1, -1, 1.0, 100.0, 1.0))
    M32 = make_preconditioner(op32, pc, dtype=torch.float32, **pc_kwargs)
    return a_matvec(op64), a_matvec(op32), M32, pack_fields(op64, b), op64


@pytest.mark.parametrize("n,eta_n,eta_s", [(16, 100.0, 1.0), (32, 3.0, 7.0)])
def test_block_scales_equal_jax(n, eta_n, eta_s):
    got = block_scales(make_multiphase_operator(n, eta_n=eta_n, eta_s=eta_s,
                                                device="cpu"))
    want = np.asarray(jax_block_scales(jax_make_operator(
        n, eta_n=eta_n, eta_s=eta_s)))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_ir_reaches_f64_tolerance():
    """f32 inner solves + f64 residuals reach 1e-8 on the n=16 stiff
    system, and the refinement contracts between outer steps."""
    mv64, mv32, M32, b, _ = system(16)
    res = fgmres_ir(mv64, mv32, b, tol=1e-8, max_outer=4, inner_tol=1e-5,
                    inner_maxiter=120, M32=M32)
    assert res.converged and res.relres < 1e-8, (res.relres, res.history)
    assert res.history[1] < 1e-4 * res.history[0]
    assert res.x.dtype == torch.float64
    r = b - mv64(res.x)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) == \
        pytest.approx(res.relres, rel=1e-9)


def test_ir_single_precision_alone_insufficient():
    """One f32 solve does not reach a 1e-8 true f64 residual: the
    refinement is load-bearing."""
    mv64, mv32, M32, b, _ = system(16)
    res = fgmres_ir(mv64, mv32, b, tol=1e-8, max_outer=1, inner_tol=1e-6,
                    inner_maxiter=150, M32=M32)
    assert not res.converged and res.relres > 1e-8
    assert res.outer_iters == 1 and len(res.history) == 2


def test_ir_equilibrated_converges():
    """Block equilibration restores the f32 contraction at n=32 and
    converges in no more outer steps than the plain refinement."""
    mv64, mv32, M32, b, op64 = system(32, "lsc_mg_full", inner_tol=1e-4,
                                      inner_iters=40)
    plain = fgmres_ir(mv64, mv32, b, tol=1e-8, max_outer=5, inner_tol=1e-6,
                      inner_maxiter=40, M32=M32)
    scaled = fgmres_ir(mv64, mv32, b, tol=1e-8, max_outer=5, inner_tol=1e-6,
                       inner_maxiter=40, M32=M32, scale=block_scales(op64))
    assert scaled.converged and scaled.relres < 1e-8, scaled.history
    assert scaled.outer_iters <= plain.outer_iters


def test_zero_rhs_returns_zero():
    mv64, mv32, M32, b, _ = system(8)
    res = fgmres_ir(mv64, mv32, torch.zeros_like(b), M32=M32)
    assert res.converged and res.outer_iters == 0
    assert float(res.x.abs().max()) == 0.0


def test_solve_multiphase_ir_matches_jax():
    """precision='ir' at n=16: converged to 1e-8, the full solve's L2 to
    1e-4 relative, and the total inner iterations in the band around the
    JAX package's."""
    full = solve_multiphase(**IR16, device="cpu")
    got = solve_multiphase(**IR16, precision="ir", device="cpu")
    want = jax_solve(**IR16, precision="ir")
    print(f"inner iterations: port {got.iters}, JAX {want.iters}")
    assert got.converged and got.relres < 1e-8
    assert got.params["true_relres"] < 1e-8
    assert got.params["precision"] == "ir"
    assert got.error_norms["l2"] == pytest.approx(full.error_norms["l2"],
                                                  rel=1e-4)
    assert got.error_norms["l2"] == pytest.approx(want.error_norms["l2"],
                                                  rel=1e-4)
    lo, hi = INNER_BAND
    assert lo * want.iters <= got.iters <= hi * want.iters
    # the history is the f64 relres after each outer step
    assert got.res_history[0] == pytest.approx(1.0)
    assert got.res_history[-1] == pytest.approx(got.relres)


# make_lsc_pc_mixed(refine_inners=...): the n=16 lsc_mg_full inners (f32)
# inside the f64 LSC glue, the port's against the JAX package's
REFINE = (True, False)
# The PC apply on one seeded vector agrees with JAX's to 2.6e-9 of max|y|
# with refinement and 3.5e-7 without (one unrefined f32 inner solve); the
# two branches differ by 1.2e-3 of it.
REFINE_APPLY_TOL = {True: 1e-7, False: 5e-6}
# The n=16 hybrid count with refinement is held to JAX's +-1, as the
# solve_multiphase hybrid test holds it. Without refinement JAX's own
# count moves 22-24 under 1e-14 relative rhs perturbations (the port's
# stays at 22), so there it is held to JAX's +-2.
REFINE_COUNT_SLACK = {True: 1, False: 2}
REFINE_KW = dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0, eta_s=1.0)


def _mixed_pcs(refine_inners: bool, n: int = 16):
    """(port PC, JAX PC, port op64, JAX op64) of the n=16 lsc_mg_full
    hybrid configuration."""
    import jax.numpy as jnp

    from mpbp_tpu.drivers import lsc_inners as jax_lsc_inners
    from mpbp_tpu.solvers.preconditioners import \
        make_lsc_pc_mixed as jax_mixed
    from mpbp_tpu_torch.drivers import lsc_inners
    from mpbp_tpu_torch.solvers.preconditioners import make_lsc_pc_mixed

    inner = dict(inner_tol=1e-4, inner_iters=40)
    j64 = jax_make_operator(n, dtype=jnp.float64, **REFINE_KW)
    j32 = jax_make_operator(n, dtype=jnp.float32, **REFINE_KW)
    t64 = make_multiphase_operator(n, dtype=torch.float64, device="cpu",
                                   **REFINE_KW)
    t32 = make_multiphase_operator(n, dtype=torch.float32, device="cpu",
                                   **REFINE_KW)
    jf, jp = jax_lsc_inners(j32, "lsc_mg_full", dtype=jnp.float32, **inner)
    tf, tp = lsc_inners(t32, "lsc_mg_full", dtype=torch.float32, **inner)
    return (make_lsc_pc_mixed(t64, tf, tp, refine_inners=refine_inners),
            jax_mixed(j64, jf, jp, refine_inners=refine_inners), t64, j64)


@pytest.mark.parametrize("refine_inners", REFINE)
def test_mixed_pc_apply_matches_jax(refine_inners):
    """One apply of the mixed LSC PC to the same seeded vector, in both
    branches of refine_inners: within REFINE_APPLY_TOL of max|y|."""
    import jax.numpy as jnp

    M, jax_M, _, _ = _mixed_pcs(refine_inners)
    v = np.random.default_rng(0).normal(size=5 * 16 * 16)
    want = np.asarray(jax_M(jnp.asarray(v)))
    got = M(torch.as_tensor(v))
    assert got.dtype == torch.float64 and got.shape == (5 * 16 * 16,)
    err = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert err <= REFINE_APPLY_TOL[refine_inners], err


def test_refine_inners_default_keeps_the_refined_apply():
    """refine_inners defaults to True (the same bits), and False is a
    different PC: its apply differs by far more than either tolerance."""
    from mpbp_tpu_torch.drivers import lsc_inners
    from mpbp_tpu_torch.solvers.preconditioners import make_lsc_pc_mixed

    op64 = make_multiphase_operator(16, device="cpu", **REFINE_KW)
    op32 = make_multiphase_operator(16, dtype=torch.float32, device="cpu",
                                    **REFINE_KW)
    f32, p32 = lsc_inners(op32, "lsc_mg_full", inner_tol=1e-4,
                          inner_iters=40, dtype=torch.float32)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=5 * 16 * 16))
    default = make_lsc_pc_mixed(op64, f32, p32)(v)
    refined = make_lsc_pc_mixed(op64, f32, p32, refine_inners=True)(v)
    plain = make_lsc_pc_mixed(op64, f32, p32, refine_inners=False)(v)
    assert torch.equal(default, refined)
    gap = float((plain - refined).abs().max() / refined.abs().max())
    assert gap > 100 * REFINE_APPLY_TOL[False], gap


@pytest.mark.parametrize("refine_inners", REFINE)
def test_hybrid_count_with_and_without_refinement_matches_jax(
        refine_inners):
    """The n=16 hybrid lsc_mg_full solve (FGMRES, tol 1e-8) with the mixed
    PC in each branch: converged in JAX's count within
    REFINE_COUNT_SLACK, L2 within 1e-4 of JAX's (JAX: 16 iterations with
    refinement, 24 without)."""
    import jax.numpy as jnp

    from mpbp_tpu import drivers as jd
    from mpbp_tpu.models import mms as jmms
    from mpbp_tpu.solvers import gmres as jkrylov
    from mpbp_tpu.utils.norms import norms_report as jax_norms
    from mpbp_tpu_torch.solvers import gmres as krylov
    from mpbp_tpu_torch.utils.norms import norms_report

    M, jax_M, t64, j64 = _mixed_pcs(refine_inners)
    prob = tuple(REFINE_KW.values())
    ju, jb = jmms.fill_sol_and_rhs(j64.grid, jmms.variable_thn_problem(*prob))
    tu, tb = mms.fill_sol_and_rhs(t64.grid, mms.variable_thn_problem(*prob))
    want = jkrylov.fgmres(jd.a_matvec(j64), jd.pack_fields(j64, jb),
                          tol=1e-8, maxiter=100, M=jax_M)
    got = krylov.fgmres(a_matvec(t64), pack_fields(t64, tb), tol=1e-8,
                        maxiter=100, M=M)
    print(f"refine_inners={refine_inners}: port {got.iters}, "
          f"JAX {int(want.iters)}")
    assert got.converged and bool(want.converged)
    assert abs(got.iters - int(want.iters)) <= \
        REFINE_COUNT_SLACK[refine_inners]
    g = t64.grid
    l2 = norms_report(got.x, pack_fields(t64, tu), g.dx, g.dy)["l2"]
    jl2 = jax_norms(want.x, jd.pack_fields(j64, ju), g.dx, g.dy)["l2"]
    assert l2 == pytest.approx(jl2, rel=1e-4)
    assert jnp.isfinite(want.x).all() and bool(torch.isfinite(got.x).all())


def test_drivers_do_not_pass_refine_inners_on():
    """As in the JAX package, refine_inners is make_lsc_pc_mixed's alone:
    the drivers' pc_kwargs reach lsc_inners, which refuses it, in both
    packages."""
    kw = dict(n=8, eta_n=100.0, pc="lsc_mg_full", precision="hybrid",
              refine_inners=False)
    with pytest.raises(TypeError):
        jax_solve(**kw)
    with pytest.raises(TypeError):
        solve_multiphase(**kw, device="cpu")


def test_unrefined_pc_floors_the_outer_solve_as_jax():
    """Without the refinement pass the f32 inner noise floors the outer
    FGMRES (the JAX package's make_lsc_pc_mixed docstring). At n=128
    (tol 1e-10, 25 iterations) neither package converges: the port stops
    at a true relres of 1.7e-6 and JAX at 9.2e-6, noise of the f32 inner
    solves (both take 18 iterations to 1e-10 with refinement). Held: not converged, each true relres in
    (1e-7, 1e-4), the port's within 10x of JAX's."""
    import jax.numpy as jnp

    from mpbp_tpu import drivers as jd
    from mpbp_tpu.models import mms as jmms
    from mpbp_tpu.solvers import gmres as jkrylov
    from mpbp_tpu_torch.solvers import gmres as krylov

    M, jax_M, t64, j64 = _mixed_pcs(False, n=128)
    prob = tuple(REFINE_KW.values())
    _, jb = jmms.fill_sol_and_rhs(j64.grid, jmms.variable_thn_problem(*prob))
    _, tb = mms.fill_sol_and_rhs(t64.grid, mms.variable_thn_problem(*prob))
    jb, tb = jd.pack_fields(j64, jb), pack_fields(t64, tb)
    jmv, mv = jd.a_matvec(j64), a_matvec(t64)
    want = jkrylov.fgmres(jmv, jb, tol=1e-10, maxiter=25, M=jax_M)
    got = krylov.fgmres(mv, tb, tol=1e-10, maxiter=25, M=M)
    jres = float(jnp.linalg.norm(jb - jmv(want.x)) / jnp.linalg.norm(jb))
    res = float(torch.linalg.norm(tb - mv(got.x)) / torch.linalg.norm(tb))
    print(f"true relres after 25: port {res:.3e}, JAX {jres:.3e}")
    assert not got.converged and not bool(want.converged)
    assert 1e-7 < res < 1e-4 and 1e-7 < jres < 1e-4
    assert jres / 10 <= res <= 10 * jres
