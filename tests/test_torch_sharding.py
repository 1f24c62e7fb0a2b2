"""The port's row-sharded path (`mpbp_tpu_torch/parallel/`) against the JAX
package's, on the CPU: gloo ranks spawned from `torch_rank_fns` (a module
that imports no JAX) against JAX on 4-device sub-meshes of the 8 virtual
devices. Each rank group has a time limit of its own, so a deadlock fails
its tests instead of hanging the run. The port's multi-rank results are
gathered whole and compared here.

Counts: the unpreconditioned f64 solve takes JAX's count exactly; with a
preconditioner within 2. The preconditioned cases run at n=16 (eta_n=100),
where both packages' counts stand still under rhs perturbations; the n=32
cases are marked slow (about 110 s). At n=32 the f64 `mg` count is
compared at tol 1e-6: at 1e-10 this eta-contrast-100 system sits at the
f64 noise floor, where the port's count moves between 30 and 38 under
1e-14 perturbations of the rhs (JAX: 38, and 35 on 4 devices), so there
only convergence and the L2 are held.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_rank_fns as rf
from mpbp_tpu.drivers import solve_multiphase_sharded as jax_driver
from mpbp_tpu.models import mms as jmms
from mpbp_tpu.models.fused import make_f_apply_stacked as jax_f_stacked
from mpbp_tpu.models.multiphase import ALL_FIELDS
from mpbp_tpu.models.multiphase import make_multiphase_operator as jax_op
from mpbp_tpu.parallel import halo as jhalo
from mpbp_tpu.parallel import sharding as jsh
from mpbp_tpu.parallel.pallas_sharded import make_fused_apply_pallas_sharded
from mpbp_tpu.solvers.preconditioners import lsc_products as jax_products

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG_X16, RNG_V32, RNG_DIA = 0, 1, 2
# rows over both axes of a 2-D (hosts, devices-per-host) mesh
AXIS_2D = ("dcn", "ici")


def _x16():
    return np.random.default_rng(RNG_X16).normal(size=(5, 16, 16))


def _v32():
    return np.random.default_rng(RNG_V32).normal(size=(5, 32, 32))


def _dia():
    """(offsets, data, x) of a 64-row periodic DIA matrix whose halos
    (7 rows below, 5 above) fit in a band of 16."""
    rng = np.random.default_rng(RNG_DIA)
    return ((0, 1, -1, 5, -7, 60), rng.normal(size=(6, 64)),
            rng.normal(size=64))


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:4]), axis_names=("x",))


@pytest.fixture(scope="module")
def mesh2x2():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                axis_names=AXIS_2D)


def _jax_mms(n, eta_n, dtype=jnp.float64):
    op = jax_op(n, c=1, d=-1, xi=1.0, eta_n=eta_n, eta_s=1.0, dtype=dtype)
    u, b = jmms.fill_sol_and_rhs(op.grid, jmms.variable_thn_problem(
        1, -1, 1.0, eta_n, 1.0))
    return op, u, b


def _jax_l2(op, u, x):
    from mpbp_tpu.utils.norms import norms_report
    return norms_report(jsh.unstack_state(x), u, op.grid.dx,
                        op.grid.dy)["l2"]


# the driver case: the mg-preconditioned solve at n=16, eta_n=100 (JAX: 25)
DRIVER = dict(n=16, eta_n=100.0, pc="mg", tol=1e-10, maxiter=60)
MG_INVARIANCE = dict(case="mg", n=16, tols=(1e-6,), maxiter=60)
PCS = {"cg": dict(case="cg", n=16, tols=(1e-10,), maxiter=60),
       "hybrid": dict(case="hybrid", n=16, tols=(1e-10,), maxiter=40)}
PCS32 = {"mg": dict(case="mg", n=32, tols=(1e-6, 1e-10), maxiter=60),
         "cg": dict(case="cg", n=32, tols=(1e-8,), maxiter=60),
         "hybrid": dict(case="hybrid", n=32, tols=(1e-10,), maxiter=40)}


def _group(world: int, tmp_path, calls: dict, timeout: float) -> list:
    """The results of {label: (rank function, kwargs)} on one group of
    `world` gloo ranks: a {label: result} dict a rank."""
    ranks = rf.run_ranks("several", world, tmp_path, timeout=timeout,
                         calls=list(calls.values()))
    return [dict(zip(calls, r)) for r in ranks]


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """One group of 4 gloo ranks runs every 4-rank case."""
    calls = {"halo": ("halo_applies", dict(x16=_x16())),
             "k3": ("k3_sharded", dict(v32=_v32())),
             "nopc": ("unpreconditioned", {}),
             "mg": ("pc_solve", MG_INVARIANCE),
             **{k: ("pc_solve", v) for k, v in PCS.items()},
             "resume": ("resume", {}),
             "driver": ("driver", DRIVER),
             "mesh_2d": ("mesh_2d", dict(x16=_x16(), v32=_v32(), dia=_dia(),
                                         hybrid=PCS["hybrid"],
                                         driver_kw=DRIVER))}
    return _group(4, tmp_path_factory.mktemp("four"), calls, 400)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    calls = {"mg": ("pc_solve", MG_INVARIANCE), "driver": ("driver", DRIVER)}
    return _group(2, tmp_path_factory.mktemp("two"), calls, 300)


@pytest.fixture(scope="module")
def one():
    """The 1-rank case in this process (a gloo group of one, whose ring
    neighbour is itself), closed after."""
    from mpbp_tpu_torch.parallel.distributed import init_distributed

    info = init_distributed(device="cpu")
    try:
        yield info, rf.pc_solve(**MG_INVARIANCE)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_driver_ref():
    return jax_driver(n_devices=4, **DRIVER)


def _jax_pc_solve(mesh, case, n, tols, maxiter):
    """JAX's sharded solve with the PC `case`: {tol: (iters, L2)}."""
    op, u, b = _jax_mms(n, 100.0)
    if case == "hybrid":
        op32, _, _ = _jax_mms(n, 100.0, jnp.float32)
        M = jsh.make_sharded_lsc_pc_mixed(op, op32, inner_tol=1e-4,
                                          inner_iters=40, setup_op32=op32)
    else:
        M = jsh.make_sharded_lsc_pc(op, inner_tol=1e-4, inner_iters=40,
                                    p_solver=case, setup_op=op)
    out = {}
    for tol in tols:
        r = jsh.sharded_solve(op, b, mesh, tol=tol, maxiter=maxiter, pc=M)
        out[tol] = (int(r.iters), _jax_l2(op, u, r.x))
    return out


def _hold_pc(got: dict, want: dict) -> None:
    for tol, (iters, l2) in want.items():
        g = got[tol]
        assert g["converged"] and abs(g["iters"] - iters) <= 2, (
            tol, g["iters"], iters)
        assert abs(g["l2"] - l2) <= 0.01 * l2


def test_every_rank_holds_the_gathered_results(four):
    for r in four[1:]:
        np.testing.assert_array_equal(r["nopc"]["cgs2"]["x"],
                                      four[0]["nopc"]["cgs2"]["x"])
        assert r["driver"] == four[0]["driver"]


@pytest.mark.parametrize("overlap", [False, True])
def test_halo_apply_matches_jax(four, mesh4, overlap):
    """A at n=16 and the composed GtFG through the 4-rank halo apply,
    against JAX's `halo_stencil_apply` on a 4-device mesh: 1e-12 relative
    to max|JAX|."""
    got = four[0]["halo"]
    op, _, _ = _jax_mms(16, 100.0)
    x = {f: jnp.asarray(v) for f, v in zip(ALL_FIELDS, _x16())}
    want = jax.jit(jhalo.halo_stencil_apply(op.A, mesh4, overlap=overlap))(x)
    want = np.stack([np.asarray(want[f]) for f in ALL_FIELDS])
    assert np.abs(got[("A", overlap)] - want).max() <= 1e-12 * np.abs(
        want).max()
    _, GtFG = jax_products(op)
    want = np.asarray(jax.jit(jhalo.halo_stencil_apply(
        GtFG, mesh4, overlap=overlap))({"p": x["p"]})["p"])
    assert np.abs(got[("GtFG", overlap)] - want).max() <= 1e-12 * np.abs(
        want).max()


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("float64", 1e-12)])
def test_k3_sharded_matvec_matches_jax(four, mesh4, dtype, tol):
    """K3 a band (its plain version here) at n=32 on 4 ranks, 8 rows a
    rank (JAX's sublane gate), against JAX's `make_fused_apply_pallas_
    sharded` in interpret mode; the band F-apply (K3 at p = 0) against
    JAX's `make_f_apply_stacked`."""
    got = four[0]["k3"]
    assert got["supported"]
    tdt = getattr(torch, dtype)
    op, _, _ = _jax_mms(32, 100.0, getattr(jnp, dtype))
    v = jnp.asarray(_v32().astype(dtype))
    vsh = jax.device_put(v, NamedSharding(mesh4, P(None, "x", None)))
    want = np.asarray(jax.jit(make_fused_apply_pallas_sharded(
        op, mesh4, interpret=True))(vsh))
    assert np.abs(got[("A", tdt)] - want).max() <= tol * np.abs(want).max()
    want = np.asarray(jax_f_stacked(op)(v[:4]))
    assert np.abs(got[("F", tdt)] - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("orthog", ["cgs2", "cgs1"])
def test_unpreconditioned_solve_takes_jax_count(four, mesh4, orthog):
    """sharded_solve without a PC at n=16: JAX's count exactly, and x
    within 1e-8 of JAX's (relative to max|x|)."""
    op, u, b = _jax_mms(16, 1.0)
    want = jsh.sharded_solve(op, b, mesh4, tol=1e-8, maxiter=60,
                             orthog=orthog)
    got = four[0]["nopc"][orthog]
    assert got["converged"] and got["iters"] == int(want.iters)
    x = np.asarray(want.x)
    assert np.abs(got["x"] - x).max() <= 1e-8 * np.abs(x).max()


def test_plain_matvec_solve_takes_the_k3_count(four):
    """fused=False (the halo stencil apply of the assembled A) walks the
    same recurrence as K3's."""
    got = four[0]["nopc"]
    assert got["plain"]["iters"] == got["cgs2"]["iters"]


@pytest.mark.parametrize("case", [
    "cg", pytest.param("hybrid", marks=pytest.mark.slow)])
def test_lsc_pcs_match_jax(four, mesh4, case):
    """`make_sharded_lsc_pc` with cg and the hybrid
    `make_sharded_lsc_pc_mixed` at n=16, eta_n=100, tol 1e-10 on 4 ranks:
    JAX's count within 2 and L2 within 1% (mg: the driver test). JAX's
    hybrid solve takes ~35 s here, so that case is slow and
    `test_hybrid_pc_takes_jax_recorded_count` stands in for it."""
    _hold_pc(four[0][case], _jax_pc_solve(mesh4, **PCS[case]))


# JAX's sharded hybrid solve of PCS["hybrid"] on 4 devices
# (`_jax_pc_solve(mesh4, **PCS["hybrid"])`, the slow case above)
JAX_HYBRID16 = {1e-10: (19, 2.2709010354397412e-2)}


def test_hybrid_pc_takes_jax_recorded_count(four):
    """The 4-rank hybrid solve at n=16, tol 1e-10: JAX's count within 2
    and L2 within 1%, against JAX's numbers for the same call."""
    _hold_pc(four[0]["hybrid"], JAX_HYBRID16)


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(PCS32))
def test_lsc_pcs_match_jax_at_n32(tmp_path, mesh4, case):
    """The same at n=32 (mg at tol 1e-6, cg 1e-8, hybrid 1e-10), the
    sizes of the JAX package's own sharded-PC tests. At tol 1e-10 the mg
    count follows rounding (module docstring): convergence and L2 only."""
    spec = dict(PCS32[case])
    got = _group(4, tmp_path, {case: ("pc_solve", spec)}, 600)[0][case]
    tight = 1e-10 if case == "mg" else None
    if tight:
        spec["tols"] = (1e-6,)
        assert got[tight]["converged"] and got[tight]["relres"] < tight
        assert abs(got[tight]["l2"] - 5.8405e-3) <= 0.01 * 5.8405e-3
    _hold_pc(got, _jax_pc_solve(mesh4, **spec))


def test_band_count_invariance(four, two, one):
    """The mg-preconditioned solve at n=16, tol 1e-6 takes one count on 1,
    2 and 4 ranks (JAX `test_sharded_lsc_pc_solve_iteration_invariance`:
    the same on 1 and 8 devices)."""
    counts = {1: one[1][1e-6]["iters"], 2: two[0]["mg"][1e-6]["iters"],
              4: four[0]["mg"][1e-6]["iters"]}
    assert len(set(counts.values())) == 1, counts
    assert one[0]["num_processes"] == 1 and one[0]["backend"] == "gloo"


# S1 (the sharded f64 counts against JAX's): the mg-preconditioned solve on
# one rank against JAX's on one device, on the same rhs. At n=32 the two
# residual histories agree to 2.3e-10 of each entry over entries 0-6 and
# part from entry 7 on (1.4e-8, then 1.4e-6, 1.1e-4), as rounding grows
# through the inner GMRES solves; the one-rank PC applies agree to 9.0e-15
# of max|y| and the MG cycles to 4.4e-16 at n=32. Under 1e-14 relative rhs
# perturbations the port's count moves 18-22 at tol 1e-8 (JAX: 22 on every
# seed), so the count is held to JAX's within 4 and the first 7 history
# entries to 1e-8 of JAX's.
S1 = dict(n=32, tol=1e-8, maxiter=60)
S1_HISTORY_ENTRIES, S1_HISTORY_RTOL, S1_COUNT_SLACK = 7, 1e-8, 4
# the study at n=256 and 512 (tol 1e-10, maxiter 80; slow): seed 0 is the
# rhs as assembled, seeds 1-5 multiply it by 1 + 1e-14 N(0, 1)
S1_STUDY = dict(tol=1e-10, maxiter=80)
S1_STUDY_SEEDS, S1_STUDY_HISTORY = range(6), (5, 1e-7)
# the PC applied to one vector, one rank against JAX, relative to max|y|:
# at n=32, 9.0e-15 (held to 1e-13); the pressure (3 cycles) and velocity
# (1 cycle) MG cycles 1.6e-16 and 4.4e-16 (held to 1e-14); at n=256 and
# 512 the PC within 1e-10 (the inner GMRES solves amplify rounding as n
# grows)
S1_APPLY_TOL = {"pc": 1e-13, "pressure_mg": 1e-14, "velocity_mg": 1e-14}
S1_STUDY_APPLY_TOL = 1e-10
# JAX's 1024^2 f64 row (SHARDED_r05.json, 8 virtual CPU devices)
S1_JAX_1024 = 45, 5.764696e-6


def _s1_rhs(b: dict, seed: int) -> dict:
    """The rhs fields as numpy, seed > 0: each times 1 + 1e-14 N(0, 1)."""
    out = {f: np.asarray(b[f], dtype=np.float64) for f in ALL_FIELDS}
    if seed:
        rng = np.random.default_rng(seed)
        out = {f: v * (1 + 1e-14 * rng.normal(size=v.shape))
               for f, v in out.items()}
    return out


def _s1_port(n: int, tol: float, maxiter: int, seed: int = 0):
    """(result, L2) of the port's sharded_solve with the f64 mg PC on the
    open process group, eta_n=100."""
    from mpbp_tpu_torch.parallel import sharding as sh

    op, u, b = rf._mms(n, 100.0)
    mesh = sh.make_mesh()
    M = sh.make_sharded_lsc_pc(op, inner_tol=1e-4, inner_iters=40,
                               p_solver="mg", mesh=mesh)
    b = {f: torch.as_tensor(v) for f, v in _s1_rhs(b, seed).items()}
    res = sh.sharded_solve(op, b, mesh, tol=tol, maxiter=maxiter, pc=M)
    return res, rf._record(op, u, res)["l2"]


def _s1_jax(n: int, tol: float, maxiter: int, seed: int = 0):
    """(result, L2) of JAX's sharded_solve with the f64 mg PC on one
    device, eta_n=100."""
    op, u, b = _jax_mms(n, 100.0)
    M = jsh.make_sharded_lsc_pc(op, inner_tol=1e-4, inner_iters=40,
                                p_solver="mg", setup_op=op)
    b = {f: jnp.asarray(v) for f, v in _s1_rhs(b, seed).items()}
    res = jsh.sharded_solve(op, b, Mesh(np.array(jax.devices()[:1]),
                                        axis_names=("x",)),
                            tol=tol, maxiter=maxiter, pc=M)
    return res, _jax_l2(op, u, res.x)


def _s1_apply_diff(part: str, n: int) -> float:
    """max|port - JAX| / max|JAX| of one apply on one rank to the same
    seeded vector: the f64 mg LSC PC ('pc'), or the pressure (3 cycles)
    or velocity (1 cycle) MG solver of its inner solves."""
    from mpbp_tpu.solvers.multigrid import MGPressureSolver as JaxPMG
    from mpbp_tpu.solvers.multigrid import MGVelocitySolver as JaxVMG
    from mpbp_tpu_torch.parallel import sharding as sh
    from mpbp_tpu_torch.parallel.halo import Ring
    from mpbp_tpu_torch.solvers.multigrid import (MGPressureSolver,
                                                  MGVelocitySolver)

    op, _, _ = rf._mms(n, 100.0)
    jop, _, _ = _jax_mms(n, 100.0)
    mesh = sh.make_mesh()
    v = np.random.default_rng(RNG_X16).normal(size=(5, n, n))
    if part == "pc":
        M = sh.make_sharded_lsc_pc(op, inner_tol=1e-4, inner_iters=40,
                                   p_solver="mg", mesh=mesh)
        jM = jsh.make_sharded_lsc_pc(jop, inner_tol=1e-4, inner_iters=40,
                                     p_solver="mg", setup_op=jop)
    else:
        ring, cycles = Ring.of(mesh, "x"), 3 if part == "pressure_mg" else 1
        mine, ref = ((MGPressureSolver, JaxPMG) if part == "pressure_mg"
                     else (MGVelocitySolver, JaxVMG))
        M, jM = mine.of(op, cycles=cycles, ring=ring), ref.of(jop,
                                                              cycles=cycles)
        v = v[4] if part == "pressure_mg" else v[:4]
    want = np.asarray(jM(jnp.asarray(v)))
    got = M(torch.as_tensor(v)).numpy()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("part", sorted(S1_APPLY_TOL))
def test_one_rank_mg_pc_apply_matches_jax(one, part):
    """S1's bisection at n=32: the one-rank f64 mg LSC PC and the MG
    cycles of its inner solves against JAX's on one vector, within
    S1_APPLY_TOL of max|y|."""
    diff = _s1_apply_diff(part, 32)
    print(f"{part}: {diff:.2e}")
    assert diff <= S1_APPLY_TOL[part]


def test_one_rank_mg_solve_follows_jax_history(one):
    """S1 at n=32: the port's sharded_solve with the f64 mg PC on one gloo
    rank and JAX's on one device, on the same rhs: converged, count within
    S1_COUNT_SLACK, the first S1_HISTORY_ENTRIES residuals within
    S1_HISTORY_RTOL of JAX's, L2 within 0.1%."""
    got, l2 = _s1_port(**S1)
    want, jl2 = _s1_jax(**S1)
    print(f"n={S1['n']}: port {got.iters}, JAX {int(want.iters)}")
    assert got.converged and bool(want.converged)
    assert abs(got.iters - int(want.iters)) <= S1_COUNT_SLACK
    k = S1_HISTORY_ENTRIES
    np.testing.assert_allclose(np.asarray(got.res_history[:k]),
                               np.asarray(want.res_history)[:k],
                               rtol=S1_HISTORY_RTOL, atol=0)
    assert l2 == pytest.approx(jl2, rel=1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("n", [256, 512])
def test_one_rank_mg_count_spread_covers_jax(one, n):
    """The S1 study (tol 1e-10): each package's count on S1_STUDY_SEEDS.
    The port's counts cover JAX's on the assembled rhs, the seed-0
    histories agree over their first S1_STUDY_HISTORY[0] entries within
    S1_STUDY_HISTORY[1], the PC applies within S1_STUDY_APPLY_TOL, every
    solve converges and every L2 is within 0.1% of JAX's (10-45 minutes
    on 4 threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        port = [_s1_port(n, **S1_STUDY, seed=s) for s in S1_STUDY_SEEDS]
    finally:
        torch.set_num_threads(threads)
    ref = [_s1_jax(n, **S1_STUDY, seed=s) for s in S1_STUDY_SEEDS]
    counts = [r.iters for r, _ in port]
    jax_counts = [int(r.iters) for r, _ in ref]
    h, jh = (np.asarray(r[0][0].res_history[:10]) for r in (port, ref))
    apply_diff = _s1_apply_diff("pc", n)
    print(f"n={n}: port {counts}, JAX {jax_counts}; PC apply {apply_diff:.2e}"
          "; history, relative difference: "
          + " ".join(f"{d:.1e}" for d in np.abs(h - jh) / np.abs(jh)))
    assert apply_diff <= S1_STUDY_APPLY_TOL
    assert all(r.converged for r, _ in port)
    assert all(bool(r.converged) for r, _ in ref)
    assert min(counts) <= jax_counts[0] <= max(counts)
    k, rtol = S1_STUDY_HISTORY
    np.testing.assert_allclose(np.asarray(port[0][0].res_history[:k]),
                               np.asarray(ref[0][0].res_history)[:k],
                               rtol=rtol, atol=0)
    jl2 = ref[0][1]
    assert all(abs(l2 - jl2) <= 1e-3 * jl2 for _, l2 in port + ref)


@pytest.mark.slow
def test_one_rank_mg_solve_at_1024_reaches_jax_l2(one):
    """The port's 1024^2 f64 mg solve (tol 1e-10, maxiter 80) on one gloo
    rank, plain PyTorch, beside JAX's recorded 45 iterations: tol 1e-10 is
    at this system's f64 floor there, so rounding alone moves the count
    (the CLI's `solve --sharded --n 1024 --eta-n 100 --tol 1e-10
    --maxiter 80 --device cpu` took 44 iterations on 4 threads; this
    solve stopped at maxiter 80 with a true relres of 1.22e-10). Held:
    a true relres within 2x tol and the L2 within 0.1% of JAX's; the count
    is printed (about 55 minutes and 11 GB of host memory)."""
    from mpbp_tpu_torch.parallel import sharding as sh
    from mpbp_tpu_torch.solvers import gmres as krylov

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got, l2 = _s1_port(1024, **S1_STUDY)
        op, _, b = rf._mms(1024, 100.0)
        b = sh.stack_state(b)
        mv = sh.stacked_matvec(op.A)
        _, rn = krylov.residual_norm(mv, b, got.x)
        true_res = float(rn / torch.linalg.norm(b))
    finally:
        torch.set_num_threads(threads)
    jax_iters, jax_l2 = S1_JAX_1024
    print(f"n=1024: port {got.iters} (converged {got.converged}, true "
          f"relres {true_res:.3e}), JAX {jax_iters}; L2 {l2:.6e}, JAX "
          f"{jax_l2}")
    assert true_res <= 2 * S1_STUDY["tol"]
    assert l2 == pytest.approx(jax_l2, rel=1e-3)


def test_driver_refuses_what_it_cannot_run(one):
    """n_devices other than the number of ranks, hybrid with block_ilu0,
    and an unknown pc or precision: ValueError (as JAX's driver for the
    hybrid block_ilu0 pair)."""
    from mpbp_tpu_torch.drivers import solve_multiphase_sharded

    for kw in (dict(n_devices=2), dict(precision="hybrid", pc="block_ilu0"),
               dict(pc="ilut"), dict(precision="ir")):
        with pytest.raises(ValueError):
            solve_multiphase_sharded(n=8, device="cpu", **kw)


def test_resume_from_x0(four, mesh4):
    """A solve stopped after 5 iterations and resumed from its gathered x
    (`sharded_solve(x0=...)`) converges in JAX's count for the same two
    calls."""
    op, u, b = _jax_mms(16, 1.0)
    part = jsh.sharded_solve(op, b, mesh4, tol=1e-8, maxiter=5)
    want = jsh.sharded_solve(op, b, mesh4, tol=1e-8, maxiter=60,
                             x0=part.x)
    got = four[0]["resume"]
    assert got["part_iters"] == int(part.iters) == 5
    assert got["converged"] and got["iters"] == int(want.iters)


@pytest.mark.parametrize("world", [2, 4])
def test_solve_multiphase_sharded_matches_jax(four, two, jax_driver_ref,
                                              world):
    """The driver (the mg PC, n=16, eta_n=100, tol 1e-10) on 2 and 4 ranks
    against JAX's on 4 devices, whose count does not move with the device
    count: count within 2, L2 within 1%, the report's name and devices."""
    want = jax_driver_ref
    got = (four if world == 4 else two)[0]["driver"]
    assert got["converged"] and got["devices"] == world
    assert got["pc"] == "sharded_mg_f64" == want.pc
    assert abs(got["iters"] - want.iters) <= 2, (got["iters"], want.iters)
    assert abs(got["l2"] - want.error_norms["l2"]) <= 0.01 * \
        want.error_norms["l2"]
    assert got["true_relres"] <= 10 * DRIVER["tol"]


def test_cli_sharded_under_torchrun():
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    mpbp_tpu_torch solve --sharded ... --device cpu`: the env:// contract,
    rank 0 alone prints, exit code 0 on convergence."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "mpbp_tpu_torch", "solve",
           "--sharded", "--n", "16", "--eta-n", "1", "--tol", "1e-8",
           "--maxiter", "40", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    lines = [l for l in out.stdout.splitlines() if l.startswith("solve")]
    assert len(lines) == 1, out.stdout
    assert "sharded over 2 devices" in lines[0]
    assert "converged=True" in lines[0]


def test_2d_mesh_bands_are_row_major(four):
    """On a 2x2 `global_mesh_2d` (two hosts of two ranks) the axis
    ("dcn", "ici") gives the rank at (h, d) the rows [(2h + d) loc,
    (2h + d + 1) loc), so host seams fall on dcn boundaries; ("ici",
    "dcn") gives it band 2d + h."""
    loc = 32 // 4
    assert sorted(r["mesh_2d"]["coords"] for r in four) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in four:
        h, d = r["mesh_2d"]["coords"]
        for axis, band in ((AXIS_2D, 2 * h + d), (("ici", "dcn"), 2 * d + h)):
            np.testing.assert_array_equal(
                r["mesh_2d"]["rows"][axis],
                np.arange(band * loc, (band + 1) * loc))


ENTRIES_2D = ["halo", "halo ici-major", "stacked", ("k3", torch.float32),
              ("k3", torch.float64), ("f", torch.float32),
              ("f", torch.float64), "block_ilu", "dia", "lsc_mg", "lsc_ilu"]


@pytest.mark.parametrize("entry", ENTRIES_2D, ids=str)
def test_2d_mesh_entry_points_match_1d(four, entry):
    """Every entry point that takes an axis, on the 2x2 mesh's ("dcn",
    "ici") against the 1-D mesh's "x" over the same 4 ranks, gathered
    whole: bit-equal. The halo apply of A, `stacked_matvec` of D, K3 a band
    (its plain version here) and the band F-apply in f32 and f64,
    `BlockJacobiILU`, `sharded_dia_matvec`, and the mg (banded MG
    hierarchies) and block-ILU LSC PCs; the halo apply also over ("ici",
    "dcn"), whose bands sit on the ranks in another order."""
    one, two = four[0]["mesh_2d"]["applies"][entry]
    np.testing.assert_array_equal(two, one)


def test_2d_mesh_solve_matches_1d_and_jax(four, mesh4, mesh2x2):
    """`sharded_solve(axis=("dcn", "ici"))` without a PC at n=32 (eta_n 1,
    tol 1e-8, maxiter 40: the JAX package's `test_2d_mesh_solve_matches_1d`)
    takes the count of the 1-D 4-rank solve and of JAX's on a 2x2 CPU
    sub-mesh and on 4 devices, and x agrees with the 1-D solve's to rtol
    1e-8, atol 1e-10. That iterate is not converged (relres ~2.2e-5), and
    there JAX's own 1- and 4-device iterates differ by 2.3e-8 of max|x|
    (the port's by 1.9e-7), so x is held against JAX's on the same solve
    run to convergence (maxiter 80): the count again, and within 1e-8 of
    max|x|, as `test_unpreconditioned_solve_takes_jax_count`."""
    op, _, b = _jax_mms(32, 1.0)
    got = four[0]["mesh_2d"]["nopc"]
    want1 = jsh.sharded_solve(op, b, mesh4, tol=1e-8, maxiter=40)
    want2 = jsh.sharded_solve(op, b, mesh2x2, tol=1e-8, maxiter=40,
                              axis=AXIS_2D)
    counts = (got["2d"]["iters"], got["x"]["iters"], int(want2.iters),
              int(want1.iters))
    assert len(set(counts)) == 1, counts
    np.testing.assert_allclose(got["2d"]["x"], got["x"]["x"], rtol=1e-8,
                               atol=1e-10)
    want = jsh.sharded_solve(op, b, mesh2x2, tol=1e-8, maxiter=80,
                             axis=AXIS_2D)
    conv = got["2d converged"]
    assert conv["converged"] and conv["iters"] == int(want.iters)
    x = np.asarray(want.x)
    assert np.abs(conv["x"] - x).max() <= 1e-8 * np.abs(x).max()


@pytest.mark.parametrize("case", ["hybrid", "driver"])
def test_2d_mesh_pc_solves_take_the_1d_count(four, case):
    """The hybrid sharded LSC solve (n=16, tol 1e-10) and
    `solve_multiphase_sharded` (mg, n=16) on the 2x2 mesh's ("dcn",
    "ici") take the 1-D axis's count, to the same L2."""
    got, want = four[0]["mesh_2d"][case], four[0][case]
    if case == "hybrid":
        got, want = got[1e-10], want[1e-10]
        assert got["converged"]
        for k in ("iters", "l2"):
            assert got[k] == want[k], (k, got[k], want[k])
    else:
        assert got == want


def test_one_rank_2d_mesh_solve_is_the_1d_solve(one):
    """On one rank the 1x1 2-D mesh's ("dcn", "ici") and the 1-D axis give
    the same driver solve, bit for bit."""
    from mpbp_tpu_torch.drivers import solve_multiphase_sharded

    kw = dict(n=16, eta_n=100.0, pc="mg", tol=1e-8, maxiter=40,
              device="cpu")
    one_d = solve_multiphase_sharded(**kw)
    two_d = solve_multiphase_sharded(**kw, axis=AXIS_2D)
    assert two_d.converged and two_d.iters == one_d.iters
    assert torch.equal(two_d.x, one_d.x)


@pytest.mark.parametrize("entry", ["ring", "ring twice", "sharded_solve",
                                   "make_mesh", "driver"])
def test_unknown_axis_raises(one, entry):
    """An axis that names a dimension the mesh lacks, or one dimension
    twice, raises ValueError: `Ring.of`, `sharded_solve` on the 2-D mesh,
    `make_mesh` with a tuple that is not two names, and
    `solve_multiphase_sharded`."""
    from mpbp_tpu_torch.drivers import solve_multiphase_sharded
    from mpbp_tpu_torch.parallel import sharding as sh
    from mpbp_tpu_torch.parallel.halo import Ring

    mesh = sh.make_mesh(axis=AXIS_2D)
    op, _, b = rf._mms(8, 1.0)
    calls = {
        "ring": lambda: Ring.of(mesh, ("dcn", "x")),
        "ring twice": lambda: Ring.of(mesh, ("ici", "ici")),
        "sharded_solve": lambda: sh.sharded_solve(op, b, mesh, axis="x"),
        "make_mesh": lambda: sh.make_mesh(axis=("dcn",)),
        "driver": lambda: solve_multiphase_sharded(
            n=8, device="cpu", axis=("dcn", "ici", "x"))}
    with pytest.raises(ValueError):
        calls[entry]()
