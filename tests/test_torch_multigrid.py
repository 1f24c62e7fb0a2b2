"""The port's pressure and velocity multigrid against the JAX package at
n=32 on a seeded rhs, in f64 and f32 (hierarchies built from the same theta
planes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu.solvers import multigrid as jax_mg
from mpbp_tpu_torch.models.multiphase import operator_from_numpy
from mpbp_tpu_torch.ops import cuda_mg
from mpbp_tpu_torch.solvers import multigrid as mg

torch.set_num_threads(1)

N = 32
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def operators(dtype):
    jop = jax_make_operator(N, eta_n=100.0, dtype=JDT[dtype])
    top = operator_from_numpy(np.asarray(jop.phase_n.cell),
                              np.asarray(jop.phase_n.xface_pt),
                              np.asarray(jop.phase_n.yface_pt), jop.params,
                              device="cpu", dtype=dtype)
    return top, jop


def rel_close(got, want, tol):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < tol, err


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pressure_mg_matches_jax(dtype):
    top, jop = operators(dtype)
    rhs = np.random.default_rng(0).normal(size=N * N)
    got = mg.MGPressureSolver.of(top, cycles=3)(
        torch.as_tensor(rhs, dtype=dtype))
    want = jax_mg.MGPressureSolver.of(jop, cycles=3)(
        jnp.asarray(rhs, JDT[dtype]))
    assert got.dtype == dtype and got.shape == (N * N,)
    rel_close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_velocity_mg_matches_jax(dtype):
    top, jop = operators(dtype)
    rhs = np.random.default_rng(1).normal(size=4 * N * N)
    t_levels = mg.build_velocity_mg(top)
    j_levels = jax_mg.build_velocity_mg(jop)
    assert [lv.n for lv in t_levels] == [lv.n for lv in j_levels]
    got = mg.MGVelocitySolver(t_levels, cycles=1)(
        torch.as_tensor(rhs, dtype=dtype))
    want = jax_mg.MGVelocitySolver(j_levels, cycles=1)(
        jnp.asarray(rhs, JDT[dtype]))
    rel_close(got, want, TOL[dtype])
    # stacked input gives the same answer in the stacked layout
    stacked = mg.MGVelocitySolver(t_levels, cycles=1)(
        torch.as_tensor(rhs, dtype=dtype).reshape(4, N, N))
    torch.testing.assert_close(stacked.reshape(-1), got, rtol=0, atol=0)


def test_grid_transfers_match_jax():
    rng = np.random.default_rng(2)
    fine, coarse = rng.normal(size=(N, N)), rng.normal(size=(N // 2, N // 2))
    for name, x in (("restrict_cell", fine), ("prolong_cell", coarse),
                    ("restrict_xface", fine), ("prolong_xface", coarse),
                    ("restrict_yface", fine), ("prolong_yface", coarse)):
        got = getattr(cuda_mg, name)(torch.as_tensor(x))
        want = getattr(jax_mg, name)(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-15, atol=1e-15, err_msg=name)
