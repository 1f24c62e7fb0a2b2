"""The port's single-phase Stokes family (`mpbp_tpu_torch.models.stokes`,
BASELINE configs[0]-[1]) against the JAX package's on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.models import stokes as jax_stokes
from mpbp_tpu.solvers import gmres as jax_krylov
from mpbp_tpu.solvers.preconditioners import ILUInner as JaxILUInner
from mpbp_tpu.utils.norms import weighted_l2 as jax_weighted_l2
from mpbp_tpu_torch.models.stokes import (STOKES_FIELDS,
                                          make_stokes_operator, stokes_mms)
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers.preconditioners import ILUInner
from mpbp_tpu_torch.utils.norms import weighted_l2

torch.set_num_threads(1)

PI = np.pi


def eta_torch(y, x):
    return 1.0 + 0.5 * torch.sin(2 * PI * x) * torch.sin(2 * PI * y)


def eta_jax(y, x):
    return 1.0 + 0.5 * jnp.sin(2 * PI * x) * jnp.sin(2 * PI * y)


@pytest.mark.parametrize("variable", [False, True])
def test_stokes_apply_matches_jax(variable):
    """A on one random state at n=16, constant and variable eta, to 1e-12
    relative of max|JAX|; the MMS fields equal JAX's to 1e-14."""
    n = 16
    kw = dict(c=1.0, d=-1.0)
    op = make_stokes_operator(n, **kw, eta=2.0, device="cpu",
                              eta_fn=eta_torch if variable else None)
    jop = jax_stokes.make_stokes_operator(
        n, **kw, eta=2.0, eta_fn=eta_jax if variable else None)
    rng = np.random.default_rng(4)
    x = {f: rng.normal(size=(n, n)) for f in STOKES_FIELDS}
    got = op.A.apply({f: torch.as_tensor(v) for f, v in x.items()})
    want = jop.A.apply({f: jnp.asarray(v) for f, v in x.items()})
    scale = max(float(np.max(np.abs(want[f]))) for f in STOKES_FIELDS)
    for f in STOKES_FIELDS:
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   rtol=0, atol=1e-12 * scale)
    u, b = stokes_mms(op.grid, 1.0, -1.0, eta=2.0)
    ju, jb = jax_stokes.stokes_mms(jop.grid, 1.0, -1.0, eta=2.0)
    for f in STOKES_FIELDS:
        np.testing.assert_allclose(u[f].numpy(), np.asarray(ju[f]),
                                   rtol=0, atol=1e-14)
        np.testing.assert_allclose(b[f].numpy(), np.asarray(jb[f]),
                                   rtol=0, atol=1e-12)


def test_stokes_apply_second_order():
    """The MMS apply error falls at a rate above 1.85 from n=16 to 32."""
    errs = []
    for n in (16, 32):
        op = make_stokes_operator(n, c=1.0, d=-1.0, eta=1.0, device="cpu")
        u, b = stokes_mms(op.grid, 1.0, -1.0, eta=1.0)
        errs.append(float(weighted_l2(op.A.apply(u), b,
                                      op.grid.dx * op.grid.dy)))
    assert np.log2(errs[0] / errs[1]) > 1.85, errs


def _configs0_jax(n):
    op = jax_stokes.make_stokes_operator(n, c=1.0, d=-1.0, eta=1.0)
    u_ex, b = jax_stokes.stokes_mms(op.grid, 1.0, -1.0, eta=1.0)
    mv = jax_krylov.flatten_op(op.A.apply, u_ex, STOKES_FIELDS)
    b_vec = jnp.concatenate([b[f].ravel() for f in STOKES_FIELDS])
    u_vec = jnp.concatenate([u_ex[f].ravel() for f in STOKES_FIELDS])
    f_inner = JaxILUInner.ilut_of(op.F, fill=100, tau=1e-3)
    n2 = n * n

    def pc(v):
        return jnp.concatenate([f_inner(v[:2 * n2]), -v[2 * n2:]])

    res = jax_krylov.fgmres(mv, b_vec, tol=1e-8, maxiter=200, M=pc)
    return int(res.iters), float(jax_weighted_l2(res.x, u_vec,
                                                 op.grid.dx * op.grid.dy))


@pytest.mark.parametrize("n,apply", [(32, "level"), (64, "neumann")])
def test_constant_coeff_block_diag_solve_matches_jax(n, apply):
    """BASELINE configs[0]: FGMRES with a block-diagonal PC (ILUT(100,
    1e-3) F inner, the pressure-mass Schur approximation -eta), tol 1e-8:
    converged, weighted L2 error < 5e-2 and within 1e-6 relative of JAX's,
    the count within 3 of JAX's exact (level) apply. The 64^2 case runs
    the 24-sweep Neumann apply, the card's configuration; the level apply
    at 64^2 is too slow for a CPU test."""
    op = make_stokes_operator(n, c=1.0, d=-1.0, eta=1.0, device="cpu")
    u_ex, b = stokes_mms(op.grid, 1.0, -1.0, eta=1.0)
    mv = krylov.flatten_op(op.A.apply, u_ex, STOKES_FIELDS)
    b_vec = torch.cat([b[f].reshape(-1) for f in STOKES_FIELDS])
    u_vec = torch.cat([u_ex[f].reshape(-1) for f in STOKES_FIELDS])
    f_inner = ILUInner.ilut_of(op.F, fill=100, tau=1e-3, apply=apply,
                               sweeps=24)
    n2 = n * n

    def pc(v):
        return torch.cat([f_inner(v[:2 * n2]), -v[2 * n2:]])

    res = krylov.fgmres(mv, b_vec, tol=1e-8, maxiter=200, M=pc)
    err = float(weighted_l2(res.x, u_vec, op.grid.dx * op.grid.dy))
    want_iters, want_err = _configs0_jax(n)
    assert res.converged and err < 5e-2
    assert abs(res.iters - want_iters) <= 3, (res.iters, want_iters)
    assert err == pytest.approx(want_err, rel=1e-6)


def test_variable_viscosity_block_tri_solve_matches_jax():
    """BASELINE configs[1]: variable eta at 32^2, block lower-triangular PC
    with the mass Schur approximation, a random consistent rhs (numpy seed
    0): converged in at most 200 iterations, JAX's count within 3 and x
    within 1e-6 relative of JAX's."""
    n = 32
    n2 = n * n
    rng = np.random.default_rng(0)
    b_np = rng.normal(size=3 * n2)
    b_np[2 * n2:] -= np.mean(b_np[2 * n2:])

    op = make_stokes_operator(n, c=1.0, d=-1.0, eta_fn=eta_torch,
                              device="cpu")
    tmpl = {f: torch.zeros(n, n, dtype=torch.float64) for f in STOKES_FIELDS}
    mv = krylov.flatten_op(op.A.apply, tmpl, STOKES_FIELDS)
    f_inner = ILUInner.ilut_of(op.F, fill=100, tau=1e-3)
    eta_c = op.grid.eval_at_cells(eta_torch).reshape(-1)

    def pc(v):
        zu = f_inner(v[:2 * n2])
        du = op.D.apply({"u": zu[:n2].reshape(n, n),
                         "v": zu[n2:].reshape(n, n)})["p"].reshape(-1)
        return torch.cat([zu, -eta_c * (v[2 * n2:] + du)])

    res = krylov.fgmres(mv, torch.as_tensor(b_np), tol=1e-8, maxiter=200,
                        M=pc)

    jop = jax_stokes.make_stokes_operator(n, c=1.0, d=-1.0, eta_fn=eta_jax)
    jmv = jax_krylov.flatten_op(jop.A.apply, {f: jnp.zeros((n, n))
                                              for f in STOKES_FIELDS},
                                STOKES_FIELDS)
    jf = JaxILUInner.ilut_of(jop.F, fill=100, tau=1e-3)
    jeta = jnp.asarray(np.asarray(jop.grid.eval_at_cells(eta_jax)).ravel())

    def jpc(v):
        zu = jf(v[:2 * n2])
        du = jop.D.apply({"u": zu[:n2].reshape(n, n),
                          "v": zu[n2:].reshape(n, n)})["p"].ravel()
        return jnp.concatenate([zu, -jeta * (v[2 * n2:] + du)])

    want = jax_krylov.fgmres(jmv, jnp.asarray(b_np), tol=1e-8, maxiter=200,
                             M=jpc)
    assert res.converged and res.iters <= 200
    assert abs(res.iters - int(want.iters)) <= 3, (res.iters, want.iters)
    wx = np.asarray(want.x)
    assert np.max(np.abs(res.x.numpy() - wx)) <= 1e-6 * np.max(np.abs(wx))
