"""The port's checkpoints (`mpbp_tpu_torch.utils.checkpoint`): round trips,
the JAX package's npz layout in both directions (a file either package
writes, the other reads), and solves resumed from a Krylov state and from
a mid-solve Arnoldi state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.drivers import a_matvec as jax_a_matvec
from mpbp_tpu.drivers import make_preconditioner as jax_make_preconditioner
from mpbp_tpu.drivers import pack_fields as jax_pack_fields
from mpbp_tpu.models import mms as jax_mms
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_operator
from mpbp_tpu.solvers import gmres as jax_krylov
from mpbp_tpu.utils import checkpoint as jax_ckpt
from mpbp_tpu_torch.drivers import (a_matvec, make_preconditioner,
                                    pack_fields)
from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)


def _thn(y, x):
    return 0.3 + 0.1 * torch.cos(2 * np.pi * x) * torch.sin(4 * np.pi * y)


def _jax_thn(y, x):
    return 0.3 + 0.1 * jnp.cos(2 * np.pi * x) * jnp.sin(4 * np.pi * y)


def test_krylov_state_roundtrip(tmp_path):
    x = torch.arange(10.0, dtype=torch.float64)
    hist = np.array([1.0, 0.1, 0.01])
    path = str(tmp_path / "state.npz")
    ckpt.save_krylov_state(path, x, hist, 3, meta={"n": 4})
    x2, h2, it, meta = ckpt.load_krylov_state(path, device="cpu")
    assert torch.equal(x2, x)
    np.testing.assert_array_equal(h2, hist)
    assert it == 3 and meta == {"n": 4}
    # the JAX package reads the port's file
    jx, jh, jit, jmeta = jax_ckpt.load_krylov_state(path)
    np.testing.assert_array_equal(np.asarray(jx), x.numpy())
    assert jit == 3 and jmeta == {"n": 4}
    with pytest.raises(ValueError, match="krylov_state"):
        ckpt.load_operator(path, device="cpu")


def test_operator_roundtrip(tmp_path):
    """Saved and loaded, the operator's dense A is the original's to
    1e-12, in a non-default theta field."""
    op = make_multiphase_operator(8, eta_n=3.0, thn_fn=_thn, device="cpu")
    path = str(tmp_path / "op.npz")
    ckpt.save_operator(path, op)
    op2 = ckpt.load_operator(path, device="cpu")
    np.testing.assert_allclose(op2.A.to_dense(), op.A.to_dense(),
                               rtol=1e-12, atol=1e-12)
    assert op2.params == op.params


def test_theta_planes_injection_matches_closed_form_and_jax():
    """Plane-keyed theta injection reproduces the closed-form assembly to
    1e-14 for a non-default theta field, and the JAX package's to 1e-12."""
    op = make_multiphase_operator(8, eta_n=7.0, thn_fn=_thn, device="cpu")
    op2 = make_multiphase_operator(
        8, eta_n=7.0, device="cpu",
        theta_planes={"cell": op.phase_n.cell,
                      "xface_pt": op.phase_n.xface_pt,
                      "yface_pt": op.phase_n.yface_pt})
    dense = op.A.to_dense()
    np.testing.assert_allclose(op2.A.to_dense(), dense, rtol=1e-14,
                               atol=1e-14)
    want = np.asarray(jax_operator(8, eta_n=7.0, thn_fn=_jax_thn).A
                      .to_dense())
    np.testing.assert_allclose(dense, want, rtol=0,
                               atol=1e-12 * np.max(np.abs(want)))


def test_jax_operator_file_loads_in_the_port(tmp_path):
    """A file of the JAX package's save_operator gives the port the JAX
    operator: its K2 apply equals the JAX apply to 1e-12 of max|JAX|."""
    jop = jax_operator(16, eta_n=100.0, thn_fn=_jax_thn)
    path = str(tmp_path / "jax_op.npz")
    jax_ckpt.save_operator(path, jop)
    op = ckpt.load_operator(path, device="cpu")
    v = np.random.default_rng(5).normal(size=5 * 256)
    got = a_matvec(op)(torch.as_tensor(v)).numpy()
    want = np.asarray(jax_pack_fields(jop, jop.A.apply(
        {f: jnp.asarray(v[i * 256:(i + 1) * 256].reshape(16, 16))
         for i, f in enumerate(("un", "vn", "us", "vs", "p"))})))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.max(np.abs(want)))


def test_port_operator_file_loads_in_jax(tmp_path):
    """A file of the port's save_operator loads in the JAX package's
    load_operator with the port's dense A to 1e-12 and the same params."""
    op = make_multiphase_operator(8, eta_n=100.0, thn_fn=_thn, device="cpu")
    path = str(tmp_path / "port_op.npz")
    ckpt.save_operator(path, op)
    jop = jax_ckpt.load_operator(path)
    dense = op.A.to_dense()
    np.testing.assert_allclose(np.asarray(jop.A.to_dense()), dense, rtol=0,
                               atol=1e-12 * np.max(np.abs(dense)))
    assert jop.params == op.params


def _mms_system(n, eta_n):
    op = make_multiphase_operator(n, eta_n=eta_n, device="cpu")
    prob = mms.variable_thn_problem(1.0, -1.0, 1.0, eta_n, 1.0)
    _, b = mms.fill_sol_and_rhs(op.grid, prob)
    return op, pack_fields(op, b)


def test_solve_resumes_from_a_krylov_checkpoint(tmp_path):
    """lsc_ilut at n=16 stiff: 20 iterations, checkpoint, resume from the
    loaded x0 to convergence in at most 60 iterations in all."""
    op, b_vec = _mms_system(16, 100.0)
    mv = a_matvec(op)
    M = make_preconditioner(op, "lsc_ilut")
    r1 = krylov.fgmres(mv, b_vec, tol=1e-8, maxiter=20, M=M)
    assert not r1.converged
    path = str(tmp_path / "mid.npz")
    ckpt.save_krylov_state(path, r1.x, r1.res_history, 20)
    x0, _, _, _ = ckpt.load_krylov_state(path, device="cpu")
    r2 = krylov.fgmres(mv, b_vec, x0=x0, tol=1e-8, maxiter=130, M=M)
    assert r2.converged and 20 + r2.iters <= 60, r2.iters


def test_arnoldi_state_resume_is_the_uninterrupted_solve(tmp_path):
    """lsc_mg_full at n=16 stiff through fgmres_resumable: stopped after 5
    iterations, saved, loaded and resumed, it takes the uninterrupted
    solve's iterations and gives its x to 1e-12 relative."""
    op, b_vec = _mms_system(16, 100.0)
    mv = a_matvec(op)
    M = make_preconditioner(op, "lsc_mg_full", inner_iters=40)
    kw = dict(tol=1e-8, maxiter=40, M=M)
    whole, _ = krylov.fgmres_resumable(mv, b_vec, **kw)
    part, state = krylov.fgmres_resumable(mv, b_vec, max_steps=5, **kw)
    assert part.iters == 5 and not part.converged
    path = str(tmp_path / "arnoldi.npz")
    ckpt.save_arnoldi_state(path, state, torch.zeros_like(b_vec),
                            meta={"n": 16})
    state2, x0, meta = ckpt.load_arnoldi_state(path, device="cpu")
    assert meta == {"n": 16} and state2.j == 5 and not state2.lost
    res, _ = krylov.fgmres_resumable(mv, b_vec, x0=x0, state=state2, **kw)
    assert res.converged and whole.converged
    assert res.iters == whole.iters
    scale = float(whole.x.abs().max())
    assert float((res.x - whole.x).abs().max()) <= 1e-12 * scale


def test_jax_arnoldi_state_resumes_in_the_port(tmp_path):
    """An Arnoldi state saved mid-solve by the JAX package (lsc_ilut, n=8,
    eta 1, 4 iterations) resumes in the port: JAX's uninterrupted count,
    x within 1e-8 relative of JAX's; its missing `lost` reads False."""
    jop = jax_operator(8, eta_n=1.0)
    prob = jax_mms.variable_thn_problem(1.0, -1.0, 1.0, 1.0, 1.0)
    _, jb = jax_mms.fill_sol_and_rhs(jop.grid, prob)
    jb_vec = jax_pack_fields(jop, jb)
    jM = jax_make_preconditioner(jop, "lsc_ilut")
    jmv = jax_a_matvec(jop)
    whole, _ = jax_krylov.fgmres_resumable(jmv, jb_vec, tol=1e-8,
                                           maxiter=30, M=jM)
    _, jstate = jax_krylov.fgmres_resumable(jmv, jb_vec, tol=1e-8,
                                            maxiter=30, M=jM, max_steps=4)
    path = str(tmp_path / "jax_arnoldi.npz")
    jax_ckpt.save_arnoldi_state(path, jstate, jnp.zeros_like(jb_vec))
    state, x0, _ = ckpt.load_arnoldi_state(path, device="cpu")
    assert state.j == 4 and not state.lost
    assert state.V.shape == (31, 320) and state.Z.shape == (30, 320)
    op, b_vec = _mms_system(8, 1.0)
    res, _ = krylov.fgmres_resumable(a_matvec(op), b_vec, x0=x0,
                                     state=state, tol=1e-8, maxiter=30,
                                     M=make_preconditioner(op, "lsc_ilut"))
    assert res.converged and res.iters == int(whole.iters)
    wx = np.asarray(whole.x)
    assert np.max(np.abs(res.x.numpy() - wx)) <= 1e-8 * np.max(np.abs(wx))
