"""The port's fused applies and the plain versions of kernels K1/K2 against
the JAX package (XLA roll form and the Pallas kernels in interpret mode);
the wrappers' CPU dispatch and checks; the kernel build's failure modes.
The kernels themselves run only on a card: tests/test_torch_cuda_kernels.py."""

import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.models import fused as jax_fused
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu_torch.drivers import a_matvec
from mpbp_tpu_torch.models import fused
from mpbp_tpu_torch.models.multiphase import operator_from_numpy
from mpbp_tpu_torch.ops import _build, cuda_stencil

torch.set_num_threads(1)


def port_of(jop, dtype, device="cpu"):
    """The port's operator on exactly the JAX operator's theta planes."""
    return operator_from_numpy(np.asarray(jop.phase_n.cell),
                               np.asarray(jop.phase_n.xface_pt),
                               np.asarray(jop.phase_n.yface_pt), jop.params,
                               device=device, dtype=dtype)


def kernel_args(op, x):
    return (op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt, x,
            op.params, op.grid.dx, op.grid.dy)


def close(got, want, rtol, atol_scale):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


@pytest.mark.parametrize("params", [
    dict(c=1, d=-1, xi=1.0, eta_n=100.0, eta_s=1.0),
    dict(c=1, d=-1, xi=1.0, eta_n=1.0, eta_s=1.0),
    dict(c=0.5, d=-2.0, xi=3.0, eta_n=10.0, eta_s=0.1),
])
def test_fused_and_f_apply_match_jax(params):
    n = 16
    jop = jax_make_operator(n, **params)
    top = port_of(jop, torch.float64)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(5, n, n))
    close(fused.make_fused_apply(top)(torch.as_tensor(v)),
          jax_fused.make_fused_apply(jop)(jnp.asarray(v)), 1e-12, 1e-12)
    close(a_matvec(top)(torch.as_tensor(v.ravel())),
          jax_fused.make_fused_apply(jop)(jnp.asarray(v)).ravel(),
          1e-12, 1e-12)
    vu = v[:4].ravel()
    close(fused.make_f_apply(top)(torch.as_tensor(vu)),
          jax_fused.make_f_apply(jop)(jnp.asarray(vu)), 1e-12, 1e-12)


def test_a_apply_reference_matches_pallas_k2_interpret():
    n = 32
    jop = jax_make_operator(n, eta_n=100.0, dtype=jnp.float32)
    top = port_of(jop, torch.float32)
    v = np.random.default_rng(3).normal(size=(5, n, n)).astype(np.float32)
    want = jax_fused.make_fused_apply_pallas(
        jop, interpret=True, block_rows=16, halo="inkernel")(jnp.asarray(v))
    got = cuda_stencil.a_apply_reference(*kernel_args(top,
                                                      torch.as_tensor(v)))
    close(got, want, 2e-6, 2e-6)


def test_f_apply_reference_matches_pallas_k1_interpret():
    n = 32
    jop = jax_make_operator(n, eta_n=100.0, dtype=jnp.float32)
    top = port_of(jop, torch.float32)
    vu = np.random.default_rng(4).normal(size=4 * n * n).astype(np.float32)
    want = jax_fused.make_f_apply_pallas(jop, interpret=True,
                                         block_rows=16)(jnp.asarray(vu))
    got = cuda_stencil.f_apply_reference(
        *kernel_args(top, torch.as_tensor(vu).reshape(4, n, n)))
    close(got.reshape(-1), want, 2e-6, 2e-6)


def test_cpu_tensors_take_the_plain_version_without_counting():
    n = 8
    top = port_of(jax_make_operator(n), torch.float64)
    before = dict(cuda_stencil.LAUNCHES)
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(5, n, n)))
    args = kernel_args(top, x)
    torch.testing.assert_close(cuda_stencil.a_apply(*args),
                               cuda_stencil.a_apply_reference(*args),
                               rtol=0, atol=0)
    args4 = kernel_args(top, x[:4].contiguous())
    torch.testing.assert_close(cuda_stencil.f_apply(*args4),
                               cuda_stencil.f_apply_reference(*args4),
                               rtol=0, atol=0)
    assert cuda_stencil.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    n = 8
    top = port_of(jax_make_operator(n), torch.float64)
    x = torch.zeros(5, n, n, dtype=torch.float64)
    tn, wx, wy = top.phase_n.cell, top.phase_n.xface_pt, top.phase_n.yface_pt
    p, dx = top.params, top.grid.dx
    with pytest.raises(ValueError):          # K1 takes 4 planes
        cuda_stencil.f_apply(tn, wx, wy, x, p, dx, dx)
    with pytest.raises(TypeError):           # mixed dtypes
        cuda_stencil.a_apply(tn.float(), wx, wy, x, p, dx, dx)
    with pytest.raises(ValueError):          # non-contiguous state
        cuda_stencil.a_apply(tn, wx, wy, x.transpose(1, 2), p, dx, dx)
    with pytest.raises(ValueError):          # theta of the wrong size
        cuda_stencil.a_apply(tn[:4, :4].contiguous(), wx, wy, x, p, dx, dx)
    with pytest.raises(TypeError):           # no kernel for float16
        cuda_stencil.a_apply(tn.half(), wx.half(), wy.half(), x.half(), p,
                             dx, dx)


@pytest.fixture
def no_cuda_toolkit(monkeypatch, tmp_path):
    """A fresh build directory and no nvcc anywhere the build looks."""
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_CUDA_HOME_DEFAULT",
                        str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    return tmp_path


def test_build_without_nvcc_raises(no_cuda_toolkit):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_build_compile_failure_raises_with_nvcc_output(no_cuda_toolkit):
    bindir = no_cuda_toolkit / "empty-bin"
    bindir.mkdir()
    fake = bindir / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compile failure' >&2\n"
                    "exit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    with pytest.raises(RuntimeError, match="fake compile failure"):
        _build.build()
    assert not any(p.suffix == ".so"
                   for p in (no_cuda_toolkit / "build").iterdir())
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
