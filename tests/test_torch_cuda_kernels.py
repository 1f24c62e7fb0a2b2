"""Kernels K1/K2 on the card against their plain PyTorch versions, and the
slice's solve on the card against the same solve on the CPU. Every test here
needs an NVIDIA GPU and skips without one. The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from mpbp_tpu_torch.drivers import solve_multiphase
from mpbp_tpu_torch.models.multiphase import operator_from_numpy
from mpbp_tpu_torch.ops import cuda_stencil

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K1/K2 have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5),
                                         (torch.float64, 1e-12)])
def test_kernels_match_plain_versions(cuda_device, dtype, bound):
    """At a size that is not a multiple of the 32x8 block (masked edges),
    random theta in [0.1, 0.9] and a random state; the bound is relative
    to max|plain| (FMA contraction and operation order)."""
    n = 50
    rng = np.random.default_rng(0)
    cell, xpt, ypt = (rng.uniform(0.1, 0.9, (n, n)) for _ in range(3))
    op = operator_from_numpy(cell, xpt, ypt,
                             dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0,
                                  eta_s=1.0), device=cuda_device, dtype=dtype)
    x = torch.as_tensor(rng.normal(size=(5, n, n)), dtype=dtype,
                        device=cuda_device)
    for name, nf in (("f_apply", 4), ("a_apply", 5)):
        args = (op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt,
                x[:nf].contiguous(), op.params, op.grid.dx, op.grid.dy)
        before = cuda_stencil.LAUNCHES[name]
        got = getattr(cuda_stencil, name)(*args)
        want = getattr(cuda_stencil, f"{name}_reference")(*args)
        torch.cuda.synchronize()
        assert cuda_stencil.LAUNCHES[name] == before + 1
        assert float((got - want).abs().max()) <= bound * float(
            want.abs().max())


def test_hybrid_solve_on_card_matches_cpu(cuda_device):
    """The slice's solve on the card against the same solve on the CPU at
    n=16, where the outer count is stable: 15 iterations under rhs
    perturbations up to 1e-12 on the CPU. (At n=32 a 1e-14 perturbation
    moves it between 18 and 22 in f64, so counts there are not compared.)
    The f32 inner solves round differently on the card (FMA, reduction
    order), hence the band of 2."""
    kw = dict(n=16, eta_n=100.0, pc="lsc_mg_full", precision="hybrid",
              tol=1e-8, maxiter=100, inner_tol=1e-4, inner_iters=40)
    before = dict(cuda_stencil.LAUNCHES)
    gpu = solve_multiphase(**kw, device=cuda_device)
    assert all(cuda_stencil.LAUNCHES[k] > before[k] for k in before)
    cpu = solve_multiphase(**kw, device="cpu")
    msg = f"card {gpu.iters} iters, cpu {cpu.iters}"
    assert gpu.converged and abs(gpu.iters - cpu.iters) <= 2, msg
    assert gpu.params["true_relres"] <= 10 * kw["tol"]
    assert gpu.error_norms["l2"] == pytest.approx(cpu.error_norms["l2"],
                                                  rel=1e-4)
