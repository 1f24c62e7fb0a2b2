"""The port's row-band DIA matvec (`mpbp_tpu_torch/parallel/sharded_dia.py`)
in both regimes, the 2-D halo apply (`halo.halo_stencil_apply_2d`) and
`init_distributed`'s launch contracts, on 4 gloo ranks spawned from
`torch_rank_fns` (which imports no JAX), against the serial DIA matvec
and the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_rank_fns as rf
from mpbp_tpu.ops.dia import DIAMatrix as JaxDIA
from mpbp_tpu.parallel.sharded_dia import _signed_offsets as jax_signed
from mpbp_tpu_torch.models.multiphase import (ALL_FIELDS,
                                              make_multiphase_operator)
from mpbp_tpu_torch.ops.dia import DIAMatrix
from mpbp_tpu_torch.parallel import distributed
from mpbp_tpu_torch.parallel.sharded_dia import _signed_offsets

torch.set_num_threads(1)
N = 2048
OFFSETS = [(-1, 0, 1),               # tridiagonal: banded halo regime
           (-16, -1, 0, 1, 16),      # 2-D stencil: banded halo regime
           (0, 512, 1024)]           # distant couplings: all-gather regime


def _random(N, offsets, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((len(offsets), N)), rng.standard_normal(N)


def _cases():
    cases = [(o, *_random(N, o, k)) for k, o in enumerate(OFFSETS)]
    # the 5-field saddle-point A at n=16 (all-gather regime)
    A = make_multiphase_operator(16, eta_n=100.0, device="cpu").A.to_dia()
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    cases.append((A.offsets, A.data.numpy(), x))
    return cases


def _fgmres_case():
    """A diagonally dominant banded system and its rhs."""
    data, _ = _random(1024, OFFSETS[1], 3)
    data[OFFSETS[1].index(0)] = np.abs(data).sum(axis=0) + 1.0
    b = np.random.default_rng(4).standard_normal(1024)
    return OFFSETS[1], data, b


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """One group of 4 gloo ranks under the env:// contract (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
    calls = [("dia_products", dict(cases=_cases(),
                                   fgmres_case=_fgmres_case())),
             ("halo_2d", dict(x16=np.random.default_rng(5).normal(
                 size=(5, 16, 16))))]
    return rf.run_ranks("several", 4, tmp_path_factory.mktemp("dia"),
                        timeout=300, contract="torch", calls=calls)


def _serial(offsets, data, x):
    A = DIAMatrix.from_numpy((data.shape[1],) * 2, offsets, data,
                             device="cpu")
    return A.matvec(torch.as_tensor(x)).numpy()


def test_signed_offsets():
    for offs, n in (((0, 1, 1023, 512), 1024), ((3, 7, 9), 10)):
        assert _signed_offsets(offs, n) == jax_signed(offs, n)
    assert _signed_offsets((0, 1, 1023, 512), 1024) == [0, 1, -1, -512]


@pytest.mark.parametrize("case", range(len(OFFSETS) + 1))
def test_sharded_dia_matches_serial_and_jax(four, case):
    """Both regimes on 4 ranks against `DIAMatrix.matvec` and JAX's
    matvec: 1e-12 relative to max|y| (case 3: the multiphase A)."""
    offsets, data, x = _cases()[case]
    got = four[0][0]["y"][case]
    want = _serial(offsets, data, x)
    jax_y = np.asarray(JaxDIA((data.shape[1],) * 2, tuple(offsets),
                              jnp.asarray(data)).matvec(jnp.asarray(x)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    assert np.abs(got - jax_y).max() <= 1e-12 * scale
    for r in four[1:]:
        np.testing.assert_array_equal(r[0]["y"][case], got)


def test_sharded_dia_in_fgmres(four):
    """The banded sharded DIA matvec drives a 4-rank FGMRES to 1e-10."""
    offsets, data, b = _fgmres_case()
    res = four[0][0]["fgmres"]
    assert res["converged"]
    np.testing.assert_allclose(_serial(offsets, data, res["x"]), b,
                               rtol=1e-8, atol=1e-8)


def test_halo_2d_apply_matches_roll_apply(four):
    """A (n=16, eta_n 100) on a 2x2 mesh of (8, 8) patches, rows then the
    column strips of the row-extended block (corners ride along): the
    unsharded apply within rtol 1e-11 (JAX's
    `test_halo_2d_apply_matches_roll_apply`)."""
    op = make_multiphase_operator(16, eta_n=100.0, device="cpu")
    x = np.random.default_rng(5).normal(size=(5, 16, 16))
    y = op.A.apply({f: torch.as_tensor(v) for f, v in zip(ALL_FIELDS, x)})
    want = np.stack([y[f].numpy() for f in ALL_FIELDS])
    np.testing.assert_allclose(four[0][1]["y"], want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())
    assert four[0][1]["mesh_2d"] == ((1, 4), ("dcn", "ici"))


def test_init_distributed_contracts_and_backend():
    """The backend follows the device; the MPBP contract needs all three
    values; with no contract a gloo group of one opens, and a CUDA run
    refuses a gloo group already open (no CPU fallback)."""
    assert distributed.backend_for("cuda") == "nccl"
    assert distributed.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        distributed.backend_for("meta")
    with pytest.raises(ValueError, match="together"):
        distributed.init_distributed("127.0.0.1:1", None, None,
                                     device="cpu")
    info = distributed.init_distributed(device="cpu")
    try:
        assert info == {"process_id": 0, "num_processes": 1,
                        "global_devices": 1, "local_devices": 1,
                        "backend": "gloo"}
        assert distributed.init_distributed(device="cpu") == info
        with pytest.raises(RuntimeError, match="nccl"):
            distributed.init_distributed(device="cuda")
        mesh = distributed.global_mesh_1d()
        assert mesh.mesh_dim_names == ("x",) and mesh.size() == 1
        np.testing.assert_array_equal(
            distributed.fetch_replicated(torch.arange(3)), np.arange(3))
    finally:
        dist.destroy_process_group()
