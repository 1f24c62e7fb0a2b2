"""The port's own host setup library (`mpbp_tpu_torch/native`) against the
JAX package's (`mpbp_tpu/native`) on the n=16 operator's F and GtG (CPU):
ILUT, ILU(0), the level schedule and SpGEMM give bit-equal arrays, and the
library builds into the port's gitignored build directory."""

import numpy as np
import pytest
import torch

from mpbp_tpu import native as jax_native
from mpbp_tpu_torch import native
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.solvers.preconditioners import lsc_products

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def csrs():
    """Host CSR arrays of F and GtG at n=16, eta_n=100."""
    op = make_multiphase_operator(16, eta_n=100.0, device="cpu")
    return {"F": op.F.to_csr(drop_tol=1e-14).host_arrays(),
            "GtG": lsc_products(op)[0].to_csr(drop_tol=1e-14).host_arrays(),
            "-D": op.minus_D.to_csr().host_arrays(),
            "G": op.G.to_csr().host_arrays()}


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _equal(g, w)
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("block", ["F", "GtG"])
@pytest.mark.parametrize("kind,args", [("ilut", dict(fill=100, tau=1e-3)),
                                       ("ilut", dict(fill=400, tau=3e-5)),
                                       ("ilu0", {})])
def test_factors_bit_equal_to_jax_package(csrs, block, kind, args):
    got = getattr(native, kind)(*csrs[block], **args)
    want = getattr(jax_native, kind)(*csrs[block], **args)
    _equal(got, want)


@pytest.mark.parametrize("block", ["F", "GtG"])
@pytest.mark.parametrize("is_upper", [False, True])
def test_level_schedule_equal_to_jax_package(csrs, block, is_upper):
    (Lp, Li, _), (Up, Ui, _) = native.ilut(*csrs[block], fill=100, tau=1e-3)
    ptr, idx = (Up, Ui) if is_upper else (Lp, Li)
    levels, n_levels = native.level_schedule(ptr, idx, is_upper)
    want_levels, want_n = jax_native.level_schedule(ptr, idx, is_upper)
    assert n_levels == want_n > 1
    _equal((levels,), (want_levels,))


@pytest.mark.parametrize("a,b", [("-D", "G"), ("GtG", "GtG")])
def test_spgemm_bit_equal_to_jax_package(csrs, a, b):
    m = len(csrs[a][0]) - 1
    got = native.spgemm(m, *csrs[a], *csrs[b])
    _equal(got, jax_native.spgemm(m, *csrs[a], *csrs[b]))
    assert len(got[0]) > m


def test_library_builds_into_the_port_build_directory():
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "mpbp_tpu_torch"
