"""The port's per-operator MMS data (`mpbp_tpu_torch.models.mms`:
divergence_mms, gradient_mms, xi_mms, laplacian_mms) and the block
operators they check (D, G, XI and L of `models/multiphase`) against the
JAX package's, at n=16 and 32 on the variable theta_n field."""

import numpy as np
import pytest
import torch

from mpbp_tpu.models import fields as jax_fields
from mpbp_tpu.models import mms as jax_mms
from mpbp_tpu.models import multiphase as jax_mp
from mpbp_tpu.utils.norms import weighted_l2 as jax_weighted_l2
from mpbp_tpu_torch.models import fields, mms, multiphase
from mpbp_tpu_torch.utils.norms import weighted_l2

torch.set_num_threads(1)


def _case(port: bool, which: str, n: int):
    """(operator, input state, exact output state, grid) of one block
    operator from the port or from the JAX package."""
    f, mp, md = ((fields, multiphase, mms) if port
                 else (jax_fields, jax_mp, jax_mms))
    grid = f.MACGrid(n, device="cpu") if port else f.MACGrid(n)
    ph = f.make_phase_fields(grid, f.default_thn)
    make_op, data = {
        "D": (mp.divergence_operator, md.divergence_mms),
        "G": (mp.gradient_operator, md.gradient_mms),
        "XI": (lambda ph, g: mp.drag_diagonal(ph, 1.0, g),
               lambda g: md.xi_mms(g, 1.0)),
        "L": (mp.laplacian_operator, md.laplacian_mms)}[which]
    return (make_op(ph, grid), *data(grid), grid)


@pytest.mark.parametrize("which", ["D", "G", "XI", "L"])
def test_operator_mms_matches_jax_and_is_second_order(which):
    """At n=16 and 32: every MMS field equals JAX's to 1e-13 of its max;
    the port operator's L2 error against the exact output equals JAX's to
    rel 1e-10; and the error falls at order > 1.85 (the JAX package's
    `tests/test_mms_operators.py`)."""
    errs = []
    for n in (16, 32):
        op, x, b, grid = _case(True, which, n)
        jop, jx, jb, jgrid = _case(False, which, n)
        for got, want in ((x, jx), (b, jb)):
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                assert v.dtype == torch.float64 and v.device.type == "cpu"
                w = np.asarray(want[k])
                assert np.abs(v.numpy() - w).max() <= 1e-13 * np.abs(w).max()
        err = float(weighted_l2(op.apply(x), b, grid.dx * grid.dy))
        jerr = float(jax_weighted_l2(jop.apply(jx), jb, jgrid.dx * jgrid.dy))
        assert abs(err - jerr) <= 1e-10 * jerr, (n, err, jerr)
        errs.append(err)
    assert np.log2(errs[0] / errs[1]) > 1.85, (which, errs)


def test_default_ths_is_one_minus_thn():
    """theta_s = 1 - theta_n, equal to JAX's to 1e-15."""
    y, x = fields.MACGrid(16, device="cpu").cell_coords()
    got = fields.default_ths(y, x)
    assert torch.equal(got, 1.0 - fields.default_thn(y, x))
    want = np.asarray(jax_fields.default_ths(y.numpy(), x.numpy()))
    assert np.abs(got.numpy() - want).max() <= 1e-15
