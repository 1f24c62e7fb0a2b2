"""The PyTorch port's stencil algebra, operator assembly, MMS data and norms
against the JAX package on the same numpy-seeded inputs (CPU, f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.drivers import apply_report as jax_apply_report
from mpbp_tpu.models import mms as jax_mms
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu.ops import stencil as jax_stencil
from mpbp_tpu.utils.norms import norms_report as jax_norms
from mpbp_tpu_torch.drivers import apply_report, pack_fields
from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.multiphase import (make_multiphase_operator,
                                              operator_from_numpy)
from mpbp_tpu_torch.ops import stencil
from mpbp_tpu_torch.utils.norms import norms_report

torch.set_num_threads(1)

RTOL = 1e-12
PARAMS = dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0, eta_s=1.0)


def close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def assert_same_terms(top: stencil.StencilOperator,
                      jop: jax_stencil.StencilOperator):
    assert top.out_fields == jop.out_fields
    assert top.in_fields == jop.in_fields
    assert set(top.terms) == set(jop.terms)
    for key, offmap in jop.terms.items():
        assert set(top.terms[key]) == set(offmap), key
        for off, coef in offmap.items():
            close(top.terms[key][off], coef)


@pytest.mark.parametrize("dr", [-1, 0, 1])
@pytest.mark.parametrize("dc", [-1, 0, 1])
def test_shift_matches_jnp_roll(dr, dc):
    x = np.random.default_rng(dr * 3 + dc + 4).normal(size=(8, 8))
    got = stencil.shift(torch.as_tensor(x), dr, dc)
    want = jnp.roll(jnp.asarray(x), shift=(-dr, -dc), axis=(0, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_ops(n=8, seed=0):
    """Two random 2-field stencil operators, as (torch, jax) pairs."""
    rng = np.random.default_rng(seed)
    offs = [(0, 0), (0, 1), (-1, 0), (1, -1)]
    fields = ("a", "b")

    def terms():
        return {(o, i): {off: rng.normal(size=(n, n)) for off in offs}
                for o in fields for i in fields}

    pairs = []
    for t in (terms(), terms()):
        tt = {k: {o: torch.as_tensor(c) for o, c in om.items()}
              for k, om in t.items()}
        jt = {k: {o: jnp.asarray(c) for o, c in om.items()}
              for k, om in t.items()}
        pairs.append((stencil.StencilOperator(fields, fields, tt, (n, n)),
                      jax_stencil.StencilOperator(fields, fields, jt,
                                                  (n, n))))
    x = {f: rng.normal(size=(n, n)) for f in fields}
    return pairs, x


def test_stencil_algebra_matches_jax():
    (ta, ja), (tb, jb) = _random_ops()[0]
    _, xs = _random_ops()
    tx = {f: torch.as_tensor(v) for f, v in xs.items()}
    jx = {f: jnp.asarray(v) for f, v in xs.items()}
    for top, jop in ((ta, ja), (ta @ tb, ja @ jb), (ta + tb, ja + jb),
                     (ta - tb, ja - jb), (ta.T, ja.T), (2.5 * ta, 2.5 * ja),
                     (-tb, -jb)):
        assert_same_terms(top, jop)
        for f, want in jop.apply(jx).items():
            close(top.apply(tx)[f], want)
        for f, want in jop.apply_flux(jx).items():
            close(top.apply_flux(tx)[f], want)
    close(ta.to_dense(), ja.to_dense())
    close((ta @ tb).to_dense(), ta.to_dense() @ tb.to_dense())


@pytest.mark.parametrize("n", [8, 16])
def test_operator_blocks_match_jax(n):
    top = make_multiphase_operator(n, **PARAMS, device="cpu")
    jop = jax_make_operator(n, **PARAMS)
    for block in ("A", "F", "G", "D", "minus_D", "Ln", "Ls", "XIn", "XIs"):
        assert_same_terms(getattr(top, block), getattr(jop, block))
    for ph in ("phase_n", "phase_s"):
        for plane in ("cell", "xface", "yface", "node", "xface_pt",
                      "yface_pt"):
            close(getattr(getattr(top, ph), plane),
                  getattr(getattr(jop, ph), plane))


@pytest.mark.parametrize("n,l2", [(8, 4.7369), (16, 1.2783)])
def test_apply_report_matches_jax(n, l2):
    got = apply_report(n=n, device="cpu")
    want = jax_apply_report(n=n)
    for k in ("l1", "l2", "max"):
        assert got[k] == pytest.approx(want[k], rel=RTOL)
    assert round(got["l2"], 4) == l2


def test_mms_fill_and_norms_match_jax():
    n = 8
    top = make_multiphase_operator(n, device="cpu")
    jop = jax_make_operator(n)
    for problem in ("variable_thn_problem", "constant_thn_problem"):
        u, b = mms.fill_sol_and_rhs(top.grid,
                                    getattr(mms, problem)(**PARAMS))
        ju, jb = jax_mms.fill_sol_and_rhs(jop.grid,
                                          getattr(jax_mms, problem)(**PARAMS))
        for f in ju:
            close(u[f], ju[f])
            close(b[f], jb[f])
    got = norms_report(pack_fields(top, u), pack_fields(top, b),
                       top.grid.dx, top.grid.dy)
    want = jax_norms(ju, jb, jop.grid.dx, jop.grid.dy)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL)


def test_operator_from_numpy_matches_jax_theta_planes():
    n = 16
    rng = np.random.default_rng(7)
    cell, xpt, ypt = (rng.uniform(0.1, 0.9, (n, n)) for _ in range(3))
    jop = jax_make_operator(n, **PARAMS, theta_planes={
        "cell": jnp.asarray(cell), "xface_pt": jnp.asarray(xpt),
        "yface_pt": jnp.asarray(ypt)})
    top = operator_from_numpy(np.asarray(jop.phase_n.cell),
                              np.asarray(jop.phase_n.xface_pt),
                              np.asarray(jop.phase_n.yface_pt), jop.params,
                              device="cpu", dtype=torch.float64)
    assert top.params == jop.params
    for block in ("A", "F", "G", "D"):
        assert_same_terms(getattr(top, block), getattr(jop, block))
    with pytest.raises(ValueError):
        operator_from_numpy(cell, xpt, ypt, dict(jop.params, n=n + 1),
                            device="cpu", dtype=torch.float64)
