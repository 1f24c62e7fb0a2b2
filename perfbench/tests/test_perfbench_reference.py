"""The plain reference against a stencil worked by hand and against the
program's assembled operator; the mixes' inputs; the reductions."""

import numpy as np
import pytest
import torch

from perfbench.harness import roofline, spec, system, trace, traffic
from perfbench.reference import multiphase as ref

PARAMS = dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0, eta_s=1.0, d_p=1.0,
              d_div=-1.0)


def test_hand_worked_column_at_n4():
    """A x for x the unit vector of un at (1, 2), theta_n = 0.5 everywhere:
    h = 1/4, so 1/h^2 = 16; un's own row c 0.5 + xi 0.25 - d eta_n 16 (4
    faces x 0.5) = 3200.75, its 4 neighbours d eta_n 16 0.5 = -800, the
    solvent's row at the face d xi 0.25 = -0.25, the pressure rows d_div
    (+-0.5 / h) = +2 at (1, 2) and -2 at (1, 1); every other entry 0."""
    n = 4
    theta = {k: torch.full((n, n), 0.5, dtype=torch.float64)
             for k in ("cell", "xface_pt", "yface_pt")}
    x = torch.zeros((5, n, n), dtype=torch.float64)
    x[0, 1, 2] = 1.0
    want = torch.zeros_like(x)
    want[0, 1, 2] = 3200.75
    for r, c in ((1, 1), (1, 3), (0, 2), (2, 2)):
        want[0, r, c] = -800.0
    want[2, 1, 2] = -0.25
    want[4, 1, 2], want[4, 1, 1] = 2.0, -2.0
    got = ref.apply(theta, PARAMS, x)
    assert torch.allclose(got, want, rtol=0, atol=1e-9)


def test_reference_is_the_programs_operator():
    from mpbp_tpu_torch.drivers import pack_fields, unpack_fields
    from mpbp_tpu_torch.models.multiphase import make_multiphase_operator

    rng = np.random.default_rng(3)
    n = 8
    theta = {k: torch.as_tensor(rng.uniform(0.2, 0.8, (n, n)))
             for k in ("cell", "xface_pt", "yface_pt")}
    p = dict(PARAMS, c=1.3, d=-0.7, xi=2.0, eta_n=30.0, eta_s=2.0)
    op = make_multiphase_operator(n, **p, dtype=torch.float64, device="cpu",
                                  theta_planes=theta)
    x = torch.as_tensor(rng.standard_normal(5 * n * n))
    want = pack_fields(op, op.A.apply(unpack_fields(op, x)))
    got = ref.apply(theta, p, x).reshape(-1)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-14


def test_moving_theta_and_rhs_translate_together(tiny_cell):
    cell = tiny_cell("hyb1024.moving_theta", loads=4)
    p = system.params(cell.config)
    dev = torch.device("cpu")
    mix = traffic.Traffic(cell.traffic, 16, dev, 2**35 + 1)
    still = traffic.Traffic(dict(cell.traffic, kind="fixed"), 16, dev, 0)
    base_theta, base_rhs = still.theta(0), still.rhs(0, p).reshape(5, 16, 16)
    shifts = set()
    for step in range(1, 5):
        s = mix.shift(step)
        shifts.add(s)
        th = mix.theta(step)
        for k in th:
            assert torch.equal(th[k], torch.roll(base_theta[k], s, (0, 1)))
        b = mix.rhs(step, p).reshape(5, 16, 16)
        assert torch.allclose(b, torch.roll(base_rhs, s, (1, 2)), rtol=0,
                              atol=1e-12 * float(base_rhs.abs().max()))
    assert len(shifts) > 1


def test_loads_cycle_in_a_seeded_order(tiny_cell):
    cell = tiny_cell("hyb1024.fixed_theta", loads=8)
    dev = torch.device("cpu")
    a = traffic.Traffic(cell.traffic, 16, dev, 11)
    b = traffic.Traffic(cell.traffic, 16, dev, 12)
    for cyc in range(3):
        steps = range(1 + 8 * cyc, 9 + 8 * cyc)
        assert sorted(a.load(s) for s in steps) == list(range(8))
    assert [a.load(s) for s in range(1, 17)] != [b.load(s)
                                                 for s in range(1, 17)]
    p = system.params(cell.config)
    assert not torch.equal(a.rhs(1, p), a.rhs(2, p))
    assert torch.equal(a.rhs(3, p), a.rhs(3, p))


def test_mms_forcing_is_the_programs():
    from mpbp_tpu_torch.models import mms
    from mpbp_tpu_torch.models.multiphase import make_multiphase_operator

    cell = spec.load_cell("hyb1024.fixed_theta")
    t = dict(cell.traffic, fields={f: [] for f in traffic.FIELDS})
    mix = traffic.Traffic(t, 16, torch.device("cpu"), 1)
    b = mix.rhs(1, system.params(cell.config)).reshape(5, 16, 16)
    op = make_multiphase_operator(16, eta_n=100.0, device="cpu")
    _, want = mms.fill_sol_and_rhs(op.grid, mms.variable_thn_problem(
        1.0, -1.0, 1.0, 100.0, 1.0))
    for i, f in enumerate(traffic.FIELDS):
        assert torch.allclose(b[i], want[f], rtol=1e-14, atol=1e-12)
    for k in ("cell", "xface_pt", "yface_pt"):
        assert torch.equal(mix.theta(0)[k], getattr(op.phase_n, k))


def test_unknown_mix_kind_raises(tiny_cell):
    cell = tiny_cell("hyb1024.fixed_theta")
    with pytest.raises(ValueError, match="kind"):
        traffic.Traffic(dict(cell.traffic, kind="drifting"), 16,
                        torch.device("cpu"), 0)


def test_trace_reduction():
    events = [(True, "k1", 0.0, 1.0), (True, "k2", 0.5, 2.0),
              (True, "k1", 3.0, 4.0),
              (True, "solve.fgmres", 0.0, 5.0),     # a range's own mark
              (False, "solve.fgmres", 0.0, 5.0),
              (False, "setup.pc", 3.9, 4.8)]
    r = trace.reduce(events, (0.0, 5.0))
    assert r["busy_s"] == pytest.approx(3.0)
    assert r["window_s"] == pytest.approx(5.0)
    assert r["device_ops"][0] == ["k1", pytest.approx(2.0)]
    gaps = sorted((round(s, 6), name) for name, s in r["idle_gaps"])
    assert gaps == [(1.0, "setup.pc"), (1.0, "solve.fgmres")]


def test_roofline_work():
    nbytes, flops = roofline.work("f_apply", 1024, torch.float32)
    assert nbytes == 11 * 1024 * 1024 * 4
    assert roofline.work("f_sweep", 2048, torch.float64)[0] == \
        19 * 2048 * 2048 * 8
    assert roofline.least_seconds(nbytes, flops, torch.float32) == \
        pytest.approx(nbytes / 3.35e12)
