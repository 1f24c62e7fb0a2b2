"""Kernel K13 (`mpbp_tpu_torch/ops/cuda_krylov.py`): the fixed-budget GMRES
cycle's own work (CGS2, the Givens tail, the cycle's start and solution)
as a few launches a step.

On the CPU each wrapper runs its plain version, held here bit for bit
(`torch.equal`, NaN where NaN) against the per-op code it was moved from:
`gmres._arnoldi_init`, `gmres._arnoldi_step` (CGS2, no Z) over every step
of a cycle, done, breakdown and lost-column states included, and the
device back-substitution `_device_solution` as it stood (kept below). Then
`gmres_fixed` through the wrappers against the JAX package's `gmres` on F
with its velocity V-cycle, n = 16 and 64, f64: the same count, x within
1e-9 of max|x| (the projections' sums and XLA's round apart, by ~1e-13
a step, amplified over the cycle's solve).

Also: the fixed cycle calls the wrappers (a spy); the wrappers refuse a
wrong dtype, shape or a non-contiguous input before any device work, and
reach the device check only with right ones (on the meta device, which
has no kernel); `plain()` restores its flag; each C entry point's
argtypes match its signature.

On the card (`gpu`, skipped here): the kernels' tail bit-equal to the
plain tail on equal (h, ||w||, ||w|| before); the projection's h,
||w''||, ||w|| and row s+1 within a few eps of the plain version's, at
n = 4 * 1024^2 and 4 * 2048^2 (sums of 4-17 M products in another
order), on rows off orthogonal and a w nearly in their span, so that
each of the three passes moves what is checked; a 1024^2 f32
`gmres_fixed` on F with its V-cycle at the plain version's count +-1 and
residual; the hybrid PC with K13 bit-equal eager, as an IF graph and as
a masked graph, with K13's launches a replay 5 a step run + 3 a cycle;
40 captures in a row; a moving-theta PC adopting the released graph
with no device malloc. JAX is
imported inside the test that compares with it, so the `gpu` tests also
run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_krylov_kernels.py
"""

import gc
import re

import numpy as np
import pytest
import torch

from mpbp_tpu_torch.drivers import make_preconditioner_mixed
from mpbp_tpu_torch.models.fused import make_f_apply
from mpbp_tpu_torch.models.multiphase import (make_multiphase_operator,
                                              operator_from_numpy)
from mpbp_tpu_torch.ops import _build, cuda_krylov
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers import graphs
from mpbp_tpu_torch.solvers.multigrid import MGVelocitySolver
from mpbp_tpu_torch.utils import metrics

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
DTYPES = [F64, F32]
FIELDS = ("V", "H", "cs", "sn", "g", "hist", "j", "done", "lost")
M_BUDGET = 8


def same(a, b) -> bool:
    """Bit for bit where numbers, NaN where NaN."""
    if a.dtype.is_floating_point:
        return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))
    return torch.equal(a, b)


def assert_same_state(got, want, where):
    for f in FIELDS:
        assert same(getattr(got, f), getattr(want, f)), (where, f)


def _device_solution_before(state, x0, M):
    """`gmres._device_solution` (use_z False) as it stood before K13: x
    from the state, the triangular system solved over all m columns."""
    j, H, g = state.j, state.H, state.g
    m = H.shape[1]
    valid = torch.arange(m, device=j.device) < j
    R = torch.where(valid[:, None] & valid[None, :], H[:m],
                    torch.eye(m, dtype=H.dtype, device=H.device))
    rhs = torch.where(valid, g[:m], torch.zeros_like(g[:m]))
    y = torch.linalg.solve_triangular(R, rhs[:, None], upper=True)[:, 0]
    y = torch.where(valid, y, torch.zeros_like(y))
    dx = M((y @ state.V[:m]).reshape(x0.shape)).reshape(-1)
    return x0 + dx.reshape(x0.shape)


def system(case: str, dtype, n: int = 24):
    """(A, b, M) of a seeded case: 'converges' (nonsymmetric, Jacobi M),
    'breakdown' (b an eigenvector: the first column an exact solve),
    'lost' (A z = 0 at the first step: a lost column) and 'lost_later'
    (A singular on the Krylov space: the second column lost)."""
    rng = np.random.default_rng(7)
    if case == "converges":
        A = np.diag(np.linspace(1.0, 2.0, n)) + rng.normal(size=(n, n)) / 40
        b = rng.normal(size=n)
    else:
        A = np.diag(np.arange(0.0, n))
        b = np.zeros(n)
        b[{"breakdown": [4], "lost": [0], "lost_later": [0, 1]}[case]] = 1.0
    At = torch.as_tensor(A, dtype=dtype)
    inv_d = torch.as_tensor(1.0 / np.where(np.diag(A) == 0, 1.0,
                                           np.diag(A)), dtype=dtype)
    M = (lambda v: inv_d * v) if case == "converges" else (lambda v: v)
    return (lambda v: At @ v), torch.as_tensor(b, dtype=dtype), M


# --------------------------------------------------------------------------
# the plain versions against the per-op code they were moved from
# --------------------------------------------------------------------------
@pytest.mark.parametrize("x0", [False, True], ids=["b", "residual"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_init_is_arnoldi_init(dtype, x0):
    mv, b, _ = system("converges", dtype)
    x = torch.full_like(b, 0.25) if x0 else torch.zeros_like(b)
    want = krylov._arnoldi_init(mv, b, x, 1e-6, M_BUDGET, False,
                                krylov._safe_bnorm(b))
    got = cuda_krylov.init(b, b - mv(x) if x0 else b, 1e-6, M_BUDGET)
    assert got.parts is None and got.scal is None
    assert_same_state(got, want, "init")
    assert torch.equal(got.bnorm, krylov._safe_bnorm(b))


@pytest.mark.parametrize("case", ["converges", "breakdown", "lost",
                                  "lost_later"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_step_is_arnoldi_step(dtype, case):
    """Every step of the budget, past done as a masked budget runs them:
    the same state after each."""
    mv, b, M = system(case, dtype)
    tol = 1e-6 if dtype == F64 else 1e-4
    want = krylov._arnoldi_init(mv, b, torch.zeros_like(b), tol, M_BUDGET,
                                False, krylov._safe_bnorm(b))
    got = cuda_krylov.init(b, b, tol, M_BUDGET)
    for s in range(M_BUDGET):
        krylov._arnoldi_step(want, mv, M, b.shape, s, tol, False, "cgs2",
                             krylov._safe_bnorm(b))
        cuda_krylov.step(got, mv(M(got.V[s])), s, tol)
        assert_same_state(got, want, s)
    assert bool(got.done)
    j, lost = int(got.j), bool(got.lost)
    if dtype == F64:       # what each case is for (f32 may round past it)
        assert (j, lost) == {"converges": (j, False), "breakdown": (1, False),
                             "lost": (0, True),
                             "lost_later": (1, True)}[case]
        assert 2 < j < M_BUDGET or case != "converges"


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_solution_is_the_device_solution(dtype):
    """At every count 0..m (the cycle stopped after each step) M of the
    plain solution, plus x0, is the old device solution."""
    mv, b, M = system("converges", dtype)
    x0 = torch.full_like(b, 0.5)
    for stop in range(M_BUDGET + 1):
        st = cuda_krylov.init(b, b - mv(x0), 1e-30, M_BUDGET)
        for s in range(stop):
            cuda_krylov.step(st, mv(M(st.V[s])), s, 1e-30)
        assert int(st.j) == stop
        got = x0 + M(cuda_krylov.solution(st))
        assert torch.equal(got, _device_solution_before(st, x0, M))


@pytest.mark.parametrize("orthog", ["cgs2", "cgs1"])
def test_fixed_cycle_calls_the_wrappers(orthog, monkeypatch):
    """CGS2 runs the whole cycle through K13's wrappers; CGS1 steps
    `_arnoldi_step` and takes K13's solution."""
    calls = []
    for name in ("init", "step", "solution"):
        real = getattr(cuda_krylov, name)

        def spy(*a, _name=name, _real=real, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(cuda_krylov, name, spy)
    mv, b, M = system("converges", F64)
    res = krylov.gmres_fixed(mv, b, tol=1e-8, maxiter=20, M=M, orthog=orthog)
    steps = int(res.iters)
    assert 2 < steps < 20
    want = (["init", *["step"] * steps, "solution"] if orthog == "cgs2"
            else ["solution"])
    assert calls == want
    assert cuda_krylov.LAUNCHES in graphs._COUNTERS


def test_fixed_cycle_starts_from_b_without_a_matvec():
    """gmres_fixed without x0 applies no matvec to a zero vector: r0 is b
    (the JAX package applies it; b - A 0 is b bit for bit)."""
    mv, b, M = system("converges", F64)
    seen = []

    def spy(v):
        seen.append(bool(torch.all(v == 0)))
        return mv(v)
    krylov.gmres_fixed(spy, b, tol=1e-8, maxiter=20, M=M)
    assert seen and not any(seen)


@pytest.mark.parametrize("n", [16, 64])
def test_gmres_fixed_matches_jax_on_f(n):
    """`gmres_fixed` on F with one velocity V-cycle as M (the hybrid PC's
    F inner, in f64) against the JAX package's `gmres`: the same count, x
    within 1e-9 of max|x|."""
    import jax.numpy as jnp

    from mpbp_tpu.models.fused import make_f_apply as jax_f_apply
    from mpbp_tpu.models.multiphase import make_multiphase_operator as jmk
    from mpbp_tpu.solvers import gmres as jax_krylov
    from mpbp_tpu.solvers import multigrid as jmg

    jop = jmk(n, eta_n=100.0, dtype=jnp.float64)
    top = operator_from_numpy(np.asarray(jop.phase_n.cell),
                              np.asarray(jop.phase_n.xface_pt),
                              np.asarray(jop.phase_n.yface_pt), jop.params,
                              device="cpu", dtype=F64)
    rhs = np.random.default_rng(11).normal(size=4 * n * n)
    got = krylov.gmres_fixed(make_f_apply(top), torch.as_tensor(rhs),
                             tol=1e-8, maxiter=30,
                             M=MGVelocitySolver.of(top, cycles=1))
    want = jax_krylov.gmres(jax_f_apply(jop), jnp.asarray(rhs), tol=1e-8,
                            maxiter=30, M=jmg.MGVelocitySolver.of(jop,
                                                                  cycles=1))
    assert int(got.iters) == int(want.iters) < 30
    wx = np.asarray(want.x)
    assert np.abs(got.x.numpy() - wx).max() <= 1e-9 * np.abs(wx).max()


def test_plain_restores_the_flag():
    assert not cuda_krylov._plain
    with pytest.raises(RuntimeError):
        with cuda_krylov.plain():
            assert cuda_krylov._plain
            raise RuntimeError("inside")
    assert not cuda_krylov._plain


# --------------------------------------------------------------------------
# the wrappers' checks, before any device work
# --------------------------------------------------------------------------
NV = 16


def _call(name: str, device: str, fault: str | None = None):
    """A call of wrapper `name` on `device`, right or with one `fault`:
    'dtype' (float16 vector), 'shape' (a vector one short) or
    'contiguous' (a strided view)."""
    def vec(n=NV):
        return torch.ones(n, dtype=F64, device=device)

    x = vec()
    if fault == "dtype":
        x = x.to(torch.float16)
    elif fault == "shape":
        x = vec(NV - 1)
    elif fault == "contiguous":
        x = vec(2 * NV)[::2]
    if name == "init":
        return lambda: cuda_krylov.init(vec(), x, 1e-6, 4)
    if device == "meta":
        cy = cuda_krylov._cycle(NV, 4, F64, device, 1)
    else:
        cy = cuda_krylov.init(vec(), vec(), 1e-6, 4)
    if name == "step":
        return lambda: cuda_krylov.step(cy, x, 0, 1e-6)
    if fault == "dtype":
        cy.V = cy.V.to(torch.float16)
    elif fault == "contiguous":
        cy.V = cy.V.t().contiguous().t()
    elif fault == "shape":
        cy.V = cy.V[None]
    return lambda: cuda_krylov.solution(cy)


WRAPPERS = ["init", "step", "solution"]


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous"])
@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_refuse_before_device_work(name, fault):
    """On the meta device (no kernel) a faulty call raises its own error,
    not the device's, and launches nothing."""
    before = dict(cuda_krylov.LAUNCHES)
    with pytest.raises((TypeError, ValueError)) as info:
        _call(name, "meta", fault)()
    assert "no kernel" not in str(info.value)
    assert dict(cuda_krylov.LAUNCHES) == before


@pytest.mark.parametrize("name", WRAPPERS)
def test_right_calls_reach_the_device_check(name):
    with pytest.raises(ValueError, match="no kernel for device meta"):
        _call(name, "meta")()
    with cuda_krylov.plain():      # the plain version takes the same call
        _call(name, "cpu")()


@pytest.mark.parametrize("s", [-1, 4])
def test_budget_and_step_are_checked(s):
    b = torch.ones(NV, dtype=F64)
    for m in (0, cuda_krylov.MAX_BUDGET + 1):
        with pytest.raises(ValueError, match="budget"):
            cuda_krylov.init(b, b, 1e-6, m)
    cy = cuda_krylov.init(b, b, 1e-6, 4)
    with pytest.raises(ValueError, match="step"):
        cuda_krylov.step(cy, b, s, 1e-6)


def test_krylov_step_argtypes_match_the_c_signatures():
    """Each entry point of krylov_step.cu has argtypes of as many entries
    as its C definition has parameters, a pointer where it takes one."""
    text = _build.source_path("krylov_step").read_text()
    for name, argtypes in _build.SOURCES["krylov_step"].items():
        assert re.search(rf"\(\s*{name},", text), name
        macro = name.rsplit("_", 1)[0].upper() + "_ENTRY"
        found = re.findall(rf"#define {macro}\(NAME, T\)\s*\\\s*"
                           r"extern \"C\" int NAME\(([^)]*)\)", text)
        assert len(found) == 1, name
        params = [p.strip(" \\\n") for p in found[0].split(",")]
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            assert (argtype is _build.ctypes.c_void_p) == ("*" in param), \
                (name, param)
            if argtype is _build.ctypes.c_int64:
                assert param.startswith("int64_t "), (name, param)
            if argtype is _build.ctypes.c_double:
                assert param.startswith("double "), (name, param)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    graphs.release()
    yield torch.device("cuda", 0)
    graphs.release()


def _random_cycle(dev, dtype, n, m, s, seed, kernels: bool):
    """A cycle after s steps of made-up history: rotations of random
    angles, an upper triangular H, a rotated rhs; not done."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                               device=dev)

    blocks = cuda_krylov._blocks(n, torch.empty(1, dtype=dtype,
                                                device=dev)) if kernels else 0
    cy = cuda_krylov._cycle(n, m, dtype, dev, blocks)
    cy.V.copy_(r(m + 1, n))
    cy.H.copy_(torch.triu(r(m + 1, m)))
    cy.H[:, s:] = 0
    ang = r(m)
    cy.cs.copy_(torch.cos(ang))
    cy.sn.copy_(torch.sin(ang))
    cy.cs[s:] = 0
    cy.sn[s:] = 0
    cy.g.copy_(r(m + 1))
    cy.g[s + 1:] = 0
    cy.hist.fill_(float("nan"))
    cy.hist[:s + 1] = r(s + 1).abs()
    cy.j.fill_(s)
    cy.done.fill_(False)
    cy.lost.fill_(False)
    cy.bnorm.fill_(3.0)
    return cy


TAIL_CASES = ["plain", "breakdown", "lost", "done"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TAIL_CASES)
@pytest.mark.parametrize("s, m", [(0, 10), (4, 10), (9, 10), (30, 60)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tail_is_the_torch_tail(cuda_device, dtype, s, m, case):
    """The kernels' tail and scale on equal (h, ||w''||^2, ||w||^2) (fed
    as one block's partials, the rest 0) against the plain tail on
    (h, sqrt, sqrt): every field bit for bit, row s+1 too."""
    n = 4096
    rng = np.random.default_rng(s)
    h = torch.as_tensor(rng.normal(size=s + 1), dtype=dtype,
                        device=cuda_device)
    w = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=cuda_device)
    ww = torch.as_tensor(4.0 + s, dtype=dtype, device=cuda_device)
    ss = torch.as_tensor(0.25, dtype=dtype, device=cuda_device)
    if case in ("breakdown", "lost"):
        ss.zero_()
    if case == "lost":
        h.zero_()
        ww.zero_()
    got = _random_cycle(cuda_device, dtype, n, m, s, 3, kernels=True)
    want = _random_cycle(cuda_device, dtype, n, m, s, 3, kernels=False)
    if case == "done":
        got.done.fill_(True)
        want.done.fill_(True)
    parts = got.parts.zero_()
    parts[:s + 1, 0] = h
    parts[s + 1, 0] = ww
    parts[2 * m + 1, 0] = ss
    got.V[s + 1] = w           # what pass 3 would have written there
    want.V[s + 1] = w
    tol = 1e-4
    blocks = parts.shape[1]
    cuda_krylov._launch("givens_tail", w, parts.data_ptr(),
                        *cuda_krylov._ptrs(got, "H", "cs", "sn", "g", "hist",
                                           "j", "done", "lost", "bnorm",
                                           "scal"),
                        s, m, blocks, tol, cuda_krylov._lost_tol(dtype))
    cuda_krylov._launch("basis_scale", w, got.V.data_ptr(),
                        got.scal.data_ptr(), n, s, m, blocks)
    cuda_krylov.tail_reference(want, w, h, torch.sqrt(ss), torch.sqrt(ww), s,
                               tol, want.bnorm)
    torch.cuda.synchronize()
    assert_same_state(got, want, case)
    assert (int(got.j), bool(got.lost)) == {
        "plain": (s + 1, False), "breakdown": (s + 1, False),
        "lost": (s, True), "done": (s, False)}[case]


# the projection check's inputs: rows TILT off orthogonal and a w OFF of
# its norm off their span, so that the second CGS pass takes about
# TILT ||w|| off h and the projection cancels w to OFF ||w||; h and the
# norms held to TOL_H eps of ||w||, row s+1 entry by entry to TOL_ROW eps
# of w's root-mean-square entry (sums of up to 17 M products in another
# order)
TILT, OFF = 1e-2, 1e-3
TOL_H, TOL_ROW = 8, 64


def _projection_inputs(dev, dtype, N, s, seed):
    """Unit rows Z + TILT E Z (Z random unit rows, E random) and
    w = c V + OFF ||c|| u (u a random unit vector), made in f64."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=F64, device=dev, generator=gen)
    Z = torch.randn(s + 1, N, **f64)
    Z /= Z.norm(dim=1, keepdim=True)
    E = torch.randn(s + 1, s + 1, **f64) / (s + 1) ** 0.5
    V = Z + TILT * (E @ Z)
    V /= V.norm(dim=1, keepdim=True)
    c = torch.randn(s + 1, **f64)
    u = torch.randn(N, **f64)
    return V.to(dtype), (c @ V + OFF * c.norm() / u.norm() * u).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n, m, s", [(1024, 10, 0), (1024, 10, 4),
                                     (1024, 10, 9), (2048, 10, 0),
                                     (2048, 10, 4), (2048, 10, 9),
                                     (128, 60, 13), (128, 60, 30),
                                     (128, 60, 59)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_projection_agrees_with_plain(cuda_device, dtype, n, m, s):
    """CGS2 on rows 0..s at the inner solve's length 4 n^2 (budget 60:
    rows past a register tile): the kernels' h, ||w''||, ||w|| and row
    s+1 (before its scale) against `project_reference`. The inputs make
    every pass count: a second pass left out would move h by about
    TILT ||w|| (s >= 1), a third by ||w||."""
    if dtype == F64 and n == 2048 and s != 9:
        pytest.skip("f64 at 2048^2: s = 9 covers it")
    N = 4 * n * n
    rows, w = _projection_inputs(cuda_device, dtype, N, s, seed=s)
    blocks = cuda_krylov._blocks(N, w)
    cy = cuda_krylov._cycle(N, m, dtype, cuda_device, blocks)
    cy.V[:s + 1] = rows
    cy.done.fill_(False)
    for name in ("cgs2_dots", "cgs2_reorth", "cgs2_update"):
        cuda_krylov._launch(name, w, cy.V.data_ptr(), w.data_ptr(),
                            cy.done.data_ptr(), cy.parts.data_ptr(), N, s,
                            m, blocks)
    want_w, want_h, want_norm, want_pre = cuda_krylov.project_reference(
        cy.V, w, s)
    parts = cy.parts.double()
    got = torch.cat([parts[:s + 1].sum(1) + parts[m + 1:m + 2 + s].sum(1),
                     parts[2 * m + 1].sum().sqrt()[None],
                     parts[s + 1].sum().sqrt()[None]])
    want = torch.cat([want_h, want_norm[None], want_pre[None]]).double()
    eps, scale = torch.finfo(dtype).eps, float(want_pre)
    err_h = float((got - want).abs().max()) / (eps * scale)
    err_row = float((cy.V[s + 1] - want_w).double().abs().max()) \
        / (eps * scale / N ** 0.5)
    assert err_h <= TOL_H and err_row <= TOL_ROW, (err_h, err_row)
    # the inputs' power: the cancellation, and the second pass's share
    h2 = want_h.double() - (rows[:s + 1] @ w).double()
    assert float(want_norm) <= 10 * OFF * scale
    if s:
        assert float(h2.abs().max()) >= 100 * TOL_H * eps * scale


@pytest.mark.gpu
@pytest.mark.parametrize("inner", ["mg", "jacobi"])
def test_gmres_fixed_on_f_reaches_the_plain_count(cuda_device, inner):
    """The hybrid PC's F inner at 1024^2 in f32 (budget 10, tol 1e-4, one
    velocity V-cycle as M), and `lsc_krylov`'s at 128^2 in f64 (budget 60,
    tol 1e-6, Jacobi as M: rows past a register tile): K13's count within
    1 of the plain version's, and its true relative residual within 1.5 x
    the plain one's (or tol), with 5 launches a step run and 3 a cycle."""
    n, dtype, tol, budget = ((1024, F32, 1e-4, 10) if inner == "mg"
                             else (128, F64, 1e-6, 60))
    op = make_multiphase_operator(n, eta_n=100.0, dtype=dtype,
                                  device=cuda_device)
    F = make_f_apply(op)
    if inner == "mg":
        M = MGVelocitySolver.of(op, cycles=1)
    else:
        d = torch.cat([op.F.terms[(f, f)][(0, 0)].reshape(-1)
                       for f in op.F.out_fields])
        M = lambda v: v / d               # noqa: E731
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b = torch.randn(4 * n * n, dtype=dtype, device=cuda_device,
                    generator=gen)

    def solve():
        res = krylov.gmres_fixed(F, b, tol=tol, maxiter=budget, M=M)
        rel = float((b - F(res.x)).norm() / b.norm())
        return int(res.iters), rel

    before = dict(cuda_krylov.LAUNCHES)
    got_iters, got_rel = solve()
    launched = {k: cuda_krylov.LAUNCHES[k] - before[k] for k in before}
    with cuda_krylov.plain():
        want_iters, want_rel = solve()
    assert abs(got_iters - want_iters) <= 1
    assert got_rel <= 1.5 * max(want_rel, tol)
    steps = launched["cgs2_dots"]
    assert steps in (got_iters, got_iters + 1)     # + a lost step
    assert launched == {**{k: steps for k in ("cgs2_dots", "cgs2_reorth",
                                              "cgs2_update", "givens_tail",
                                              "basis_scale")},
                        **{k: 1 for k in ("cycle_norms", "cycle_start",
                                          "cycle_solution")}}


def _hybrid_pc(dev, n, shift=(0, 0)):
    base = make_multiphase_operator(n, device=dev).phase_n
    planes = {k: torch.roll(getattr(base, k), shift, (0, 1))
              for k in ("cell", "xface_pt", "yface_pt")}
    kw = dict(eta_n=100.0, device=dev, theta_planes=planes)
    op64 = make_multiphase_operator(n, **kw)
    op32 = make_multiphase_operator(n, dtype=F32, **kw)
    return make_preconditioner_mixed(op64, op32, "lsc_mg_full")


def _vector(n, dev):
    return torch.as_tensor(np.random.default_rng(0).normal(size=5 * n * n),
                           device=dev)


@pytest.mark.gpu
def test_eager_if_graph_and_masked_are_bit_equal(cuda_device):
    """The 256^2 hybrid PC with K13: its eager apply, its IF graph's
    replays and its masked graph's replays give the same bits; an IF
    replay counts 5 K13 launches an inner step run and 3 an inner cycle,
    as the eager apply did."""
    n = 256
    M, v = _hybrid_pc(cuda_device, n), _vector(n, cuda_device)
    before = dict(cuda_krylov.LAUNCHES)
    with graphs.disabled():
        eager = M(v)
    torch.cuda.synchronize()
    per_eager = {k: cuda_krylov.LAUNCHES[k] - before[k] for k in before}
    g = graphs.GraphedApply(M)
    g(v)
    counted, ran = dict(cuda_krylov.LAUNCHES), g.steps_run
    replayed = g(v)
    torch.cuda.synchronize()
    per_replay = {k: cuda_krylov.LAUNCHES[k] - counted[k] for k in counted}
    steps, cycles = g.steps_run - ran, per_replay["cycle_start"]
    assert torch.equal(replayed, eager) and per_replay == per_eager
    assert steps > 0 and cycles > 0
    assert sum(per_replay.values()) == 5 * steps + 3 * cycles
    with graphs.masked():
        gm = graphs.GraphedApply(M)
        gm(v)
        assert torch.equal(gm(v), eager)
    assert torch.equal(g(v), eager)


@pytest.mark.gpu
def test_forty_captures_in_a_row(cuda_device):
    """40 IF-graph captures of a K13 cycle in a row, each replaying the
    eager solve's bits (no body stream was the capture's own)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    d = torch.rand(4096, dtype=F32, device=cuda_device, generator=gen) + 1
    b = torch.randn(4096, dtype=F32, device=cuda_device, generator=gen)

    def apply(v):
        return krylov.gmres_fixed(lambda x: d * x, v, tol=1e-6,
                                  maxiter=6).x

    eager = apply(b)
    for _ in range(40):
        g = graphs.GraphedApply(apply)
        g(b)
        assert g.gated_steps == 6 and torch.equal(g(b), eager)


@pytest.mark.gpu
def test_moving_pc_adopts_the_released_graph(cuda_device):
    """Steps that each release the last step's PC and build one from a
    moved theta: every step after the first adopts the released graph,
    and from the third on a step allocates no device memory."""
    n, v = 64, _vector(64, cuda_device)
    G = None
    for k, shift in enumerate([(0, 0), (3, 5), (-7, 2), (11, -4)]):
        G = None
        gc.collect()
        mallocs = torch.cuda.memory_stats(cuda_device).get(
            "num_device_alloc", 0)
        with metrics.tracing() as t:
            G = graphs.GraphedApply(_hybrid_pc(cuda_device, n, shift))
            out = G(v)
        torch.cuda.synchronize()
        assert t.counters.get("graph.adoptions", 0) == (k > 0)
        if k >= 2:
            assert torch.cuda.memory_stats(cuda_device).get(
                "num_device_alloc", 0) == mallocs
        with graphs.disabled():
            assert torch.equal(out, G.apply(v))
        del out
        _build.settle_deferred()
