"""Kernels K9-K12 (`mpbp_tpu_torch/ops/cuda_mg.py`): the multigrid's
compiled loops as one launch each.

On the CPU each wrapper runs its plain version, held here against the JAX
function it replaces (built from the same theta planes, seeded inputs at
n = 16-64):
  * K9 `p_sweep`: `_smooth`;
  * K10 `p_restrict` / `p_correct`: restrict_cell(b - A x),
    x + prolong_cell(ec) (and the solvers' plain mean projection);
  * K11 `f_sweep` / `f_residual`: `_vel_smooth`, b - F x;
  * K12 `vel_restrict` / `vel_prolong`: `_restrict_vel`, x + `_prolong_vel`;
  * a pressure and a velocity V-cycle, `MGPressureSolver` and
    `MGVelocitySolver`, through the wrappers.
Tolerances, of max|y|: f64 1e-13 (the same operations in the same order;
XLA:CPU may contract a product and a sum into one FMA and sums the 2x2
mean in its own order, a few ulps), f32 1e-5 (the same, at f32's ulp,
amplified by the difference-form cancellation over a V-cycle's sweeps:
up to 2.4e-6 measured at n=32).

Also: the solvers call the wrappers (a spy); the wrappers refuse a wrong
dtype, shape or a non-contiguous input before any device work, and reach
the device check only with right ones (on the meta device, which has no
kernel); `plain()` restores its flag; each C entry point's argtypes match
its signature.

On the card (`gpu`, skipped here): each kernel bit-equal to its plain
version at the level sizes of a hierarchy; both MG solvers equal with the
kernels and with the plain code; a captured IF-graph PC apply with K9-K12
bit-equal to the eager apply; 40 IF-graph captures in a row, each body
stream apart from the capture's own (PyTorch's stream pool hands its
streams out again). JAX is imported inside the tests that
compare with it, so the `gpu` tests also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_mg_kernels.py
"""

import re

import numpy as np
import pytest
import torch

from mpbp_tpu_torch.drivers import make_preconditioner_mixed
from mpbp_tpu_torch.models.multiphase import (make_multiphase_operator,
                                              operator_from_numpy)
from mpbp_tpu_torch.ops import _build, cuda_mg
from mpbp_tpu_torch.solvers import graphs
from mpbp_tpu_torch.solvers import multigrid as mg

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
TOL = {F64: 1e-13, F32: 1e-5}
VEL = ("un", "vn", "us", "vs")
DTYPES = [F64, F32]


def jax_modules():
    import jax.numpy as jnp

    from mpbp_tpu.models.multiphase import make_multiphase_operator as jmk
    from mpbp_tpu.solvers import multigrid as jmg
    return jnp, jmk, jmg


def operators(n, dtype):
    """The JAX operator at n (eta_n 100) and the port's from its planes."""
    jnp, jmk, _ = jax_modules()
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    jop = jmk(n, eta_n=100.0, dtype=jdt)
    top = operator_from_numpy(np.asarray(jop.phase_n.cell),
                              np.asarray(jop.phase_n.xface_pt),
                              np.asarray(jop.phase_n.yface_pt), jop.params,
                              device="cpu", dtype=dtype)
    return top, jop, (lambda a: jnp.asarray(a, jdt))


def close(got, want, dtype):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= TOL[dtype], err


def stacked(d):
    return np.stack([np.asarray(d[f]) for f in VEL])


def fields(J, a):
    return {f: J(a[i]) for i, f in enumerate(VEL)}


def seeded(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


# --------------------------------------------------------------------------
# the plain versions against the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_p_sweep_matches_jax_smooth(dtype, n):
    top, jop, J = operators(n, dtype)
    _, _, jmg = jax_modules()
    tl, jl = mg.build_pressure_mg(top), jmg.build_pressure_mg(jop)
    x, b = seeded((n, n), 0), seeded((n, n), 1)
    got = mg._smooth(tl[0], torch.as_tensor(b, dtype=dtype),
                     torch.as_tensor(x, dtype=dtype), 2)
    close(got, jmg._smooth(jl[0], J(b), J(x), 2, 0.8), dtype)
    # one wrapper call is one sweep of the same function
    f = tl[0].flux
    one = cuda_mg.p_sweep(torch.as_tensor(x, dtype=dtype),
                          torch.as_tensor(b, dtype=dtype), f.rowsum,
                          f.planes, f.offsets, tl[0].inv_d)
    close(one, jmg._smooth(jl[0], J(b), J(x), 1, 0.8), dtype)


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_p_restrict_matches_jax(dtype, n):
    top, jop, J = operators(n, dtype)
    _, _, jmg = jax_modules()
    tl, jl = mg.build_pressure_mg(top), jmg.build_pressure_mg(jop)
    x, b = seeded((n, n), 2), seeded((n, n), 3)
    f = tl[0].flux
    got = cuda_mg.p_restrict(torch.as_tensor(x, dtype=dtype),
                             torch.as_tensor(b, dtype=dtype), f.rowsum,
                             f.planes, f.offsets)
    assert got.shape == (n // 2, n // 2)
    close(got, jmg.restrict_cell(J(b) - jl[0].apply_p(J(x))), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_p_correct_and_project_match_jax(dtype):
    """K10's correction; and the pressure solver's mean projection (one
    PyTorch `sub` after the mean, no kernel) on an rhs whose mean is 50
    times its spread, so that a wrong projection shows."""
    n = 32
    top, jop, J = operators(n, dtype)
    _, _, jmg = jax_modules()
    x, ec = seeded((n, n), 4), seeded((n // 2, n // 2), 5)
    xt = torch.as_tensor(x, dtype=dtype)
    got = cuda_mg.p_correct(xt, torch.as_tensor(ec, dtype=dtype))
    close(got, J(x) + jmg.prolong_cell(J(ec)), dtype)
    got = mg.MGPressureSolver.of(top, cycles=1)(xt + 50.0)
    close(got, jmg.MGPressureSolver.of(jop, cycles=1)(J(x + 50.0)), dtype)


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_f_sweep_matches_jax_vel_smooth(dtype, n):
    top, jop, J = operators(n, dtype)
    _, _, jmg = jax_modules()
    tl, jl = mg.build_velocity_mg(top), jmg.build_velocity_mg(jop)
    x, b = seeded((4, n, n), 6), seeded((4, n, n), 7)
    got = mg._vel_smooth(tl[0], torch.as_tensor(b, dtype=dtype),
                         torch.as_tensor(x, dtype=dtype), 2)
    want = jmg._vel_smooth(jl[0], fields(J, b), fields(J, x), 2, 0.7)
    close(got, stacked(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_f_residual_matches_jax(dtype):
    n = 32
    top, jop, J = operators(n, dtype)
    _, _, jmg = jax_modules()
    tl, jl = mg.build_velocity_mg(top), jmg.build_velocity_mg(jop)
    x, b = seeded((4, n, n), 8), seeded((4, n, n), 9)
    f = tl[0].flux
    got = cuda_mg.f_residual(f.tn, f.wnx, f.wny,
                             torch.as_tensor(x, dtype=dtype),
                             torch.as_tensor(b, dtype=dtype), f.params, f.dx,
                             f.dy)
    fx = jl[0].apply(fields(J, x))
    close(got, stacked({f: J(b[i]) - fx[f] for i, f in enumerate(VEL)}),
          dtype)


@pytest.mark.parametrize("which", ["restrict", "prolong"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_vel_transfers_match_jax(dtype, which):
    import jax.numpy as jnp
    _, _, jmg = jax_modules()
    n = 32
    J = (lambda a: jnp.asarray(a, jnp.float64 if dtype == F64
                               else jnp.float32))
    x, ec = seeded((4, n, n), 10), seeded((4, n // 2, n // 2), 11)
    if which == "restrict":
        got = cuda_mg.vel_restrict(torch.as_tensor(x, dtype=dtype))
        want = stacked(jmg._restrict_vel(fields(J, x)))
    else:
        got = cuda_mg.vel_prolong(torch.as_tensor(x, dtype=dtype),
                                  torch.as_tensor(ec, dtype=dtype))
        pe = jmg._prolong_vel(fields(J, ec))
        want = stacked({f: J(x[i]) + pe[f] for i, f in enumerate(VEL)})
    close(got, want, dtype)


@pytest.mark.parametrize("kind", ["pressure", "velocity"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_v_cycle_matches_jax(dtype, kind):
    n = 32
    top, jop, J = operators(n, dtype)
    _, _, jmg = jax_modules()
    if kind == "pressure":
        tl, jl = mg.build_pressure_mg(top), jmg.build_pressure_mg(jop)
        x, b = seeded((n, n), 12), seeded((n, n), 13)
        got = mg.v_cycle(tl, torch.as_tensor(b, dtype=dtype),
                         torch.as_tensor(x, dtype=dtype))
        want = jmg.v_cycle(jl, J(b), J(x))
    else:
        tl, jl = mg.build_velocity_mg(top), jmg.build_velocity_mg(jop)
        x, b = seeded((4, n, n), 14), seeded((4, n, n), 15)
        got = mg.vel_v_cycle(tl, torch.as_tensor(b, dtype=dtype),
                             torch.as_tensor(x, dtype=dtype))
        want = stacked(jmg.vel_v_cycle(jl, fields(J, b), fields(J, x)))
    close(got, want, dtype)


@pytest.mark.parametrize("kind", ["pressure", "velocity"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mg_solvers_match_jax(dtype, kind):
    n = 64
    top, jop, J = operators(n, dtype)
    _, _, jmg = jax_modules()
    if kind == "pressure":
        rhs = seeded(n * n, 16)
        got = mg.MGPressureSolver.of(top, cycles=3)(
            torch.as_tensor(rhs, dtype=dtype))
        want = jmg.MGPressureSolver.of(jop, cycles=3)(J(rhs))
    else:
        rhs = seeded(4 * n * n, 17)
        got = mg.MGVelocitySolver.of(top, cycles=1)(
            torch.as_tensor(rhs, dtype=dtype))
        want = jmg.MGVelocitySolver.of(jop, cycles=1)(J(rhs))
    close(got, want, dtype)


# --------------------------------------------------------------------------
# the solvers call the wrappers; the levels keep inv_d
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["pressure", "velocity"])
def test_solvers_call_the_wrappers(kind, monkeypatch):
    """Every sweep, residual and transfer of a solve goes through its
    wrapper: at n=32 the hierarchy has smoothing levels 32, 16
    (8 is the pseudo-inverse), each cycle 2 + 2 sweeps a level."""
    calls = dict.fromkeys(cuda_mg.LAUNCHES, 0)
    for name in calls:
        real = getattr(cuda_mg, name)

        def spy(*args, _name=name, _real=real):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(cuda_mg, name, spy)
    op = make_multiphase_operator(32, eta_n=100.0, device="cpu")
    if kind == "pressure":
        solver = mg.MGPressureSolver.of(op, cycles=3)
        solver(torch.ones(32 * 32, dtype=F64).cumsum(0))
        want = dict(p_sweep=3 * 2 * 4, p_restrict=3 * 2, p_correct=3 * 2)
    else:
        solver = mg.MGVelocitySolver.of(op, cycles=2)
        solver(torch.ones(4 * 32 * 32, dtype=F64).cumsum(0))
        want = dict(f_sweep=2 * 2 * 4, f_residual=2 * 2, vel_restrict=2 * 2,
                    vel_prolong=2 * 2)
    assert {k: v for k, v in calls.items() if v} == want


def test_levels_keep_inv_d():
    """inv_d is the expression each sweep evaluated before, so the same
    bits; coarsest levels (a pseudo-inverse) have none."""
    op = make_multiphase_operator(32, eta_n=100.0, device="cpu",
                                  dtype=F32)
    for levels, damping in ((mg.build_pressure_mg(op), 0.8),
                            (mg.build_velocity_mg(op), 0.7)):
        for level in levels[:-1]:
            assert torch.equal(level.inv_d, damping / level.diag)
        assert levels[-1].inv_d is None


def test_plain_restores_the_flag():
    assert not cuda_mg._plain
    with pytest.raises(RuntimeError):
        with cuda_mg.plain():
            assert cuda_mg._plain
            raise RuntimeError("inside")
    assert not cuda_mg._plain


# --------------------------------------------------------------------------
# the wrappers' checks, before any device work
# --------------------------------------------------------------------------
N = 8
PARAMS = dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0, eta_s=1.0)
OFFS = ((0, 1), (0, -1), (1, 0), (-1, 0))


def _args(name: str, device: str, fault: str | None = None):
    """A call of wrapper `name` on `device`, right or with one `fault`:
    'dtype' (float16 input), 'shape' (one operand a row short) or
    'contiguous' (the input a transposed view)."""
    def t(*shape, dtype=F64):
        return torch.zeros(shape, dtype=dtype, device=device)

    grid = name.startswith("p_")
    x = t(N, N) if grid else t(4, N, N)
    if fault == "dtype":
        x = x.to(torch.float16)
    elif fault == "contiguous":
        x = x.transpose(-1, -2)
    short = (N - 1, N) if fault == "shape" else (N, N)
    rowsum, plane = t(N, N), t(*short)
    args = {
        "p_sweep": (x, plane, rowsum, t(4, N, N), OFFS, t(N, N)),
        "p_restrict": (x, plane, rowsum, t(4, N, N), OFFS),
        "p_correct": (x, t(N // 2, N // 2 - (fault == "shape"))),
        "f_sweep": (plane, t(N, N), t(N, N), x, t(4, N, N), t(4, N, N),
                    PARAMS, 0.1, 0.1),
        "f_residual": (plane, t(N, N), t(N, N), x, t(4, N, N), PARAMS, 0.1,
                       0.1),
        "vel_restrict": (x[:, :-1] if fault == "shape" else x,),
        "vel_prolong": (x, t(4, N // 2, N // 2 - (fault == "shape"))),
    }
    return args[name]


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous"])
@pytest.mark.parametrize("name", list(cuda_mg.LAUNCHES))
def test_wrappers_refuse_before_device_work(name, fault):
    """On the meta device (no kernel) a faulty call raises its own error,
    not the device's, and launches nothing."""
    before = dict(cuda_mg.LAUNCHES)
    with pytest.raises((TypeError, ValueError)) as info:
        getattr(cuda_mg, name)(*_args(name, "meta", fault))
    assert "no kernel" not in str(info.value)
    assert dict(cuda_mg.LAUNCHES) == before


@pytest.mark.parametrize("name", list(cuda_mg.LAUNCHES))
def test_right_calls_reach_the_device_check(name):
    with pytest.raises(ValueError, match="no kernel for device meta"):
        getattr(cuda_mg, name)(*_args(name, "meta"))
    with cuda_mg.plain():        # the plain version takes the same call
        out = getattr(cuda_mg, name)(*_args(name, "cpu"))
    assert out.dtype == F64


def test_offsets_are_checked():
    x = torch.zeros((N, N), dtype=F64)
    planes = torch.zeros((13, N, N), dtype=F64)
    with pytest.raises(ValueError, match="at most 12"):
        cuda_mg.p_sweep(x, x, x, planes, ((0, 1),) * 13, x)
    with pytest.raises(ValueError, match="reach past"):
        cuda_mg.p_restrict(x, x, x, planes[:1], ((0, N + 1),))


def test_mg_stencil_argtypes_match_the_c_signatures():
    """Each entry point of mg_stencil.cu has argtypes of as many entries as
    its C definition has parameters, a pointer where it takes one."""
    text = _build.source_path("mg_stencil").read_text()
    for name, argtypes in _build.SOURCES["mg_stencil"].items():
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


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _kernel_calls(levels, vlevels, dev, dtype, seed=0):
    """(name, call) of every wrapper at each level of the two
    hierarchies, on seeded inputs."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                               device=dev)

    calls = []
    for lv in levels[:-1]:
        n, f = lv.n, lv.flux
        x, b = r(n, n), r(n, n)
        calls += [
            ("p_sweep", lambda x=x, b=b, f=f, lv=lv: cuda_mg.p_sweep(
                x, b, f.rowsum, f.planes, f.offsets, lv.inv_d)),
            ("p_restrict", lambda x=x, b=b, f=f: cuda_mg.p_restrict(
                x, b, f.rowsum, f.planes, f.offsets)),
            ("p_correct", lambda x=x, e=r(n // 2, n // 2):
             cuda_mg.p_correct(x, e))]
    for lv in vlevels[:-1]:
        n = lv.n
        x, b, f = r(4, n, n), r(4, n, n), lv.flux
        calls += [
            ("f_sweep", lambda x=x, b=b, f=f, lv=lv: cuda_mg.f_sweep(
                f.tn, f.wnx, f.wny, x, b, lv.inv_d, f.params, f.dx, f.dy)),
            ("f_residual", lambda x=x, b=b, f=f: cuda_mg.f_residual(
                f.tn, f.wnx, f.wny, x, b, f.params, f.dx, f.dy)),
            ("vel_restrict", lambda x=x: cuda_mg.vel_restrict(x)),
            ("vel_prolong", lambda x=x, e=r(4, n // 2, n // 2):
             cuda_mg.vel_prolong(x, e))]
    return calls


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_are_bit_equal_to_plain(cuda_device, dtype, n):
    op = make_multiphase_operator(n, eta_n=100.0, dtype=dtype,
                                  device=cuda_device)
    calls = _kernel_calls(mg.build_pressure_mg(op), mg.build_velocity_mg(op),
                          cuda_device, dtype)
    for name, call in calls:
        before = cuda_mg.LAUNCHES[name]
        got = call()
        assert cuda_mg.LAUNCHES[name] == before + 1, name
        with cuda_mg.plain():
            want = call()
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, got.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pressure", "velocity"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mg_solvers_equal_with_kernels_and_plain(cuda_device, dtype, kind):
    n = 128
    op = make_multiphase_operator(n, eta_n=100.0, dtype=dtype,
                                  device=cuda_device)
    if kind == "pressure":
        solver, size = mg.MGPressureSolver.of(op, cycles=3), n * n
    else:
        solver, size = mg.MGVelocitySolver.of(op, cycles=1), 4 * n * n
    v = torch.as_tensor(seeded(size, 18), dtype=dtype, device=cuda_device)
    got = solver(v)
    with cuda_mg.plain():
        want = solver(v)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_graphed_apply_with_mg_kernels_is_eager(cuda_device):
    """The n=64 hybrid lsc_mg_full PC as an IF graph: replays bit-equal to
    the eager apply, each replay counting the eager apply's K9-K12
    launches; the plain-code graph (captured inside `plain()`) gives the
    same bits with none."""
    kw = dict(eta_n=100.0, device=cuda_device)
    M = make_preconditioner_mixed(make_multiphase_operator(64, **kw),
                                  make_multiphase_operator(
                                      64, dtype=F32, **kw), "lsc_mg_full")
    v = torch.as_tensor(seeded(5 * 64 * 64, 19), device=cuda_device)
    before = dict(cuda_mg.LAUNCHES)
    eager = M(v)
    per_eager = {k: cuda_mg.LAUNCHES[k] - before[k] for k in before}
    g = graphs.GraphedApply(M)
    g(v)
    counted = dict(cuda_mg.LAUNCHES)
    replayed = g(v)
    torch.cuda.synchronize()
    per_replay = {k: cuda_mg.LAUNCHES[k] - counted[k] for k in counted}
    assert torch.equal(replayed, eager)
    assert per_replay == per_eager and all(per_eager.values())
    with cuda_mg.plain():
        gp = graphs.GraphedApply(M)
        gp(v)
    counted = dict(cuda_mg.LAUNCHES)
    assert torch.equal(gp(v), eager)
    assert dict(cuda_mg.LAUNCHES) == counted


@pytest.mark.gpu
def test_captures_keep_their_bodies_off_the_capture_stream(cuda_device):
    """PyTorch hands out its pool's 32 streams round-robin, and a
    capture's IF bodies are captured on pool streams: 40 IF-graph captures
    in a row (each asks the pool for two or more streams) each replay the
    eager solve, so no body stream was ever the capture's own."""
    from mpbp_tpu_torch.solvers import gmres as krylov

    A = torch.diag(torch.arange(1.0, 9.0, dtype=F64, device=cuda_device))
    b = torch.ones(8, dtype=F64, device=cuda_device)

    def apply(v):
        return krylov.gmres_fixed(lambda x: A @ x, v, maxiter=4).x

    eager = apply(b)
    for _ in range(40):
        g = graphs.GraphedApply(apply)
        g(b)
        assert g.gated_steps > 0 and torch.equal(g(b), eager)
