"""The port's device-resident Krylov loop and its CUDA-graph preconditioner
(`solvers/gmres.py` `gmres_fixed` / `cg_fixed`, `solvers/graphs.py`):

  (a) a preconditioner apply and a KrylovInner solve read nothing back to
      the host (every Tensor-to-host conversion raises inside the guard);
  (b) the fixed-budget gmres and cg against the JAX package's on seeded
      systems, one that converges inside the budget and one that uses it;
  (c) the fixed-budget cycle against the early-exit one;
  (d) finite x after an exact breakdown and after an F1 lost column;
  (e) on the card (`gpu`, skipped here): graph replay bit-equal to the
      eager apply, and an apply under sync-debug mode "error";
  (f) the ways `graphs.loop` runs a fixed budget: the eager early exit
      bit-equal to the masked budget, every state tensor written in
      place, the calls of an early-exit solve those of its steps taken,
      a count read settling the launches replays left on the device; on
      the card, the IF-node replay bit-equal to the eager apply and to
      the masked replay, with the eager apply's K1 count.

The tests of (a) run the masked budget (`graphs.masked()`): it is the
captured arithmetic without the IF nodes, and the eager early exit reads
`done` on the host once a step by design.

JAX is imported inside the tests that compare with it, so the `gpu` tests
also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_graphs.py
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from mpbp_tpu_torch import drivers
from mpbp_tpu_torch.drivers import (make_preconditioner,
                                    make_preconditioner_mixed)
from mpbp_tpu_torch.models.fused import make_f_apply
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.ops import _build, cuda_stencil
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers import graphs
from mpbp_tpu_torch.solvers.multigrid import MGPressureSolver
from mpbp_tpu_torch.solvers.preconditioners import KrylovInner
from mpbp_tpu_torch.utils import metrics

torch.set_num_threads(1)

N = 64
# every way a tensor's value reaches the host (each syncs a CUDA device)
HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
              "__int__", "__index__")


@contextlib.contextmanager
def no_host_read():
    """Every Tensor-to-host conversion raises inside the block, and so
    does a Python number written into a tensor (`t[i] = 0`: on a CUDA
    tensor a host-to-device copy, which a graph capture refuses)."""
    names = HOST_READS + ("__setitem__",)
    saved = {name: getattr(torch.Tensor, name) for name in names}

    def raiser(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"host read: Tensor.{name}")
        return read

    def setitem(self, index, value):
        if not isinstance(value, torch.Tensor):
            raise AssertionError("host copy: a Python number written "
                                 "into a tensor")
        return saved["__setitem__"](self, index, value)

    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, raiser(name))
        torch.Tensor.__setitem__ = setitem
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def nonsymmetric(seed=0):
    rng = np.random.default_rng(seed)
    A = np.diag(np.linspace(1.0, 20.0, N)) + rng.normal(size=(N, N)) / 2
    return A, rng.normal(size=N)


def spd(seed=1):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(N, N))
    return B @ B.T / N + np.diag(np.linspace(0.1, 5.0, N)), rng.normal(size=N)


def operators(n):
    kw = dict(eta_n=100.0, device="cpu")
    return (make_multiphase_operator(n, **kw),
            make_multiphase_operator(n, dtype=torch.float32, **kw))


def test_the_guard_catches_a_host_read():
    t = torch.ones(3)
    with no_host_read():
        with pytest.raises(AssertionError, match="host read"):
            float(t.sum())
        with pytest.raises(AssertionError, match="host read"):
            bool(t.sum() > 0)
        with pytest.raises(AssertionError, match="host copy"):
            t[1] = 0
        t[1] = t[0] * 2                   # a tensor value stays allowed
    assert float(t.sum()) == 4.0          # restored
    t[2] = 0


@pytest.mark.parametrize("precision,traced", [
    ("full", False), ("hybrid", False), ("full", True), ("hybrid", True)],
    ids=["full", "hybrid", "full-traced", "hybrid-traced"])
def test_lsc_mg_full_apply_reads_no_host(precision, traced):
    """(a) One lsc_mg_full PC apply at n=16, built outside the guard; also
    with the port's tracing on (`utils/metrics.py`: no span reads the
    device)."""
    op64, op32 = operators(16)
    if precision == "full":
        M = make_preconditioner(op64, "lsc_mg_full", inner_iters=40)
    else:
        M = make_preconditioner_mixed(op64, op32, "lsc_mg_full")
    v = torch.as_tensor(np.random.default_rng(0).normal(size=5 * 16 * 16))
    want = M(v)
    with (metrics.tracing() if traced else contextlib.nullcontext()) as t, \
            graphs.masked(), no_host_read():
        got = M(v)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert not traced or [s.name for s in t.spans][:2] == ["pc.lsc",
                                                           "pc.f_inner"]


@pytest.mark.parametrize("method", ["gmres", "cg"])
def test_krylov_inner_reads_no_host(method):
    """(a) KrylovInner's gmres (K1's plain version, velocity-MG PC) and cg
    (pressure GtG) calls, with the census counting on the device."""
    op, _ = operators(16)
    rng = np.random.default_rng(1)
    if method == "gmres":
        from mpbp_tpu_torch.solvers.multigrid import MGVelocitySolver
        inner = KrylovInner(make_f_apply(op), tol=1e-4, maxiter=10,
                            M=MGVelocitySolver.of(op, cycles=1))
        v = torch.as_tensor(rng.normal(size=4 * 16 * 16))
    else:
        mg = MGPressureSolver.of(op, cycles=1)
        inner = KrylovInner(lambda p: mg.levels[0].apply_p(
            p.reshape(16, 16)).reshape(-1), tol=1e-6, maxiter=30,
            method="cg")
        v = torch.as_tensor(rng.normal(size=16 * 16))
        v = v - v.mean()
    inner.census = torch.zeros(inner.maxiter + 1, dtype=torch.int64)
    with graphs.masked(), no_host_read():
        x = inner(v)
    assert bool(torch.isfinite(x).all())
    assert int(inner.census.sum()) == 1


@pytest.mark.parametrize("maxiter", [64, 10], ids=["converges", "budget"])
def test_gmres_fixed_matches_jax(maxiter):
    """(b) x within 1e-10 of max|x| of JAX's gmres, and JAX's count."""
    _gmres_vs_jax(maxiter)


def _gmres_vs_jax(maxiter):
    import jax.numpy as jnp
    from mpbp_tpu.solvers import gmres as jax_krylov

    A, b = nonsymmetric(2)
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    Mt, Mj = (torch.as_tensor(1.0 / np.diag(A)),
              jnp.asarray(1.0 / np.diag(A)))
    got = krylov.gmres_fixed(lambda v: At @ v, torch.as_tensor(b),
                             tol=1e-10, maxiter=maxiter, M=lambda v: Mt * v)
    want = jax_krylov.gmres(lambda v: Aj @ v, jnp.asarray(b), tol=1e-10,
                            maxiter=maxiter, M=lambda v: Mj * v)
    assert int(got.iters) == int(want.iters)
    assert (int(got.iters) < maxiter) == (maxiter == 64)
    wx = np.asarray(want.x)
    assert np.abs(got.x.numpy() - wx).max() <= 1e-10 * np.abs(wx).max()


@pytest.mark.parametrize("maxiter", [200, 10], ids=["converges", "budget"])
def test_cg_fixed_matches_jax(maxiter):
    """(b) x within 1e-10 of max|x| of JAX's cg, and JAX's count."""
    _cg_vs_jax(maxiter)


def _cg_vs_jax(maxiter):
    import jax.numpy as jnp
    from mpbp_tpu.solvers import gmres as jax_krylov

    A, b = spd()
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    got = krylov.cg_fixed(lambda v: At @ v, torch.as_tensor(b), tol=1e-10,
                          maxiter=maxiter)
    want = jax_krylov.cg(lambda v: Aj @ v, jnp.asarray(b),
                         x0=jnp.zeros_like(jnp.asarray(b)), tol=1e-10,
                         maxiter=maxiter)
    assert int(got.iters) == int(want.iters)
    assert (int(got.iters) < maxiter) == (maxiter == 200)
    wx = np.asarray(want.x)
    assert np.abs(got.x.numpy() - wx).max() <= 1e-10 * np.abs(wx).max()


@pytest.mark.parametrize("orthog", ["cgs2", "cgs1"])
@pytest.mark.parametrize("x0", [False, True], ids=["no_x0", "gmres"])
def test_fixed_cycle_is_the_early_exit_cycle(orthog, x0):
    """(c) The same count and x within 1e-14 of max|x|: the steps past
    convergence change nothing (GMRES, the fixed cycle's one kind; a zero
    x0 given or left out)."""
    A, b = nonsymmetric(3)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Mt = torch.as_tensor(1.0 / np.diag(A))
    mv, M = (lambda v: At @ v), (lambda v: Mt * v)
    early = krylov._cycle(mv, bt, torch.zeros_like(bt), 1e-9, N, M, False,
                          orthog)
    fixed = krylov._fixed_cycle(mv, bt, torch.zeros_like(bt) if x0 else None,
                                1e-9, N, M, orthog)
    assert early.converged and 5 < early.iters < N
    assert int(fixed.iters) == early.iters
    scale = float(early.x.abs().max())
    assert float((fixed.x - early.x).abs().max()) <= 1e-14 * scale


def test_cg_fixed_is_the_early_exit_cg():
    """(c) for cg: the same count and x within 1e-14 of max|x|."""
    A, b = spd(2)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    early = krylov.cg(lambda v: At @ v, bt, tol=1e-9, maxiter=N)
    fixed = krylov.cg_fixed(lambda v: At @ v, bt, tol=1e-9, maxiter=N)
    assert early.converged and int(fixed.iters) == early.iters < N
    scale = float(early.x.abs().max())
    assert float((fixed.x - early.x).abs().max()) <= 1e-14 * scale


def test_exact_breakdown_at_the_first_step_stays_finite():
    """(d) b an eigenvector of A: the first column breaks down exactly
    (H nonsingular, an exact solve), and the 7 masked steps after it leave
    x finite and exact."""
    A = np.diag(np.arange(1.0, 13.0))
    b = np.zeros(12)
    b[4] = 2.0
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    res = krylov.gmres_fixed(lambda v: At @ v, bt, tol=1e-12, maxiter=8)
    assert int(res.iters) == 1
    assert bool(torch.isfinite(res.x).all())
    np.testing.assert_allclose(res.x.numpy(), b / np.diag(A), atol=1e-15)
    cg = krylov.cg_fixed(lambda v: At @ v, bt, tol=1e-12, maxiter=8)
    assert int(cg.iters) == 1 and bool(torch.isfinite(cg.x).all())


def test_lost_column_inside_a_fixed_budget_stays_finite():
    """(d) F1 inside a fixed budget of 8: a variable preconditioner whose
    later directions repeat its first loses column 2 (A z_1 = 3 A z_0, so
    H is singular); the masked steps after it leave x finite and equal to
    the early-exit cycle's."""
    rng = np.random.default_rng(4)
    A = np.diag(np.arange(1.0, 13.0)) + rng.normal(size=(12, 12)) / 4
    At, bt = torch.as_tensor(A), torch.as_tensor(rng.normal(size=12))

    def repeating():
        first = []

        def M(v):
            if not first:
                first.append(v.clone())
                return v
            return 3.0 * first[0]
        return M

    args = (lambda v: At @ v, bt, torch.zeros_like(bt), 1e-8, 8)
    early = krylov._cycle(*args, repeating(), False)
    fixed = krylov._fixed_cycle(*args, repeating())
    assert not early.converged and early.iters == int(fixed.iters) == 1
    assert bool(torch.isfinite(fixed.x).all())
    assert torch.allclose(fixed.x, early.x, rtol=0, atol=1e-14)


def test_graphed_apply_runs_eagerly_on_the_cpu():
    """No CPU graph: the wrapper calls the apply, captures nothing, and
    `graph_pc` leaves a CPU preconditioner as it is."""
    calls = []
    g = graphs.GraphedApply(lambda v: calls.append(1) or 2 * v)
    v = torch.ones(4)
    assert torch.equal(g(v), 2 * v) and torch.equal(g(v), 2 * v)
    assert len(calls) == 2 and g.graph is None
    with graphs.disabled():
        assert torch.equal(g(v), 2 * v)
    M = make_preconditioner(operators(8)[0], "lsc_mg_full")
    assert drivers.graph_pc(M, "lsc_mg_full", "cpu") is M
    assert drivers.graph_pc(None, "none", "cuda") is None


def test_disabled_restores_the_flag():
    with pytest.raises(RuntimeError):
        with graphs.disabled():
            assert graphs._disabled
            raise RuntimeError("inside")
    assert not graphs._disabled


def test_exact_schur_stays_eager_and_reads_the_host():
    """exact_schur's inner GMRES exits on its own stop test, a host read:
    the guard catches it, and `graph_pc` leaves the kind eager."""
    op, _ = operators(6)
    M = make_preconditioner(op, "exact_schur")
    v = torch.as_tensor(np.random.default_rng(5).normal(size=5 * 36))
    with no_host_read(), pytest.raises(AssertionError, match="host read"):
        M(v)
    assert "exact_schur" in drivers.EAGER_KINDS
    assert drivers.graph_pc(M, "exact_schur", "cuda") is M


@pytest.mark.parametrize("kind", ["lsc_ilut", "lsc_ilu0", "lsc_mg",
                                  "lsc_krylov", "lsc_mg_krylov",
                                  "block_diag", "block_tri"])
def test_every_graphed_kind_reads_no_host(kind):
    """Every kind `graph_pc` captures on the card passes the guard."""
    assert kind not in drivers.EAGER_KINDS
    op, _ = operators(8)
    M = make_preconditioner(op, kind, inner_iters=20)
    v = torch.as_tensor(np.random.default_rng(6).normal(size=5 * 64))
    with graphs.masked(), no_host_read():
        assert M(v).shape == v.shape


# --------------------------------------------------------------------------
# (f) the ways of graphs.loop (the card's IF nodes at the end)
# --------------------------------------------------------------------------
BUDGETS = {"gmres": (64, 10), "cg": (200, 10)}


def _fixed_solve(method, maxiter, census=None, matvec_calls=None,
                 M_calls=None):
    """A seeded fixed-budget solve through KrylovInner (`census`) or
    gmres_fixed / cg_fixed; the calls of matvec and M are appended to the
    given lists."""
    A, b = nonsymmetric(2) if method == "gmres" else spd()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Mt = torch.as_tensor(1.0 / np.diag(A))

    def mv(v):
        if matvec_calls is not None:
            matvec_calls.append(1)
        return At @ v

    def M(v):
        if M_calls is not None:
            M_calls.append(1)
        return Mt * v

    if census is not None:
        inner = KrylovInner(mv, tol=1e-10, maxiter=maxiter, method=method,
                            M=M, census=census)
        return inner(bt), None
    fixed = krylov.gmres_fixed if method == "gmres" else krylov.cg_fixed
    res = fixed(mv, bt, tol=1e-10, maxiter=maxiter, M=M)
    return res.x, int(res.iters)


@pytest.mark.parametrize("budget", [0, 1], ids=["converges", "budget"])
@pytest.mark.parametrize("via", ["fixed", "KrylovInner"])
@pytest.mark.parametrize("method", ["gmres", "cg"])
def test_early_exit_is_the_masked_budget(method, via, budget):
    """(f) The eager loop stops at done; x, the count and the census are
    the masked budget's bits (tolerance 0)."""
    maxiter = BUDGETS[method][budget]
    runs = []
    for mode in (contextlib.nullcontext(), graphs.masked()):
        census = (torch.zeros(maxiter + 1, dtype=torch.int64)
                  if via == "KrylovInner" else None)
        with mode:
            x, iters = _fixed_solve(method, maxiter, census)
        runs.append((x, iters, census))
    (x0, it0, c0), (x1, it1, c1) = runs
    assert torch.equal(x0, x1) and it0 == it1
    if via == "KrylovInner":
        assert torch.equal(c0, c1) and int(c0.sum()) == 1
        assert (int(c0.argmax()) < maxiter) == (budget == 0)


@pytest.mark.parametrize("budget", [0, 1], ids=["converges", "budget"])
@pytest.mark.parametrize("method", ["gmres", "cg"])
def test_masked_budget_matches_jax(method, budget):
    """(f) (b) inside graphs.masked(): JAX's count, x within 1e-10 of
    max|x| of JAX's."""
    with graphs.masked():
        check = _gmres_vs_jax if method == "gmres" else _cg_vs_jax
        check(BUDGETS[method][budget])


def _tensors(state):
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)}


@pytest.mark.parametrize("method", ["gmres", "cg"])
def test_a_step_writes_the_state_in_place(method):
    """(f) trap 1 of the IF node: after live steps and a masked step past
    done, every state attribute is the tensor object it was before (a
    skipped body would leave a rebound one unwritten)."""
    A, b = nonsymmetric(3) if method == "gmres" else spd(2)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    mv, x0 = (lambda v: At @ v), torch.zeros_like(bt)
    bn = krylov._safe_bnorm(bt)
    if method == "gmres":
        st = krylov._arnoldi_init(mv, bt, x0, 1e-2, N, False, bn)

        def step(s):
            krylov._arnoldi_step(st, mv, krylov._identity, bt.shape, s,
                                 1e-2, False, "cgs2", bn)
    else:
        st = krylov._cg_init(mv, bt, x0, 1e-2, N, krylov._identity, bn,
                             None)

        def step(s):
            krylov._cg_step(st, mv, krylov._identity, s, 1e-2, bn, None)
    before = _tensors(st)
    s = 0
    while not bool(st.done):
        step(s)
        s += 1
    step(s)                                   # masked: past done
    assert 0 < s < N and int(st.j) == s
    after = _tensors(st)
    assert all(after[k] is before[k] for k in before), \
        [k for k in before if after[k] is not before[k]]


@pytest.mark.parametrize("method", ["gmres", "cg"])
def test_early_exit_calls_are_the_steps_taken(method):
    """(f) trap 4: an eager early-exit solve calls the matvec once a step
    taken (and once more for cg's residual: gmres_fixed's x0 is 0, so r0
    is b and no matvec is applied to it), and M once a step (and once more
    for gmres's solution, or cg's start), where the masked budget calls
    them for all maxiter steps; the counts of a step body times the
    steps."""
    maxiter = BUDGETS[method][0]
    calls = {}
    for label, mode in (("eager", contextlib.nullcontext()),
                        ("masked", graphs.masked())):
        mv, M = [], []
        with mode:
            _, iters = _fixed_solve(method, maxiter, matvec_calls=mv,
                                    M_calls=M)
        calls[label] = (len(mv), len(M))
    assert 0 < iters < maxiter
    residual = int(method == "cg")
    assert calls["eager"] == (residual + iters, iters + 1)
    assert calls["masked"] == (residual + maxiter, maxiter + 1)


def test_early_exit_counts_a_lost_step():
    """(f) F1 in the eager loop: the step that loses its column runs (and
    is not counted in iters), and the loop stops after it: M is called
    for the two steps and the solution."""
    rng = np.random.default_rng(4)
    A = np.diag(np.arange(1.0, 13.0)) + rng.normal(size=(12, 12)) / 4
    At, bt = torch.as_tensor(A), torch.as_tensor(rng.normal(size=12))
    first, steps = [], []

    def M(v):
        steps.append(1)
        if not first:
            first.append(v.clone())
            return v
        return 3.0 * first[0]

    res = krylov._fixed_cycle(lambda v: At @ v, bt, torch.zeros_like(bt),
                              1e-8, 8, M)
    assert int(res.iters) == 1 and len(steps) == 3


def test_a_count_read_settles_the_deferred_launches(monkeypatch):
    """A wrapper's `add` settles nothing; the next read of a count runs
    the deferred settle once (what a replayed graph's IF bodies ran)."""
    counts = _build.Launches(k=0)
    settled = []

    def settle():
        settled.append(1)
        counts.add("k", 5)

    monkeypatch.setattr(_build, "DEFERRED", [settle])
    counts.add("k")
    assert dict.__getitem__(counts, "k") == 1 and not settled
    assert counts["k"] == 6 and settled == [1]
    assert dict(counts) == {"k": 6} and settled == [1]
    _build.DEFERRED.append(settle)
    counts["k"] = 0                 # a reset settles first, then clears
    assert counts == {"k": 0} and settled == [1, 1]


def test_masked_restores_the_flag():
    with pytest.raises(RuntimeError):
        with graphs.masked():
            assert graphs._masked
            raise RuntimeError("inside")
    assert not graphs._masked


# --------------------------------------------------------------------------
# (e) on the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels "
                    "have no CPU mode)")
    return torch.device("cuda", 0)


def _hybrid_pc(dev, n):
    kw = dict(eta_n=100.0, device=dev)
    op64 = make_multiphase_operator(n, **kw)
    op32 = make_multiphase_operator(n, dtype=torch.float32, **kw)
    M = make_preconditioner_mixed(op64, op32, "lsc_mg_full")
    v = torch.as_tensor(np.random.default_rng(0).normal(size=5 * n * n),
                        device=dev)
    return M, v


@pytest.mark.gpu
def test_graph_replay_is_the_eager_apply(cuda_device):
    """The n=64 hybrid lsc_mg_full apply: the graph's first and second
    replays bit-equal to the eager apply, and K1's count grows by the
    eager apply's on every replay."""
    M, v = _hybrid_pc(cuda_device, 64)
    before = cuda_stencil.LAUNCHES["f_apply"]
    eager = M(v)
    per_apply = cuda_stencil.LAUNCHES["f_apply"] - before
    g = graphs.GraphedApply(M)
    first = g(v)
    counted = cuda_stencil.LAUNCHES["f_apply"]
    second = g(v)
    torch.cuda.synchronize()
    assert g.graph is not None and per_apply > 0
    assert cuda_stencil.LAUNCHES["f_apply"] - counted == per_apply
    assert torch.equal(first, eager) and torch.equal(second, eager)
    with graphs.disabled():
        assert torch.equal(g(v), eager)


@pytest.mark.gpu
def test_graphed_apply_makes_no_sync(cuda_device):
    """Three replays of the n=64 hybrid apply under sync-debug "error"."""
    M, v = _hybrid_pc(cuda_device, 64)
    g = graphs.GraphedApply(M)
    g(v)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [g(v) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.gpu
def test_if_replay_is_the_eager_and_the_masked_apply(cuda_device):
    """(f) The n=64 hybrid apply captured with IF nodes and captured as the
    masked budget: both replays bit-equal to the eager apply; the IF
    replay counts the eager apply's K1 launches (read after the replay,
    which settles the bodies' tallies), the masked one more; three
    replays of each under sync-debug "error"."""
    M, v = _hybrid_pc(cuda_device, 64)

    def k1(run):
        before = cuda_stencil.LAUNCHES["f_apply"]
        out = run(v)
        torch.cuda.synchronize()
        return out, cuda_stencil.LAUNCHES["f_apply"] - before

    eager, per_eager = k1(M)
    with graphs.masked():
        _, per_masked = k1(M)
        gm = graphs.GraphedApply(M)
        gm(v)
    g = graphs.GraphedApply(M)
    g(v)
    (if_out, per_if), (masked_out, per_replay) = k1(g), k1(gm)
    assert torch.equal(if_out, eager) and torch.equal(masked_out, eager)
    assert per_if == per_eager < per_masked == per_replay
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [G(v) for G in (g, gm) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.equal(o, eager) for o in outs)


@pytest.mark.gpu
def test_a_loop_captured_outside_graphed_apply_raises(cuda_device):
    """The IF node needs GraphedApply's recording: a bare capture of a
    fixed-budget solve raises instead of running a masked budget."""
    A = torch.eye(8, dtype=torch.float64, device=cuda_device) * 2
    b = torch.ones(8, dtype=torch.float64, device=cuda_device)
    krylov.gmres_fixed(lambda v: A @ v, b, maxiter=4)     # warm
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="GraphedApply"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            krylov.gmres_fixed(lambda v: A @ v, b, maxiter=4)
