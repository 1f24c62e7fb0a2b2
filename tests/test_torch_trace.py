"""The port's own spans and counters (`mpbp_tpu_torch/utils/metrics.py`),
on the `lsc_mg_full` hybrid solve at n=16 on the CPU:

  * with tracing off nothing is recorded and no profiler range is made,
    and the solve's x, count and history are the bits of a traced solve;
  * spans nest: each child inside its parent, one root id a solve and a
    build, a `krylov.step` an outer iteration, one hierarchy build of each
    kind under one `pc.build`;
  * under a CPU `torch.profiler`, each span is a range of its name;
  * on the card (`gpu`, skipped here), a 64^2 solve through a graphed PC:
    one capture with its pool's bytes, a replay's event pair an outer
    iteration, the IF bodies run within the graph's budget, and x the
    bits of an untraced solve:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_trace.py
"""

import collections

import numpy as np
import pytest
import torch

from mpbp_tpu_torch import drivers
from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers import graphs
from mpbp_tpu_torch.utils import metrics

torch.set_num_threads(1)


def _build(n, device):
    """The hybrid lsc_mg_full PC of the n x n MMS problem at eta_n = 100,
    its f64 matvec and the MMS right-hand side."""
    kw = dict(eta_n=100.0, device=device)
    op64 = make_multiphase_operator(n, **kw)
    op32 = make_multiphase_operator(n, dtype=torch.float32, **kw)
    M = drivers.make_preconditioner_mixed(op64, op32, "lsc_mg_full")
    _, b = mms.fill_sol_and_rhs(
        op64.grid, mms.variable_thn_problem(1.0, -1.0, 1.0, 100.0, 1.0))
    return M, drivers.a_matvec(op64), drivers.pack_fields(op64, b)


def _solve(M, mv, b, maxiter=100):
    return krylov.fgmres(mv, b, tol=1e-8, maxiter=maxiter, M=M)


def _build_and_solve(n=16, device="cpu", maxiter=100):
    return _solve(*_build(n, device), maxiter=maxiter)


@pytest.fixture
def ranges(monkeypatch):
    """The names of the profiler ranges opened (record_function counted)."""
    opened = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return opened


def test_tracing_off_records_nothing_and_changes_no_bit(ranges):
    off = _build_and_solve()
    assert metrics._trace is None and ranges == []
    with metrics.tracing() as trace:
        on = _build_and_solve()
    assert metrics._trace is None and ranges == []   # no profiler: no range
    assert trace.spans and all(s.end_ns is not None for s in trace.spans)
    assert on.iters == off.iters and torch.equal(on.x, off.x)
    assert np.array_equal(on.res_history, off.res_history, equal_nan=True)
    assert on.converged and off.converged
    recorded = len(trace.spans)
    _build_and_solve()                   # after the block: nothing added
    assert ranges == [] and len(trace.spans) == recorded


def test_spans_nest_and_share_a_root():
    with metrics.tracing() as trace:
        res = _build_and_solve()
    spans = trace.spans
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.root == i
        else:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.root == p.root
    roots = [s.name for s in spans if s.parent is None]
    assert roots == ["operator.assemble", "operator.assemble", "pc.build",
                     "krylov.solve"]
    build, solve = (spans.index(next(s for s in spans if s.name == name))
                    for name in ("pc.build", "krylov.solve"))
    in_build = collections.Counter(s.name for s in spans if s.root == build)
    assert in_build["mg.pressure.build"] == in_build[
        "mg.velocity.build"] == in_build["pc.lsc_products"] == 1
    steps = [s for s in spans
             if s.name == "krylov.step" and s.parent == solve]
    assert len(steps) == res.iters > 0
    assert {s.root for s in spans[solve:]} == {solve}
    # every apply of the PC is an LSC apply inside an outer step, its
    # inner solves inside it
    assert all(spans[s.parent].name == "krylov.step"
               for s in spans if s.name == "pc.lsc")
    assert all(spans[s.parent].name == "pc.f_inner"
               for s in spans if s.name == "mg.velocity")
    assert all(spans[s.parent].name == "pc.p_inner"
               for s in spans if s.name == "mg.pressure")


def test_spans_are_profiler_ranges():
    """A build and two outer iterations (the profiler records every op)."""
    from torch.profiler import ProfilerActivity, profile

    with metrics.tracing() as trace:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _build_and_solve(maxiter=2)
    recorded = collections.Counter(s.name for s in trace.spans)
    found = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name() in recorded)
    assert found == recorded and len(recorded) == 16


def test_tracing_blocks_do_not_nest():
    with metrics.tracing():
        with pytest.raises(RuntimeError, match="already open"):
            with metrics.tracing():
                pass
    assert metrics._trace is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels "
                    "have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_traced_graphed_solve_on_the_card(cuda_device):
    """A 64^2 hybrid solve through a graphed PC, captured inside the
    traced solve, against one through a graph captured untraced."""
    graphs.release()     # no earlier test's released graph is adopted
    M, mv, b = _build(64, cuda_device)
    off = _solve(graphs.GraphedApply(M), mv, b)
    G = graphs.GraphedApply(M)
    with metrics.tracing() as trace:
        on = _solve(G, mv, b)
    captures = [s for s in trace.spans if s.name == "graph.capture"]
    assert len(captures) == 1 and trace.counters["graph.pool_bytes"] > 0
    assert captures[0].attrs["device_allocs"] >= 0
    assert [s.name for s in trace.spans if s.parent == trace.spans.index(
        captures[0])] == ["graph.warmup", "graph.begin", "graph.record",
                          "graph.end"]
    ms = trace.device_ms("pc.replay")
    replays = sum(s.name == "pc.replay" for s in trace.spans)
    assert len(ms) == replays == on.iters and min(ms) > 0
    assert 0 < trace.counters["pc.inner_steps"] <= G.gated_steps * replays
    assert on.iters == off.iters and torch.equal(on.x, off.x)
