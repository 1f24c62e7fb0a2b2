"""A released CUDA graph reused by a new preconditioner of the same
structure (`solvers/graphs.py`: the retired slot, `_Tree`'s structure key,
the copy and the check that nothing the caller holds is written), on the
`lsc_mg_full` hybrid PC at n=32 on the CPU:

  * the key of a PC built from theta_n equals the key of one built from
    theta_n moved by whole cells, also after the first has run;
  * the key differs where n, eta_n, the inner budget or the kind differs;
  * the new PC's tensors copied into the old one's: the old apply gives
    the new one's output bit for bit;
  * the old tree is not adoptable while the caller holds the old PC, an
    operator, a solver of it, one of its tensors, a view of one or a
    storage object of one;
  * on the card (`gpu`, skipped here), 64^2 steps that release the last
    step's PC and build one from a moved theta_n: one capture and then
    adoptions (the counters), each adopted replay the bits, IF tallies
    and launch counts of a fresh graph and the eager apply's bits and
    launches, a new structure captured anew, a held old PC left whole and
    the peak memory flat from the second step on:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_graph_reuse.py
"""

import gc

import numpy as np
import pytest
import torch

from mpbp_tpu_torch.drivers import make_preconditioner_mixed
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.ops import (_build, cuda_dia, cuda_ell, cuda_mg,
                                cuda_stencil)
from mpbp_tpu_torch.solvers import graphs
from mpbp_tpu_torch.solvers.multigrid import MGVelocitySolver
from mpbp_tpu_torch.utils import metrics

torch.set_num_threads(1)

N = 32
ETA_N = 100.0


def _theta(n, device, shift=(0, 0)):
    """The default theta_n's planes moved by `shift` whole cells."""
    base = make_multiphase_operator(n, device=device).phase_n
    return {k: torch.roll(getattr(base, k), shift, (0, 1))
            for k in ("cell", "xface_pt", "yface_pt")}


def _pc(n=N, shift=(0, 0), device="cpu", eta_n=ETA_N, inner_iters=40,
           kind="lsc_mg_full"):
    """(op64, op32, M): the hybrid PC of theta_n moved by `shift`, built
    as a time step builds it; the caller holds nothing else of it."""
    planes = _theta(n, device, shift)
    kw = dict(eta_n=eta_n, device=device, theta_planes=planes)
    op64 = make_multiphase_operator(n, **kw)
    op32 = make_multiphase_operator(n, dtype=torch.float32, **kw)
    return op64, op32, make_preconditioner_mixed(op64, op32, kind,
                                                 inner_iters=inner_iters)


def _vector(n, device):
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.normal(size=5 * n * n), device=device)


def test_key_is_equal_for_theta_moved_by_whole_cells():
    """Two builds from theta_n and from theta_n moved by (3, 5) cells have
    one key, the same before and after the first one's apply has run (the
    tree makes nothing at its first call), with storages in one order."""
    *_, old = _pc()
    *_, new = _pc(shift=(3, 5))
    before = graphs._Tree(old)
    old(_vector(N, "cpu"))
    after, moved = graphs._Tree(old), graphs._Tree(new)
    assert before.key == after.key == moved.key
    assert len(moved.storages) > 100 and not moved.views


@pytest.mark.parametrize("change", [
    dict(n=16), dict(eta_n=10.0), dict(inner_iters=20),
    dict(kind="lsc_mg_krylov")], ids=["n", "eta_n", "inner_iters", "kind"])
def test_key_differs_where_the_structure_differs(change):
    *_, M = _pc()
    *_, other = _pc(**change)
    assert graphs._Tree(M).key != graphs._Tree(other).key


def test_copy_makes_the_old_apply_the_new_one():
    """The new PC's storages copied into the old PC's: the old apply's
    output is the new apply's, bit for bit, where it differed before."""
    *_, old = _pc()
    *_, new = _pc(shift=(7, -2))
    v = _vector(N, "cpu")
    want = new(v)
    assert not torch.equal(old(v), want)
    graphs._Tree(old).copy_from(graphs._Tree(new))
    assert torch.equal(old(v), want)


def _held(what, op64, op32, M):
    """What the caller keeps of the old step."""
    tree = graphs._Tree(M)
    solver = next(o for o in tree.nodes if isinstance(o, MGVelocitySolver))
    del tree
    cell = op32.phase_n.cell
    return {"nothing": None, "pc": M, "op64": op64, "op32": op32,
            "mg_solver": solver, "tensor": cell, "view": cell[1:],
            "storage": cell.untyped_storage()}[what]


@pytest.mark.parametrize("what", ["nothing", "pc", "op64", "op32",
                                  "mg_solver", "tensor", "view", "storage"])
def test_tree_held_by_the_caller_is_not_adoptable(what):
    """The old tree is adoptable when the caller has let go of all of it
    (the one holder of its apply being the retired slot's), and not while
    the caller keeps any of it."""
    op64, op32, M = _pc()
    keep = _held(what, op64, op32, M)
    del op64, op32
    tree = graphs._Tree(M)
    assert tree.unreachable(holders=1) == (keep is None)
    del keep
    assert tree.unreachable(holders=1)


def test_a_tree_with_a_view_is_not_adoptable():
    t = torch.zeros(4, 4)
    view = t[1:]
    del t
    tree = graphs._Tree(lambda v: v * view)
    assert tree.views and not tree.unreachable(holders=0)


def test_an_opaque_leaf_is_known_by_its_identity():
    """An object the walk does not enter matches only itself."""
    a, b = np.ones(3), np.ones(3)
    assert graphs._Tree((a, 1.0)).key == graphs._Tree((a, 1.0)).key
    assert graphs._Tree((a, 1.0)).key != graphs._Tree((b, 1.0)).key
    assert graphs._Tree((a, 1.0)).key != graphs._Tree((a, 2.0)).key
    assert graphs._Tree((0.0,)).key != graphs._Tree((-0.0,)).key


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels "
                    "have no CPU mode)")
    graphs.release()
    yield torch.device("cuda", 0)
    graphs.release()


GN = 64
SHIFTS = [(0, 0), (3, 5), (-7, 2), (11, -4), (1, 1)]


def _launches():
    return [dict(c) for c in (cuda_stencil.LAUNCHES, cuda_dia.LAUNCHES,
                              cuda_ell.LAUNCHES, cuda_mg.LAUNCHES)]


def _replay(G, v):
    """G(v) and what it launched and ran: (output, launch counts by name,
    IF bodies run)."""
    _build.settle_deferred()
    before, ran = _launches(), getattr(G, "steps_run", 0)
    out = G(v)
    torch.cuda.synchronize()
    _build.settle_deferred()
    after = _launches()
    diff = [{k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}
            for a, b in zip(after, before)]
    return out, diff, getattr(G, "steps_run", 0) - ran


@pytest.mark.gpu
def test_moving_steps_capture_once_then_adopt(cuda_device):
    """Steps that each release the last step's PC and build one from a
    moved theta_n: the first captures, the next adopt (the counters), and
    each step's second replay is bit-equal to a fresh graph of the same
    PC and to its eager apply, with the fresh graph's IF tallies and
    launches and the eager apply's launches."""
    v = _vector(GN, cuda_device)
    G = None
    for k, shift in enumerate(SHIFTS[:3]):
        G = None
        gc.collect()
        with metrics.tracing() as t:
            op64, op32, M = _pc(GN, shift, cuda_device)
            G = graphs.GraphedApply(M)
            G(v)
        assert t.counters.get("graph.captures", 0) == (k == 0)
        assert t.counters.get("graph.adoptions", 0) == (k > 0)
        children = [s.name for s in t.spans if s.parent is not None
                    and t.spans[s.parent].name == "graph.capture"]
        assert children == (["graph.adopt"] if k else
                            ["graph.warmup", "graph.begin", "graph.record",
                             "graph.end"])
        out, launched, ran = _replay(G, v)
        fresh = graphs.GraphedApply(M)      # the slot is empty: a capture
        fresh(v)
        f_out, f_launched, f_ran = _replay(fresh, v)
        with graphs.disabled():
            e_out, e_launched, _ = _replay(M, v)
        assert torch.equal(out, f_out) and torch.equal(out, e_out)
        assert launched == f_launched == e_launched and ran == f_ran > 0
        del fresh, M, op64, op32, out, f_out, e_out
        _build.settle_deferred()


@pytest.mark.gpu
def test_another_structure_is_captured_anew(cuda_device):
    v = _vector(GN, cuda_device)
    G = graphs.GraphedApply(_pc(GN, device=cuda_device)[2])
    G(v)
    del G
    _build.settle_deferred()
    gc.collect()
    *_, M = _pc(GN, (3, 5), cuda_device, inner_iters=20)
    with metrics.tracing() as t:
        G = graphs.GraphedApply(M)
        out = G(v)
    assert t.counters.get("graph.captures") == 1
    assert "graph.adoptions" not in t.counters
    with graphs.disabled():
        assert torch.equal(out, M(v))


@pytest.mark.gpu
def test_a_held_old_pc_is_captured_anew_and_left_whole(cuda_device):
    """The caller keeps the old step's PC: the new step captures, and the
    old PC still gives its own output, bit for bit."""
    v = _vector(GN, cuda_device)
    op64, op32, old = _pc(GN, device=cuda_device)
    G = graphs.GraphedApply(old)
    G(v)
    with graphs.disabled():
        own = old(v)
    del G, op64, op32
    _build.settle_deferred()
    gc.collect()
    *_, M = _pc(GN, (3, 5), cuda_device)
    with metrics.tracing() as t:
        G = graphs.GraphedApply(M)
        out = G(v)
    assert t.counters.get("graph.captures") == 1
    with graphs.disabled():
        assert torch.equal(old(v), own) and torch.equal(out, M(v))
        assert not torch.equal(out, own)


@pytest.mark.gpu
def test_peak_memory_is_flat_from_the_second_step(cuda_device):
    """Five moving steps, each releasing the last: the peak after the
    second step is the peak after the fifth."""
    v = _vector(GN, cuda_device)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    G, peaks = None, []
    for shift in SHIFTS:
        G = None
        _build.settle_deferred()
        gc.collect()
        G = graphs.GraphedApply(_pc(GN, shift, cuda_device)[2])
        G(v)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(cuda_device))
    assert peaks[1] == peaks[4]
