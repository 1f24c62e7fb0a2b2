"""The port's `jit`: a preconditioner apply captured once as a CUDA graph
and replayed on every later call, with the inner Krylov loops exiting on
the device.

In the JAX package one outer FGMRES iteration, with its whole
preconditioner apply (the nested inner GMRES and CG solves, each a
`lax.while_loop` that stops on the device, the multigrid sweeps, the LSC
glue), is one compiled program (`mpbp_tpu/solvers/gmres.py`
`_fgmres_cycle`). Eager PyTorch launches the same apply as thousands of
kernels from the host, one Python call each. `GraphedApply` records them
once and replays the recording: the host's cost of an apply becomes one
copy in, one replay and one copy out.

`loop` runs the fixed-budget Krylov loops (`solvers/gmres.gmres_fixed`,
`cg_fixed`): step s = 0..m-1 while ~done & (j < m), as `lax.while_loop`
with its static bound m. It runs one of three ways:
  * captured (a `GraphedApply` capture in progress): step s is the body
    of a CUDA-graph IF node (`csrc/graph_cond.cu`) on the predicate
    ~done & (j < m), a () bool on the device computed before the node. A
    replay runs a body only where the loop would have stepped: the
    device-side exit. The node is made in C++ because PyTorch 2.11 has no
    Python API for it. A capture that cannot make the node raises;
  * eager (no capture, on any device, inside `disabled()` too): the
    loop reads `done` once a step and stops, as the `jax.disable_jit()`
    while loop tests its `cond`;
  * masked (inside `masked()`): all m steps run, every update masked past
    done, and nothing is read back: the A/B against the IF graph, and the
    CPU tests' check that the captured arithmetic makes no host read.
The state after a step that did not run is the state after a masked step,
and the solution is back-substituted on the device from it in every
mode, so x, the counts and the census are the same bits in all three.

What capture needs of the apply: it reads nothing back to the host (the
fixed-budget loops, the multigrid cycles, the LSC formula), its input
arrives in one static buffer, and the tensors it closes over live as long
as the graph (the graph holds the apply). A step body
writes the loop state in place: a tensor it allocates is garbage after a
replay that skipped it. A body is captured on a stream of its own, and
the capture routes this thread's allocations to the graph's pool, so the
bodies' tensors live there as the rest of the apply's do. Under capture
a host read raises; so does a failed launch. A failed capture raises:
nothing falls back to eager on CUDA.

The kernel wrappers count their launches in Python, where a replay does
not pass. Each wrapper's count during capture outside the IF bodies is
added again on every replay. A body's counts are added once for each
replay in which it ran: each predicate is a slot of a device buffer that
the graph tallies at its end, and the tallies are read, once, at the next
read of a count (`ops/_build.Launches`), never inside an apply.

On a CPU tensor the apply runs directly (there is no CPU graph), and
inside `disabled()` it runs eagerly on any device: the counterpart of
`jax.disable_jit()`, for an A/B and for debugging.

A released graph is reused, as `jax.jit`'s cache reuses a compiled
program for new argument values of the same shapes. When a captured
`GraphedApply` is garbage, its graph, static buffers, recording and the
apply it recorded go to a retired slot (one entry; a newer one replaces
it). The first call of a new `GraphedApply` walks its apply's object tree
as built (closure cells, function defaults and attributes, bound methods,
`functools.partial`, dataclass instances, dicts, lists and tuples; any
other object is a leaf known by its identity) into a structure key: every
non-tensor leaf by value, every tensor's type, shape, strides, offset,
dtype and device, and which tensors share a storage; the input's shape,
dtype and device and the recording modes (`masked()`, `cuda_mg.plain()`,
`cuda_krylov.plain()`) besides. Where the retired apply's key is the same,
the new apply's storages are copied, bit for bit, into the retired tree's
(one `_foreach_copy_` on the current stream) and the new `GraphedApply` takes
the graph over and replays it: no warm-up, no capture, no instantiation.
Otherwise the retired entry is dropped and the apply is captured.
`release()` frees the released graphs at once.

Nothing the caller can still reach is ever written. The copy happens only
where, at that moment, nothing outside the retired tree refers to an
object of it that leads to a tensor (Python reference counts against the
references the walk found), no other tensor shares one of its storages
(the storages' use counts), and the tree holds no view. A tree whose
apply wrote one of its own tensors while it was captured (a census, say)
is never retired. From then on the adopted graph reads the copy made at
the first call, and `apply` is the recorded apply holding the new values:
an in-place change to the caller's tensors after the first call reaches
neither.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
import types
import weakref
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.ops import (_build, cuda_dia, cuda_ell, cuda_krylov,
                                cuda_mg, cuda_stencil)
from mpbp_tpu_torch.utils import metrics

# every kernel wrapper's launch counts
_COUNTERS = (cuda_stencil.LAUNCHES, cuda_dia.LAUNCHES, cuda_ell.LAUNCHES,
             cuda_mg.LAUNCHES, cuda_krylov.LAUNCHES)
_disabled = False
_masked = False
_recording: "_Recording | None" = None
_steps = 0             # the budgets of every `loop` so far
_retired: "_Captured | None" = None    # a released graph (module docstring)


@contextlib.contextmanager
def disabled():
    """Run every `GraphedApply` eagerly inside the block."""
    global _disabled
    before, _disabled = _disabled, True
    try:
        yield
    finally:
        _disabled = before


@contextlib.contextmanager
def masked():
    """Run every fixed-budget loop as its masked budget inside the block
    (a `GraphedApply` captured here replays it so)."""
    global _masked
    before, _masked = _masked, True
    try:
        yield
    finally:
        _masked = before


def release() -> None:
    """Free the released graphs now: settle the launch tallies that keep a
    released `GraphedApply` alive (one read of the device), then drop the
    retired graph with its pool and its apply's tensors (module
    docstring)."""
    global _retired
    _build.settle_deferred()
    _retired = None


def loop(done: torch.Tensor, j: torch.Tensor, m: int,
         step: Callable[[int], None]) -> None:
    """step(s) for s = 0..m-1 while ~done & (j < m) (module docstring).
    `done` and `j` are the loop state's () tensors, which each step
    updates in place."""
    global _steps
    _steps += m
    if _masked:
        for s in range(m):
            step(s)
    elif done.is_cuda and torch.cuda.is_current_stream_capturing():
        if _recording is None:
            raise RuntimeError("a fixed-budget Krylov loop is captured only "
                               "inside a GraphedApply capture")
        for s in range(m):
            live = _recording.slot()
            torch.logical_and(~done, j < m, out=live)
            with _recording.gate(live):
                step(s)
    else:
        for s in range(m):
            if bool(done):
                break
            step(s)


def _stream_besides(device: torch.device, taken) -> torch.cuda.Stream:
    """A stream of PyTorch's pool that is none of `taken` (raw handles).
    The pool hands out its streams round-robin, so after 32 requests a new
    stream is an old one again: a body stream that is the capture's own
    stream cannot begin a capture of its own (cudaErrorIllegalState)."""
    for _ in range(64):
        stream = torch.cuda.Stream(device)
        if stream.cuda_stream not in taken:
            return stream
    raise RuntimeError("no CUDA stream outside the capture's")


def _snapshot() -> list[dict]:
    return [dict(c) for c in _COUNTERS]


def _minus(a: list[dict], b: list[dict]) -> list[dict]:
    return [{k: x[k] - y.get(k, 0) for k in x if x[k] != y.get(k, 0)}
            for x, y in zip(a, b)]


class _Recording:
    """What one capture records of its IF bodies: each body's predicate
    (a slot of `live`, a bool buffer on the device), its own launches
    (those of the bodies nested in it apart) and, in `ran`, an int64
    tally of the replays in which each body ran. Both buffers are made
    before the capture, `n` slots long: the steps of a masked warm-up."""

    def __init__(self, device: torch.device, body: torch.cuda.Stream,
                 capture: torch.cuda.Stream, n: int):
        self.device = device
        self.capture = capture    # the stream the graph is captured on
        self.streams = [body]     # the body streams, one a nesting depth
        self.depth = 0
        self.live = torch.zeros(n, dtype=torch.bool, device=device)
        self.ran = torch.zeros(n, dtype=torch.int64, device=device)
        self.launches: list[list[dict]] = []
        self.in_bodies = [{} for _ in _COUNTERS]

    def slot(self) -> torch.Tensor:
        k = len(self.launches)
        if k == len(self.live):
            raise RuntimeError(f"the capture gates more than the {k} steps "
                               "of its masked warm-up")
        self.launches.append([{} for _ in _COUNTERS])
        return self.live[k]

    @contextlib.contextmanager
    def gate(self, live: torch.Tensor):
        """Capture the block as the body of an IF node on `live`, the
        latest slot."""
        k = len(self.launches) - 1
        if self.depth == len(self.streams):
            self.streams.append(_stream_besides(
                self.device, {s.cuda_stream
                              for s in (self.capture, *self.streams)}))
        body = self.streams[self.depth]
        before, nested = _snapshot(), [dict(c) for c in self.in_bodies]
        _build.launch("graph_cond", "graph_if_begin", self.device,
                      live.data_ptr(), body.cuda_stream)
        self.depth += 1
        try:
            with torch.cuda.stream(body):
                try:
                    yield
                finally:
                    _build.launch("graph_cond", "graph_if_end", self.device)
        finally:
            self.depth -= 1
        own = _minus(_minus(_snapshot(), before),
                     _minus(self.in_bodies, nested))
        self.launches[k] = own
        for total, d in zip(self.in_bodies, own):
            for name, n in d.items():
                total[name] = total.get(name, 0) + n

    def finish(self) -> None:
        """Captured last: tally this replay's predicates and clear them
        (a body nested in one that did not run leaves its slot 0)."""
        self.ran.add_(self.live)
        self.live.zero_()


# leaves of an apply's tree known by their value
_VALUES = (type(None), bool, int, float, complex, str, bytes, torch.dtype,
           torch.device, np.generic)


class _Tree:
    """One walk of an apply's object tree (module docstring): `key`, its
    structure; `nodes`, every object walked but the leaves, in order, and
    `refs`, the tree's references to each; `storages`, for each storage
    of its tensors, [the node of one tensor on it, the tensors of the tree
    on it, the order in which the walk met it]."""

    def __init__(self, root):
        self.key: list = []
        self.nodes: list = []
        self.refs: list[int] = []
        self.storages: dict = {}
        self.views = False
        self._edges: list[tuple[int, int]] = []
        self._ids: dict[int, int] = {}
        self._walk(root, None)

    def _walk(self, obj, parent: int | None) -> None:
        if isinstance(obj, _VALUES):
            self.key.append((type(obj), obj.hex() if isinstance(obj, float)
                             else obj.tobytes() if isinstance(obj, np.generic)
                             else obj))
            return
        i = self._ids.get(id(obj))
        if i is None:
            children = self._children(obj)
            if children is None:
                self.key.append(("leaf", id(obj)))
                return
            i = self._ids[id(obj)] = len(self.nodes)
            self.nodes.append(obj)
            self.refs.append(0)
        else:
            children = None
            self.key.append(("node", i))
        if parent is not None:
            self.refs[i] += 1
            self._edges.append((parent, i))
        for child in children or ():
            self._walk(child, i)

    def _children(self, obj):
        """The objects `obj` refers to, after its token in the key; None
        for a leaf known by its identity."""
        kind = type(obj)
        if isinstance(obj, torch.Tensor):
            if obj.layout != torch.strided or obj.is_meta:
                return None
            self.views |= obj._is_view()
            storage = obj.untyped_storage()
            at = (obj.device, storage.data_ptr()) if storage.nbytes() \
                else ("empty", id(obj))
            if at not in self.storages:
                self.storages[at] = [len(self.nodes), 0, len(self.storages)]
            entry = self.storages[at]
            entry[1] += 1
            self.key.append((kind, obj.dtype, obj.device, tuple(obj.shape),
                             obj.stride(), obj.storage_offset(),
                             obj.requires_grad, obj.is_conj(), obj.is_neg(),
                             entry[2], storage.nbytes()))
            return ()
        if kind is types.FunctionType:
            attrs = vars(obj)
            self.key.append((kind, id(obj.__code__), id(obj.__globals__),
                             tuple(attrs)))
            return (obj.__closure__, obj.__defaults__, obj.__kwdefaults__,
                    *attrs.values())
        if kind is types.CellType:
            self.key.append((kind,))
            try:
                return (obj.cell_contents,)
            except ValueError:               # an empty cell
                return ()
        if kind is types.MethodType:
            self.key.append((kind,))
            return (obj.__func__, obj.__self__)
        if kind is functools.partial:
            self.key.append((kind,))
            return (obj.func, obj.args, obj.keywords)
        if kind in (tuple, list):
            self.key.append((kind, len(obj)))
            return obj
        if kind is dict:
            self.key.append((kind, len(obj)))
            return (x for item in obj.items() for x in item)
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type) \
                and hasattr(obj, "__dict__"):
            attrs = vars(obj)
            self.key.append((kind, tuple(attrs)))
            return attrs.values()
        return None

    def _leads(self) -> set[int]:
        """The nodes from which a tensor is reached."""
        leads = {i for i, obj in enumerate(self.nodes)
                 if isinstance(obj, torch.Tensor)}
        grew = True
        while grew:
            grew = False
            for parent, child in self._edges:
                if child in leads and parent not in leads:
                    leads.add(parent)
                    grew = True
        return leads

    def unreachable(self, holders: int) -> bool:
        """Whether nothing outside the tree reaches its tensors' memory:
        no reference to a node that leads to a tensor but the tree's own
        (and, to the root, `holders`), no other tensor or storage object
        on one of its storages, and no view in it."""
        if self.views:
            return False
        tensor_refs, storage_refs, uses = _counts()
        for i in self._leads():
            # those of `nodes` and of getrefcount's argument, as counted
            alone = tensor_refs if isinstance(self.nodes[i], torch.Tensor) \
                else 2
            held = self.refs[i] + alone + (holders if i == 0 else 0)
            if sys.getrefcount(self.nodes[i]) != held:
                return False
        for i, tensors, _ in self.storages.values():
            storage = self.nodes[i].untyped_storage()
            if sys.getrefcount(storage) != storage_refs or \
                    torch._C._storage_Use_Count(storage._cdata) \
                    != uses + tensors - 1:
                return False
        return True

    def versions(self) -> list[int]:
        return [obj._version for obj in self.nodes
                if isinstance(obj, torch.Tensor)]

    def copy_from(self, new: "_Tree") -> None:
        """Copy each storage of `new`'s tensors into the matching storage
        of this tree, byte for byte (the keys are equal)."""
        pairs: dict = {}
        for (i, _, _), (j, _, _) in zip(self.storages.values(),
                                        new.storages.values()):
            dst, src = self.nodes[i], new.nodes[j]
            d, s = pairs.setdefault(dst.device, ([], []))
            d.append(_bytes(dst))
            s.append(_bytes(src))
        for d, s in pairs.values():
            torch._foreach_copy_(d, s)


def _counts() -> tuple[int, int, int]:
    """As this PyTorch counts them: the references to a tensor that one
    list holds, to its storage's Python object that one local holds, and
    the uses of that storage (the tensor's and the object's)."""
    one = [torch.empty(1)]
    storage = one[0].untyped_storage()
    return (sys.getrefcount(one[0]), sys.getrefcount(storage),
            torch._C._storage_Use_Count(storage._cdata))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The whole storage of `t` as a uint8 tensor."""
    return torch.empty(0, dtype=torch.uint8, device=t.device).set_(
        t.untyped_storage())


def _modes(v: torch.Tensor) -> tuple:
    """What a capture's recording depends on besides its apply's tree."""
    return (tuple(v.shape), v.dtype, v.device, _masked, cuda_mg._plain,
            cuda_krylov._plain)


@dataclasses.dataclass(eq=False)
class _Captured:
    """What a capture made: the graph, its static buffers, the IF bodies'
    recording and the kernel wrappers' launch tables, with the apply it
    recorded (the graph reads that apply's tensors)."""

    apply: Callable
    modes: tuple
    graph: torch.cuda.CUDAGraph
    inp: torch.Tensor
    out: torch.Tensor
    launches: list[dict]
    bodies: _Recording | None
    per_body: list[dict]
    gated_steps: int


def _retire(captured: _Captured) -> None:
    global _retired
    _retired = captured


class GraphedApply:
    """`apply` (a tensor -> tensor function with no host read) captured as
    a CUDA graph at its first CUDA call and replayed on each later one.

    The first call copies its input into the static buffer, runs `apply`
    once on a side stream as the masked budget (the warm-up: lazy library
    loads and allocator state stay out of the recording, and its steps
    size the IF bodies' buffers; the side stream then takes the bodies),
    captures `apply` on that buffer and replays the graph; or, where a
    released graph recorded an apply of the same structure, copies this
    apply's tensors into that apply's and takes its graph over (module
    docstring). `_capture` makes the graph either way. Each
    call after it copies its input in, replays and returns a copy of the
    static output (a caller may keep it: the next replay overwrites the
    buffer). The input's shape, dtype and device are fixed by the first
    call; another raises ValueError.

    `gated_steps` is the number of IF bodies in the graph (the budgets of
    its loops), `steps_run` the bodies its replays ran, as of the last
    read of a launch count."""

    def __init__(self, apply: Callable):
        self.apply = apply
        self.graph: torch.cuda.CUDAGraph | None = None
        self._in = self._out = None
        self._launches: list[dict] = []
        self._replay_launches = 0      # those of _launches, summed
        self._bodies: _Recording | None = None
        self._per_body: list[dict] = []
        self.gated_steps = self.steps_run = 0

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if _disabled or v.device.type != "cuda":
            return self.apply(v)
        if self.graph is None:
            self._capture(v)
        elif (v.shape != self._in.shape or v.dtype != self._in.dtype
              or v.device != self._in.device):
            raise ValueError(
                f"graphed apply captured for {tuple(self._in.shape)} "
                f"{self._in.dtype} on {self._in.device}, called with "
                f"{tuple(v.shape)} {v.dtype} on {v.device}")
        with metrics.span("pc.replay"):
            self._in.copy_(v)
            with metrics.device_time("pc.replay"):
                self.graph.replay()
            for counter, added in zip(_COUNTERS, self._launches):
                for k, d in added.items():
                    counter.add(k, d)
            metrics.count("pc.launches", self._replay_launches)
            if self._bodies is not None \
                    and self._settle not in _build.DEFERRED:
                _build.DEFERRED.append(self._settle)
            return self._out.clone()

    @metrics.spanned("graph.capture")
    def _capture(self, v: torch.Tensor) -> None:
        """Make the graph at the first CUDA call: adopt the retired one
        where its apply has this apply's structure, else capture (module
        docstring)."""
        # a replayed graph held by nothing but its pending launch tallies
        # is garbage once they are settled, and retired then
        _build.settle_deferred()
        tree = _Tree(self.apply)
        if self._adopt(v, tree):
            metrics.count("graph.adoptions")
            return
        versions = tree.versions()
        captured = self._record(v)
        metrics.count("graph.captures")
        # an apply that wrote a tensor of its own tree is never retired
        self._take(captured, retire=tree.versions() == versions)

    def _adopt(self, v: torch.Tensor, tree: _Tree) -> bool:
        """Take the retired graph over if its apply's key is `tree`'s and
        nothing outside the retired slot reaches its tensors: copy the
        new tensors in. Else drop it, so that its memory is free before
        the capture."""
        global _retired
        retired, _retired = _retired, None
        if retired is None or retired.modes != _modes(v):
            return False
        old = _Tree(retired.apply)
        if old.key != tree.key or not old.unreachable(holders=1):
            return False
        with metrics.span("graph.adopt"):
            old.copy_from(tree)
            self._take(retired, retire=True)
        return True

    def _take(self, captured: _Captured, retire: bool) -> None:
        """Replay `captured` from now on; if `retire`, it goes to the
        retired slot when this GraphedApply is garbage."""
        self.apply = captured.apply
        self.graph = captured.graph
        self._in, self._out = captured.inp, captured.out
        self._launches = captured.launches
        self._replay_launches = sum(n for d in self._launches
                                    for n in d.values())
        self._bodies, self._per_body = captured.bodies, captured.per_body
        self.gated_steps = captured.gated_steps
        if retire:
            weakref.finalize(self, _retire, captured).atexit = False

    def _record(self, v: torch.Tensor) -> _Captured:
        """Capture `apply` on a static copy of `v`."""
        global _recording
        static = v.clone()
        side = torch.cuda.Stream(v.device)
        side.wait_stream(torch.cuda.current_stream(v.device))
        steps = _steps
        with metrics.span("graph.warmup"), torch.cuda.stream(side), \
                masked():
            self.apply(static)
        torch.cuda.current_stream(v.device).wait_stream(side)
        capture = _stream_besides(v.device, {side.cuda_stream})
        rec = _Recording(v.device, side, capture, _steps - steps)
        pool = torch.cuda.graph_pool_handle()
        index = torch.cuda.current_device() if v.device.index is None \
            else v.device.index
        before = _snapshot()
        graph = torch.cuda.CUDAGraph()
        capturing = torch.cuda.graph(graph, pool=pool, stream=capture)
        _recording, routed = rec, False
        try:
            # the entry (a sync, the cache emptied, capture_begin) and the
            # exit (capture_end, the instantiation): spans of their own
            with metrics.span("graph.begin"):
                capturing.__enter__()
            try:
                with metrics.span("graph.record") as recorded:
                    # an IF body is captured on a stream of its own, which
                    # the capture's allocator filter (its stream's capture)
                    # does not route to the graph's pool: route this
                    # thread's instead
                    torch._C._cuda_endAllocateToPool(index, pool)
                    torch._C._cuda_beginAllocateCurrentThreadToPool(index,
                                                                    pool)
                    routed = True
                    reserved = torch.cuda.memory_reserved(index)
                    out = self.apply(static)
                    rec.finish()
            finally:
                with metrics.span("graph.end"):
                    capturing.__exit__(None, None, None)
        finally:
            _recording = None
            if routed:
                torch._C._cuda_releasePool(index, pool)
            # the capture launched nothing: its counts are the replay's
            after = _snapshot()
            for counter, b in zip(_COUNTERS, before):
                counter.update(b)
        if recorded is not None:      # tracing: the pool's bytes
            metrics.count("graph.pool_bytes",
                          torch.cuda.memory_reserved(index) - reserved)
        bodies, per_body = None, []
        if rec.launches:
            bodies = rec
            keys = [sorted({k for body in rec.launches for k in body[i]})
                    for i in range(len(_COUNTERS))]
            per_body = [
                {k: np.array([body[i].get(k, 0) for body in rec.launches])
                 for k in keys[i]} for i in range(len(_COUNTERS))]
        return _Captured(self.apply, _modes(v), graph, static, out,
                         _minus(_minus(after, before), rec.in_bodies),
                         bodies, per_body, len(rec.launches))

    def _settle(self) -> None:
        """Add each IF body's launches times the replays it ran in, and
        clear the tallies: one read of the device."""
        rec = self._bodies
        torch.cuda.synchronize(self._in.device)
        ran = rec.ran[:len(rec.launches)].cpu().numpy()
        rec.ran.zero_()
        self.steps_run += int(ran.sum())
        metrics.count("pc.inner_steps", int(ran.sum()))
        for counter, per in zip(_COUNTERS, self._per_body):
            for k, each in per.items():
                launched = int(ran @ each)
                counter.add(k, launched)
                metrics.count("pc.launches", launched)
