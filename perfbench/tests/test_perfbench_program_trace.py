"""The split of the device's idle time among the program's spans
(`harness/program_trace.py`), on synthetic events."""

from perfbench.harness import program_trace

NAMES = {"krylov.solve", "krylov.read_done", "krylov.step", "pc.replay",
         "graph.capture", "graph.begin"}


def _split(host, device, window=(0.0, 30.0)):
    events = [(False, name, a, b) for name, a, b in host] + \
        [(True, name, a, b) for name, a, b in device]
    return program_trace.split_idle(events, window, NAMES)


def test_a_gap_is_split_by_overlap():
    """A gap that starts in krylov.read_done and runs on into krylov.step
    falls on both, by overlap; the device's mark of a span is no work."""
    busy, idle = _split(
        host=[("krylov.solve", 0, 30), ("krylov.read_done", 0, 10),
              ("krylov.step", 10, 20), ("pc.replay", 18, 20)],
        device=[("k", -5, 5), ("k", 15, 25), ("krylov.step", 10, 20)])
    assert busy == 15
    assert idle == {("krylov.solve", "krylov.read_done"): 5,
                    ("krylov.solve", "krylov.step"): 5,
                    ("krylov.solve",): 5}
    assert program_trace.under(idle, "krylov.solve") == {
        "krylov.read_done": 5, "krylov.step": 5, "self": 5}


def test_idle_outside_every_span_and_nested_children():
    busy, idle = _split(
        host=[("graph.capture", 2, 8), ("graph.begin", 3, 6)],
        device=[("k", 0, 1), ("k", 9, 10)], window=(0.0, 10.0))
    assert busy == 2
    assert idle == {(): 2, ("graph.capture",): 3,
                    ("graph.capture", "graph.begin"): 3}
    assert program_trace.under(idle, "graph.capture") == {
        "self": 3, "graph.begin": 3}


def test_segments_cut_a_child_at_its_parents_end():
    assert program_trace.segments([]) == []
    assert program_trace.segments([(0, 4, "a"), (1, 5, "b"), (6, 7, "c")]) \
        == [(0, 1, ("a",)), (1, 4, ("a", "b")), (6, 7, ("c",))]


def test_no_reading_without_a_card(tiny_cell, cpu):
    """Every reader of the program's trace returns None on the CPU."""
    from perfbench import run
    from perfbench.harness import spec

    cell = tiny_cell("hyb1024.fixed_theta")
    ctx = run.Context(cell, cpu, 1, None)
    for name in ("krylov.idle_ms_per_iter.solve", "pc.replay_ms",
                 "pc.inner_steps", "setup.capture_s",
                 "memory.device_mallocs"):
        assert spec.reader(name)(ctx) is None
