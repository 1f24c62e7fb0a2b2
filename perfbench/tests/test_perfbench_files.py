"""Every file the harness finds by name loads, BENCHMARK.json keeps to the
contract's shapes and characters, and nothing under perfbench/ imports JAX
or the JAX package (the reference nothing of the program either)."""

import ast
import json
import re

import pytest

from perfbench.harness import spec

HERE, ROOT = spec.HERE, spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
NO_JAX = {"jax", "jaxlib", "flax", "mpbp_tpu"}
PROGRAM = {"mpbp_tpu_torch"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_text(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) \
        and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _text(w["why"])
        used.add(w["config"])
        names.append(w["name"])
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _text(m["layer"])
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    c = spec.load_cell(cell)
    for key in ("n", "tol", "maxiter", "precision", "pc"):
        assert key in c.config
    assert c.config["reduced"] == []
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_every_file_is_named_and_loads():
    for kind in ("configs", "traffic", "workloads"):
        for f in (HERE / kind).glob("*.json"):
            assert NAME.match(f.stem)
            json.loads(f.read_text())
    readers = {f.name[:-3] for f in (HERE / "metrics").glob("*.py")}
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    # every reader serves a metric of its own name or its dotted parts
    for r in readers:
        assert any(m == r or m.startswith(r + ".") for m in named), r
    for m in named:
        assert callable(spec.reader(m))
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_a_split_metric_reads_through_its_quantity(tmp_path, monkeypatch):
    """`<quantity>.<part>` with no reader of its own takes the reader of
    the longest dotted prefix that has one; a name with none raises."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "a.b.py").write_text("def read(ctx):\n"
                                                  "    return 'ab'\n")
    (tmp_path / "metrics" / "a.b.c.py").write_text("def read(ctx):\n"
                                                    "    return 'abc'\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    assert spec.reader("a.b.part")(None) == "ab"
    assert spec.reader("a.b.c")(None) == "abc"
    assert spec.reader("a.b.c.d.e")(None) == "abc"
    with pytest.raises(FileNotFoundError):
        spec.reader("a.x")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_of_its_own():
    files = list(HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not set(_imports(f)) & NO_JAX, f
    for f in (HERE / "reference").rglob("*.py"):
        assert set(_imports(f)) <= {"__future__", "torch", "numpy", "math"}, f
