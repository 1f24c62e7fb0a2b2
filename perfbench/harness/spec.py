"""Everything a run reads by name: the cell's entry in `BENCHMARK.json`,
its configuration file, its traffic mix (`traffic/<name>.json`), its run
parameters (`workloads/<cell>.json`) and the reader of each metric it
reports (`metrics/<metric>.py`). A new configuration, mix, cell or metric
is a new file and a new entry; no code here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent        # perfbench/
ROOT = HERE.parent                                   # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    params: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: list[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r} is not in BENCHMARK.json "
                       f"exactly once")
    return found[0]


def applies(metric: dict, cell: str) -> bool:
    """A metric is reported in the cells its `workloads` lists, or in every
    cell when it lists none."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path | None = None) -> Cell:
    bench = _load_json(bench_path or ROOT / "BENCHMARK.json")
    w = _by_name(bench["workloads"], name, "workload")
    cfg = _by_name(bench["configs"], w["config"], "config")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(ROOT / cfg["file"]),
        traffic=_load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        params=_load_json(HERE / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def reader(metric: str):
    """The `read(ctx)` function of `metrics/<metric>.py`; for a metric
    split by the end-to-end metric it moves (`<quantity>.<part>`, such as
    `device.idle_share.step`) with no reader of its own, that of the
    longest dotted prefix that has one (`metrics/device.idle_share.py`)."""
    name = metric
    while not (HERE / "metrics" / f"{name}.py").is_file():
        if "." not in name:
            raise FileNotFoundError(f"no reader for metric {metric!r} in "
                                    f"{HERE / 'metrics'}")
        name = name.rsplit(".", 1)[0]
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
