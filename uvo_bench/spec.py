"""What a cell is made of, found by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic mix, each a JSON file of its
own (``configs/<name>.json``, ``traffic/<name>.json``); each per-layer metric
is a reader of its own (``metrics/<name>.py``), and each kind of pipeline a
runner of its own (``pipelines/<kind>.py``).  A new cell, mix, metric or
pipeline is a new file and a new entry; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    workload: dict  # the BENCHMARK.json entry
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # the end-to-end metrics this cell reports
    per_layer: list  # the per-layer metrics this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), with its files."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        if not cells & set(m.get("workloads", cells)):
            raise ValueError(f"per-layer metric {m['name']}: no cell of BENCHMARK.json reads it")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    workload = found[0]
    config_entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = load_json(ROOT / config_entry["file"])
    # A mix that sets no ``chunk_size`` hands in one frame at a time.
    traffic = {"chunk_size": 1,
               **load_json(BENCH_DIR / "traffic" / f"{workload['traffic']}.json")}
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    return Cell(workload, config, traffic, end_to_end, per_layer)


def load_module(kind: str, name: str):
    """``uvo_bench/<kind>/<name>.py`` as a module (a metric's name holds dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"uvo_bench.{kind}.{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_config(cls, values: dict):
    """A frozen config dataclass from a JSON object: each field that ``values``
    names takes its value, a nested group (a dataclass default) recursively;
    the other keys of ``values`` are not the dataclass's and are ignored."""
    kw = {}
    for field in dataclasses.fields(cls):
        if field.name not in values:
            continue
        default = field.default
        if dataclasses.is_dataclass(default):
            kw[field.name] = build_config(type(default), values[field.name])
        else:
            kw[field.name] = values[field.name]
    return cls(**kw)
