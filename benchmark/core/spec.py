"""Finds everything one cell needs from ``BENCHMARK.json`` and the files
named after its entries:

- the configuration: the ``file`` of its ``configs`` entry;
- the traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``runner``
  names the module of ``benchmark/runners/`` that runs it;
- each metric: ``benchmark/metrics/<name>.py``, a reader with
  ``read(run)``;
- the limits of the comparison that decides ``correct``:
  ``benchmark/limits/<cell>.json``.

Nothing here knows a cell, a configuration or a metric by name, so a new
one is new files and entries, with no edit to any file here."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List

BENCH_DIR = "benchmark"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    read: Callable[[Any], Any]
    module: Any


@dataclasses.dataclass
class Cell:
    root: str
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Imports the Python file at ``path`` under the module name
    ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _metric(root: str, entry: Dict[str, Any]) -> Metric:
    path = os.path.join(root, BENCH_DIR, "metrics", entry["name"] + ".py")
    module = load_module(path, "benchmark_metric_" +
                         entry["name"].replace(".", "_"))
    return Metric(entry["name"], entry["unit"], entry["better"],
                  entry["source"], module.read, module)


def _applies(entry: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: str, workload: str) -> Cell:
    """The cell named ``workload`` of ``<root>/BENCHMARK.json``; raises
    ``KeyError`` for a name the file does not hold."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[cell["config"]]
    config = _load_json(os.path.join(root, config_entry["file"]))
    traffic = _load_json(os.path.join(root, BENCH_DIR, "traffic",
                                      cell["traffic"] + ".json"))
    limits = _load_json(os.path.join(root, BENCH_DIR, "limits",
                                     workload + ".json"))
    return Cell(
        root=root, name=workload, chips=int(cell["chips"]),
        config_name=cell["config"], config=config,
        traffic_name=cell["traffic"], traffic=traffic,
        limits={k: float(v) for k, v in limits["limits"].items()},
        end_to_end=[_metric(root, m) for m in bench["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[_metric(root, m) for m in bench["per_layer"]
                   if _applies(m, workload)])


def load_generator(cell: Cell):
    """The module of ``benchmark/data/`` the cell's configuration names
    as its ``generator``."""
    name = cell.config["generator"]
    return load_module(os.path.join(cell.root, BENCH_DIR, "data",
                                    name + ".py"),
                       "benchmark_generator_" + name)


def load_runner(cell: Cell):
    """The module of ``benchmark/runners/`` the cell's traffic names."""
    path = os.path.join(cell.root, BENCH_DIR, "runners",
                        cell.traffic["runner"] + ".py")
    return load_module(path, "benchmark_runner_" + cell.traffic["runner"])
