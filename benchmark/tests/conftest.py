"""Fixtures of the benchmark's CPU tests: a throwaway checkout root in a
temporary directory, holding a copy of ``benchmark/`` plus tiny cells
added as files and entries, and the harness run on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# A rating table small enough for the port's CPU path whose most popular
# items still hold the hundreds of kept users the aggregation check
# judges on, and whose others span partition selection's threshold.
TINY = {"name": "tiny", "generator": "ratings", "ratings": 90000,
        "users": 3000, "items": 250, "top_item_ratings": 2500,
        "min_ratings_per_user": 20, "popularity_exponent": 1.5,
        "rating_levels": [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0],
        "rating_shares": [0.016, 0.031, 0.016, 0.066, 0.05, 0.196, 0.126,
                          0.266, 0.085, 0.148]}
TINY_SWEEP = dict(TINY, name="tiny_sweep", ratings=20000, users=600,
                  items=40, top_item_ratings=590,
                  rating_levels=[1.0, 2.0, 3.0, 4.0, 5.0],
                  rating_shares=[0.056, 0.108, 0.261, 0.349, 0.226])
# The checks of a tiny cell: its few judged partitions make the spreads
# swing, so its limits are wide; the faults still read far past them.
TINY_AGG_LIMITS = {"count_bias": 6.0, "sum_bias": 6.0, "count_spread": 2.0,
                   "sum_spread": 2.0, "max_abs_z": 20.0,
                   "selection_bias": 6.0, "selection_max_z": 6.0}


def add_cell(root, name, config, traffic_name, traffic, limits):
    """Adds a cell to the throwaway root as the files and entries a later
    change would add: a configuration file, a traffic file, a limits
    file and the ``BENCHMARK.json`` entries."""
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    cfg_file = f"benchmark/configs/{config['name']}.json"
    with open(os.path.join(root, cfg_file), "w") as f:
        json.dump(config, f)
    if config["name"] not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": config["name"], "source": "test",
                                 "file": cfg_file, "reduced": [],
                                 "why": "a test table"})
    with open(os.path.join(root, "benchmark", "traffic",
                           traffic_name + ".json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "benchmark", "limits", name + ".json"),
              "w") as f:
        json.dump({"limits": limits}, f)
    bench["workloads"].append({"name": name, "config": config["name"],
                               "traffic": traffic_name, "chips": 1,
                               "why": "a test cell"})
    with open(bench_path, "w") as f:
        json.dump(bench, f)


def traffic(name):
    with open(os.path.join(REPO, "benchmark", "traffic",
                           name + ".json")) as f:
        return json.load(f)


@pytest.fixture
def root(tmp_path):
    """A throwaway checkout root: ``BENCHMARK.json`` and ``benchmark/``
    copied, with the tiny cells ``tiny.query``, ``tiny.release`` and
    ``tiny.sweep`` added, each reporting the metrics of the cell it
    shrinks."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_cell(str(tmp_path), "tiny.query", TINY, "query_scalar",
             traffic("query_scalar"), TINY_AGG_LIMITS)
    add_cell(str(tmp_path), "tiny.release", TINY, "release_scalar",
             traffic("release_scalar"), TINY_AGG_LIMITS)
    sweep = dict(traffic("sweep"), l0_range=[1, 3])
    add_cell(str(tmp_path), "tiny.sweep", TINY_SWEEP, "tiny_sweep", sweep,
             {"moment_gap": 1e-3, "selection_gap": 1e-3})
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    like = {"ml25m.query_scalar": "tiny.query",
            "ml25m.release_scalar": "tiny.release",
            "ml1m.sweep": "tiny.sweep"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + [
            like[w] for w in m.get("workloads", []) if w in like]
        if not m["workloads"]:
            del m["workloads"]
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(tmp_path)


def run_cpu(root, cell, seed=12345678901, seconds=1.0, traced=False):
    """The harness on the CPU, as ``run.py`` drives it past the look for
    a card."""
    from benchmark.core import harness
    return harness.run_cell(root, cell, seed, seconds, traced,
                            torch.device("cpu"), time.perf_counter())
