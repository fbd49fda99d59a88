"""The controls of each cell's output check come out not correct, at a
size a test run holds: the numbers each is for read past the cell's
limits, while the reference's own sound release, or its float32 sweep,
reads under them."""

import json
import os

import torch

from benchmark.core import spec
from benchmark.tests.conftest import REPO, TINY, TINY_SWEEP

CPU = torch.device("cpu")


def _cell(name, config):
    cell = spec.load_cell(REPO, name)
    cell.config = config
    return cell


def test_aggregation_controls_fail_their_numbers():
    from benchmark.runners import aggregate
    # A small table with both judged partitions and partitions across
    # selection's threshold: the sound release is checked against the
    # real cell's limits where few partitions leave them meaningful, the
    # controls' numbers against them all.
    counts = ("count_bias", "sum_bias", "count_spread", "sum_spread",
              "max_abs_z")
    selection = ("selection_bias", "selection_max_z")
    for name in ("ml25m.query_scalar", "ml25m.release_scalar"):
        cell = _cell(name, dict(TINY, users=6000, ratings=180000,
                                items=1500, top_item_ratings=5000))
        assert set(cell.limits) == set(counts + selection)
        for seed in (1, 2**35 + 2, 3):
            got = aggregate.control(cell, seed, CPU)
            for k in counts + selection:
                assert got["control"][k] > 3 * cell.limits[k], (name, k, got)
            for k in selection:
                assert got["no_selection"][k] > 3 * cell.limits[k], (
                    name, k, got)
            for k in ("count_bias", "max_abs_z", "selection_bias"):
                assert got["model"][k] < cell.limits[k], (name, k, got)


def test_sweep_control_fails_every_number():
    from benchmark.runners import sweep
    cell = _cell("ml1m.sweep", TINY_SWEEP)
    cell.traffic = dict(cell.traffic, l0_range=[1, 4])
    for seed in (4, 2**34 + 5, 6):
        got = sweep.control(cell, seed, CPU)
        for k, limit in cell.limits.items():
            assert got["control"][k] > 3 * limit, (k, got)
            assert got["float32"][k] < limit, (k, got)


def test_limits_hold_the_readings_they_were_set_from():
    """Each limit lies above the largest sound reading and below the
    smallest control reading written beside it."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for name in cells:
        with open(os.path.join(REPO, "benchmark", "limits",
                               name + ".json")) as f:
            doc = json.load(f)
        for k, limit in doc["limits"].items():
            lower, upper = doc["lower"][k], doc["upper"][k]
            assert lower < limit < upper, (name, k)
            assert upper >= 3 * lower, (name, k)
