"""The streamed cell ``netflix.stream_query``: its cell and configuration
from files alone, the generator at a reduced size, its four readers of
the stream's spans, and a fault in the stream's batch assignment read by
the output check, on a tiny streamed cell on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.core import spec
from benchmark.data import ratings
from benchmark.tests.conftest import (REPO, TINY, TINY_AGG_LIMITS, add_cell,
                                      run_cpu, traffic)
from benchmark.tests.test_bench_program import (fake_run, host_range,
                                                kernel, launch, load_metric,
                                                window)

CELL = "netflix.stream_query"
STREAM_METRICS = ("assign_ms.stream", "gather_ms.stream", "pin_ms.stream",
                  "h2d_ms.stream")


def _config():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "netflix_prize.json")) as f:
        return json.load(f)


def test_cell_and_configuration_load_from_files_alone():
    cell = spec.load_cell(REPO, CELL)
    assert cell.chips == 1 and cell.config_name == "netflix_prize"
    assert cell.traffic == traffic("query_scalar")
    assert cell.config["generator"] == "ratings"
    pub = cell.config["published"]
    assert (cell.config["ratings"], cell.config["users"],
            cell.config["items"]) == (100480507, 480189, 17770)
    assert (pub["ratings"], pub["users"], pub["items_rated"]) == (
        100480507, 480189, 17770)
    assert cell.config["rating_levels"] == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert cell.config["reduced"] == {}
    assert set(cell.limits) == set(TINY_AGG_LIMITS)
    assert {m.name for m in cell.end_to_end} == {
        "release_rows_per_s", "peak_device_gib", "setup_s"}
    assert {m.name for m in cell.per_layer} == set(STREAM_METRICS)
    # The default chunk streams the whole table in two batches.
    from pipelinedp_tpu_torch.plan import knobs
    chunk = int(knobs.BY_NAME["stream_chunk_rows"].default)
    assert -(-cell.config["ratings"] // chunk) == 2


def test_generator_at_a_reduced_size_keeps_the_published_ratios():
    """Ratings, users and the most-rated title at 1/500 of their counts
    over all 17,770 movies: the ratings a user makes, the share of users
    who rated the top title and the whole-star histogram stay as the
    configuration states them."""
    full = _config()
    k = 500
    cfg = dict(full, ratings=full["ratings"] // k, users=full["users"] // k,
               top_item_ratings=full["top_item_ratings"] // k)
    pid, item, value = ratings.generate(cfg, 2**33 + 5, torch.device("cpu"))
    got = ratings.summary(cfg, pid, item, value)
    assert got["ratings"] == cfg["ratings"]
    assert got["users"] == cfg["users"]
    assert got["items_rated"] == cfg["items"]
    assert got["top_item_ratings"] == cfg["top_item_ratings"]
    assert got["unique_pairs"]
    assert got["mean_ratings_per_user"] == pytest.approx(
        full["ratings"] / full["users"], rel=1e-2)
    assert got["top_item_ratings"] / got["users"] == pytest.approx(
        full["top_item_ratings"] / full["users"], rel=1e-2)
    assert set(np.unique(value).tolist()) <= set(full["rating_levels"])
    shares = np.bincount(value.astype(np.int64), minlength=6)[1:] / len(value)
    np.testing.assert_allclose(shares, full["rating_shares"], atol=5e-3)


# Two calls; the stager's ranges on one thread overlap the dispatch
# thread's, as they do in the overlapped stream.
STREAM_EVENTS = [
    window(1000.0),
    host_range("pdp.ingest.assign", 10, 60),
    host_range("pdp.ingest.stage", 70, 170),
    host_range("pdp.ingest.pin", 72, 80),
    host_range("pdp.ingest.gather", 80, 150),
    host_range("pdp.ingest.copy", 150, 160),
    launch(1, 152), kernel("Memcpy HtoD (Pinned -> Device)", 155, 185,
                           corr=1),
    host_range("pdp.stream.partials", 165, 200),
    launch(2, 170), kernel("Memcpy HtoD (Pageable -> Device)", 171, 172,
                           corr=2),
    host_range("pdp.ingest.assign", 500, 540),
    host_range("pdp.ingest.gather", 560, 600),
    host_range("pdp.ingest.copy", 600, 604),
    launch(3, 602), kernel("Memcpy HtoD (Pinned -> Device)", 610, 630,
                           corr=3),
]


@pytest.mark.parametrize("name,value", [
    ("assign_ms.stream", 90e-3 / 2),
    ("gather_ms.stream", 110e-3 / 2),
    ("pin_ms.stream", 8e-3 / 2),
    ("h2d_ms.stream", 50e-3 / 2),
])
def test_stream_readers_on_synthetic_ranges(name, value):
    assert load_metric(name).read(fake_run(STREAM_EVENTS)) == pytest.approx(
        value)


@pytest.mark.parametrize("name", STREAM_METRICS)
def test_stream_readers_read_nothing_without_their_span(name):
    span = {"assign_ms.stream": "pdp.ingest.assign",
            "gather_ms.stream": "pdp.ingest.gather",
            "pin_ms.stream": "pdp.ingest.pin",
            "h2d_ms.stream": "pdp.ingest.copy"}[name]
    events = [e for e in STREAM_EVENTS if e.name() != span]
    assert load_metric(name).read(fake_run(events)) is None
    assert load_metric(name).read(fake_run(
        [window(), launch(1, 5), kernel("k", 10, 20, corr=1)])) is None


@pytest.fixture
def streamed(root, monkeypatch):
    """A tiny cell of the Netflix cell's query that the chunk knob cuts
    into two batches."""
    from pipelinedp_tpu_torch.plan import knobs
    add_cell(root, "tiny.stream", TINY, "query_scalar",
             traffic("query_scalar"), TINY_AGG_LIMITS)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny.stream")
    with open(path, "w") as f:
        json.dump(bench, f)
    monkeypatch.setenv(knobs.BY_NAME["stream_chunk_rows"].env_var,
                       str(TINY["ratings"] // 2 + 1))
    return root


def _by_row_position(config, encoded, n_batches, seed, n_dev=1):
    """The fault: rows dealt to the batches by their position, so each
    user's rows straddle both batches and each batch bounds the user's
    partitions on its own."""
    from pipelinedp_tpu_torch.ingest.assign import group_rows_by_cell
    cells = n_batches * n_dev
    order, counts = group_rows_by_cell(np.arange(encoded.n_rows) % cells,
                                       cells)
    return order, counts.reshape(n_batches, n_dev)


def test_clean_stream_reads_correct_and_its_spans(streamed):
    r = run_cpu(streamed, "tiny.stream", seed=2**35 + 11, traced=True)
    assert r["correct"], r["checks"]
    metrics = r["metrics"]
    for name in ("assign_ms.stream", "gather_ms.stream", "pin_ms.stream"):
        assert metrics[name]["value"] > 0, name
    # No device here: nothing is copied to one.
    assert "h2d_ms.stream" not in metrics


def test_units_split_across_batches_read_not_correct(streamed, monkeypatch):
    from pipelinedp_tpu_torch import streaming
    monkeypatch.setattr(streaming, "_batch_assignment", _by_row_position)
    r = run_cpu(streamed, "tiny.stream", seed=2**35 + 11)
    assert not r["correct"]
    assert r["checks"]["count_bias"]["value"] > (
        TINY_AGG_LIMITS["count_bias"])
