"""A run with the timed path broken underneath reads ``correct`` false:
half of the batch left out (the rows past the middle, so half of the
users go), one answer altered where the program produces it, by far
more than the noise, and partition selection left out or given twice its
budget. The harness runs on the CPU past its look for a card."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.data import ratings
from benchmark.tests.conftest import TINY, TINY_AGG_LIMITS, run_cpu


def _half_rows(encode):
    def broken(*args, **kwargs):
        e = encode(*args, **kwargs)
        keep = slice(0, e.n_rows // 2)
        return dataclasses.replace(
            e, pid=e.pid[keep], pk=e.pk[keep], values=e.values[keep],
            n_rows=len(e.pid[keep]))
    return broken


def test_clean_runs_read_correct(root):
    assert run_cpu(root, "tiny.release")["correct"]
    assert run_cpu(root, "tiny.sweep")["correct"]


@pytest.mark.parametrize("cell", ["tiny.query", "tiny.release"])
def test_aggregation_with_half_the_rows_left_out_is_not_correct(
        root, cell, monkeypatch):
    from pipelinedp_tpu_torch import torch_engine
    monkeypatch.setattr(torch_engine, "encode",
                        _half_rows(torch_engine.encode))
    r = run_cpu(root, cell)
    assert not r["correct"]
    assert r["checks"]["count_bias"]["value"] > TINY_AGG_LIMITS["count_bias"]


def test_aggregation_with_one_answer_altered_is_not_correct(root,
                                                            monkeypatch):
    from pipelinedp_tpu_torch import torch_engine
    release = torch_engine.LazyFusedResult._finish_release
    seed = 12345678901
    # The most rated movie: its release is always among those judged.
    _, item, _ = ratings.generate(TINY, seed, torch.device("cpu"))
    top = int(np.argmax(np.bincount(item)))

    def altered(self, *args, **kwargs):
        rows = release(self, *args, **kwargs)
        i = [k for k, _ in rows].index(top)
        key, m = rows[i]
        rows[i] = (key, m._replace(count=m.count + 1e4))
        return rows

    monkeypatch.setattr(torch_engine.LazyFusedResult, "_finish_release",
                        altered)
    r = run_cpu(root, "tiny.query", seed=seed)
    assert not r["correct"]
    assert r["checks"]["max_abs_z"]["value"] > 20


def _selection(monkeypatch, broken):
    from pipelinedp_tpu_torch import torch_engine
    monkeypatch.setattr(torch_engine, "selection_inputs",
                        broken(torch_engine.selection_inputs))


def test_aggregation_with_selection_left_out_is_not_correct(root,
                                                           monkeypatch):
    def every_partition(inputs):
        def broken(*args, **kwargs):
            table, *rest = inputs(*args, **kwargs)
            return (np.ones_like(table), *rest)
        return broken

    _selection(monkeypatch, every_partition)
    r = run_cpu(root, "tiny.query")
    assert not r["correct"]
    assert (r["checks"]["selection_bias"]["value"] >
            3 * TINY_AGG_LIMITS["selection_bias"])


def test_aggregation_with_twice_the_selection_budget_is_not_correct(
        root, monkeypatch):
    def doubled(inputs):
        def broken(config, eps, delta, pre_threshold):
            return inputs(config, 2 * eps, delta, pre_threshold)
        return broken

    _selection(monkeypatch, doubled)
    r = run_cpu(root, "tiny.query")
    assert not r["correct"]
    assert (r["checks"]["selection_bias"]["value"] >
            TINY_AGG_LIMITS["selection_bias"])


def test_sweep_with_half_the_rows_left_out_is_not_correct(root,
                                                          monkeypatch):
    from pipelinedp_tpu_torch.analysis import torch_sweep
    monkeypatch.setattr(torch_sweep, "encode",
                        _half_rows(torch_sweep.encode))
    r = run_cpu(root, "tiny.sweep")
    assert not r["correct"]


def test_sweep_with_one_answer_altered_is_not_correct(root, monkeypatch):
    from pipelinedp_tpu_torch.analysis import torch_sweep
    pack = torch_sweep.LazySweepResult._pack

    def altered(self, *args, **kwargs):
        out = pack(self, *args, **kwargs)
        out[1].count_metrics.error_variance *= 1.01
        return out

    monkeypatch.setattr(torch_sweep.LazySweepResult, "_pack", altered)
    r = run_cpu(root, "tiny.sweep")
    assert not r["correct"]
    assert r["checks"]["moment_gap"]["value"] > 5e-3
