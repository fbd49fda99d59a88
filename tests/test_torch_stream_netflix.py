"""The port's stream on a table of the Netflix Prize configuration's shape
(``benchmark/configs/netflix_prize.json`` through the benchmark's
generator at 1/500 of its ratings, users and most-rated title, over all
17,770 movies), cut by the chunk knob into two batches, on the CPU.

Held here: the folded pre-noise per-movie columns against a plain-torch
group-by of the table under caps that do not bind; serial and overlapped
runs releasing the same bits with every span on; the stream's ingest
spans and byte counters, and the worker threads' ranges reaching a
``torch.profiler`` trace; the streamed release importing no JAX; and, on
the card (``cuda`` marker), the release with the batch assignment on the
card (K7) against the same release with the host's."""

import collections
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs, streaming
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.native import thread_state
from pipelinedp_tpu_torch.plan import knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK_ENV = knobs.BY_NAME["stream_chunk_rows"].env_var
SHRINK = 500
RELEASE_EPS = 50.0


def _table():
    sys.path.insert(0, REPO)
    from benchmark.data import ratings
    with open(os.path.join(REPO, "benchmark", "configs",
                           "netflix_prize.json")) as f:
        cfg = json.load(f)
    cfg = dict(cfg, ratings=cfg["ratings"] // SHRINK,
               users=cfg["users"] // SHRINK,
               top_item_ratings=cfg["top_item_ratings"] // SHRINK)
    return ratings.generate(cfg, 2**33 + 23, torch.device("cpu"))


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.fixture
def two_batches(table, monkeypatch):
    monkeypatch.setenv(CHUNK_ENV, str(len(table[0]) // 2 + 1))
    return table


def _params(l0=4, linf=2):
    return pdt.AggregateParams(
        metrics=[pdt.Metrics.MEAN, pdt.Metrics.COUNT, pdt.Metrics.SUM],
        noise_kind=pdt.NoiseKind.LAPLACE, max_partitions_contributed=l0,
        max_contributions_per_partition=linf, min_value=0.0, max_value=5.0)


def _aggregate(table, params, executor=None, eps=1.0, device="cpu"):
    pid, pk, value = table
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    backend = pdt.TorchBackend(device, rng_seed=2**32 + 9,
                               ingest_executor=executor)
    res = pdt.DPEngine(acc, backend).aggregate(
        pdt.ArrayDataset(privacy_ids=pid, partition_keys=pk, values=value),
        params, pdt.DataExtractors())
    acc.compute_budgets()
    return list(res), res.timings


def _bits(rows):
    return [(k, [np.float64(x).tobytes() for x in m]) for k, m in rows]


def test_folded_columns_equal_a_plain_group_by(two_batches, monkeypatch):
    """With L0 above every user's movie count and Linf above a pair's one
    rating, bounding keeps every row: the folded counts are each movie's
    ratings, and the folded normalized sums are the plain group-by of the
    ratings on the lanes' grid (float32 ``round((v - mid) * scale)``
    steps, one float64 division by the scale), bit for bit, within half a
    step a rating of the float64 sums of ``v - mid``."""
    pid, pk, value = two_batches
    got = {}
    stream = streaming.stream_partials_and_select

    def spy(config, encoded, *args, **kwargs):
        keep, part64, stats = stream(config, encoded, *args, **kwargs)
        got.update(vocab=encoded.pk_vocab, part64=part64, stats=stats)
        return keep, part64, stats

    monkeypatch.setattr(streaming, "stream_partials_and_select", spy)
    l0 = int(np.bincount(pid).max()) + 1
    _aggregate(two_batches, _params(l0=l0, linf=2))
    assert got["stats"]["n_batches"] == 2
    vocab = np.asarray(got["vocab"])
    P = len(vocab)
    assert P == 17770
    idx = torch.from_numpy(np.searchsorted(vocab, pk))
    count = torch.bincount(idx, minlength=P)
    part64 = got["part64"]
    np.testing.assert_array_equal(part64["count"][:P], count.numpy())
    assert not part64["count"][P:].any()

    # The query's one lane column: values centred on the middle of [0, 5].
    spec = te._FxSpec("nsum", 2.5, True, "count")
    centred = torch.from_numpy(value).to(torch.float32) - torch.tensor(
        2.5, dtype=torch.float32)
    steps = torch.round(centred * torch.tensor(spec.scale,
                                               dtype=torch.float32))
    want = torch.bincount(idx, weights=steps.double(), minlength=P)
    want = (want / spec.scale).numpy()
    np.testing.assert_array_equal(part64["nsum"][:P], want)
    exact = torch.bincount(idx, weights=torch.from_numpy(value).double() -
                           2.5, minlength=P).numpy()
    assert np.all(np.abs(part64["nsum"][:P] - exact) <=
                  count.numpy() * 0.5 / spec.scale + 1e-9)


def test_serial_and_overlapped_release_the_same_bits_with_spans_on(
        two_batches, monkeypatch):
    monkeypatch.setenv(obs.ENV_VAR, "1")
    # A budget at which most movies pass selection at this size.
    serial, st = _aggregate(two_batches, _params(l0=100), executor=False,
                            eps=RELEASE_EPS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        overlapped, ot = _aggregate(two_batches, _params(l0=100),
                                    executor=True, eps=RELEASE_EPS)
    assert (st["stream_executor"], ot["stream_executor"]) == (
        "serial", "overlapped")
    assert st["stream_batches"] == ot["stream_batches"] == 2
    assert len(serial) > 100
    assert _bits(serial) == _bits(overlapped)


@pytest.mark.parametrize("executor", [False, True])
def test_one_assign_and_a_gather_and_copy_per_batch(two_batches, executor,
                                                    monkeypatch):
    monkeypatch.setenv(obs.ENV_VAR, "1")
    obs.reset()
    _, timings = _aggregate(two_batches, _params(), executor=executor)
    n = timings["stream_batches"]
    assert n == 2
    snap = obs.ledger().snapshot()
    spans = collections.defaultdict(list)
    for s in snap["spans"]:
        spans[s.name].append(s)
    assert len(spans["ingest.assign"]) == 1
    for name in ("ingest.gather", "ingest.copy"):
        assert sorted(s.args["batch"] for s in spans[name]) == list(range(n))
    # The ring's two sets, allocated by the first two batches, each once.
    assert sorted(s.args["batch"] for s in spans["ingest.pin"]) == [0, 1]
    stage = {s.args["batch"]: s for s in spans["ingest.stage"]}
    for name in ("ingest.pin", "ingest.gather", "ingest.copy"):
        for s in spans[name]:
            outer = stage[s.args["batch"]]
            assert outer.ts <= s.ts and s.ts + s.dur <= outer.ts + outer.dur
    rows = len(two_batches[0])
    counters = snap["counters"]
    # int32 ids, int32 keys and float32 values: 12 bytes a staged row.
    assert counters["ingest.gathered_bytes"] == 12 * rows
    batch_rows = [s.args["rows"] for s in spans["ingest.gather"]]
    assert sum(batch_rows) == rows
    assert counters["ingest.pinned_bytes"] == 2 * 12 * max(batch_rows)


@pytest.mark.cuda
def test_cuda_the_card_assignment_releases_the_host_assignments_bits(
        two_batches, monkeypatch):
    """Through the overlapped executor on the card, the release with the
    batch assignment on the card (K7, once a call) has the bits of the
    same release with the host's numpy assignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    from pipelinedp_tpu_torch.ops.kernels import assign

    def run():
        obs.reset()
        assign.reset_launches()
        rows, timings = _aggregate(two_batches, _params(l0=100),
                                   executor=True, eps=RELEASE_EPS,
                                   device="cuda")
        assert timings["stream_executor"] == "overlapped"
        assert timings["stream_batches"] == 2
        c = obs.ledger().snapshot()["counters"]
        return rows, (c.get("ingest.assign_card", 0),
                      c.get("ingest.assign_host", 0),
                      assign.LAUNCHES["group_by_cell"])

    card, card_paths = run()
    # A cell limit of one sends the stream's two cells to the host.
    monkeypatch.setattr(assign, "MAX_CELLS", 1)
    host, host_paths = run()
    assert card_paths == (1, 0, 1)
    assert host_paths == (0, 1, 0)
    assert len(card) > 100
    assert _bits(card) == _bits(host)


def test_the_profiler_records_the_worker_threads_ranges(two_batches):
    """A ``torch.profiler`` started on the calling thread records the
    stager's and the fold worker's ``pdp.ingest.*`` ranges, on their own
    threads."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, timings = _aggregate(two_batches, _params(), executor=True)
    assert timings["stream_executor"] == "overlapped"
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("pdp.ingest.")]
    names = collections.Counter(e.name() for e in events)
    for name in ("gather", "copy", "stage", "fetch", "fold"):
        assert names["pdp.ingest." + name] == 2, names
    assert names["pdp.ingest.assign"] == 1
    main = {e.start_thread_id() for e in events
            if e.name() == "pdp.ingest.assign"}
    stager = {e.start_thread_id() for e in events
              if e.name() == "pdp.ingest.gather"}
    folder = {e.start_thread_id() for e in events
              if e.name() == "pdp.ingest.fold"}
    assert len(stager) == len(folder) == 1
    assert len(main | stager | folder) == 3


def test_entered_state_is_the_capturing_threads_and_is_undone():
    """``thread_state.entered`` runs a block under another thread's
    PyTorch state (here its grad mode) and restores the thread's own."""
    with torch.no_grad():
        state = thread_state.capture()
    assert state is not None
    seen = []

    def body():
        seen.append(torch.is_grad_enabled())
        with thread_state.entered(state):
            seen.append(torch.is_grad_enabled())
        seen.append(torch.is_grad_enabled())

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert seen == [True, False, True]


def test_streamed_release_imports_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import tests.test_torch_stream_netflix as t\n"
        "table = t._table()\n"
        "rows, timings = t._aggregate(table, t._params(l0=100), "
        "executor=True, eps=t.RELEASE_EPS)\n"
        "assert timings['stream_batches'] == 2 and len(rows) > 100\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pipelinedp_tpu')))\n") % REPO
    env = {k: v for k, v in os.environ.items() if k != CHUNK_ENV}
    env[CHUNK_ENV] = str(len(_table()[0]) // 2 + 1)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
