"""Kernel K7, the stream's batch assignment
(``pipelinedp_tpu_torch/ops/kernels/assign.py``, ``csrc/assign.cu``).

On the CPU: the host path's numpy (``streaming._batch_assignment``, which
is also K7's plain version ``group_by_cell_plain``) against the contract
written out in Python integers row by row, order and counts bit for bit,
at n = 0, 1, one warp segment and a segment's seam plus one, over 1, 2, 3
and 7 batches on 1 and 4 ranks, under seeds with the top bit set, for
random ids, ids at 0 and 2^31 - 2 and ids sharing their low bits; the
wrapper's dispatch, limits and counts, and the stream's choice of path.

On the card (``cuda`` marker): K7 against the numpy path bit for bit,
the same grid, 100,480,507 random ids at the Netflix table's shape, and a
cell space at K7's limit; one cell past the limit takes the host path.
This file imports no JAX.
"""

import types

import numpy as np
import pytest
import torch

from pipelinedp_tpu_torch import obs, streaming
from pipelinedp_tpu_torch.ops.kernels import assign

SEG = assign.SEGMENT_ROWS
SIZES = (0, 1, SEG, SEG + 1, 3 * SEG + 129)
BATCHES = (1, 2, 3, 7)
RANKS = (1, 4)
SEEDS = (2**31 + 5, 2**40 + 2**32 - 1, -7)
ID_FAMILIES = ("random", "extremes", "low_bits")
NETFLIX_ROWS = 100_480_507
NETFLIX_USERS = 480_189


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


def _ids(n, family, seed=0):
    rng = np.random.default_rng(seed)
    if family == "random":
        return rng.integers(0, 2**31 - 1, n).astype(np.int32)
    if family == "extremes":
        # Only the ends of the id range.
        return rng.choice(np.array([0, 2**31 - 2], np.int32), n)
    # Ids that differ only above bit 16.
    return (rng.integers(0, 2**15 - 1, n) << 16).astype(np.int32)


M32 = 0xFFFFFFFF


def _fmix32(x):
    """The murmur3 finalizer on one Python integer below 2^32."""
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _contract_cells(pid, n_batches, n_dev, seed):
    """Each row's cell by the contract, in Python integers."""
    cells = []
    for p in pid.tolist():
        u = p & M32
        cell = (_fmix32(u ^ (seed & M32)) * n_batches) >> 32
        if n_dev > 1:
            cell = cell * n_dev + _fmix32(u) % n_dev
        cells.append(cell)
    return cells


def _contract(pid, n_batches, n_dev, seed):
    """``(order, counts)`` by the contract: a stable sort of the rows by
    cell (Python's sort is stable) and the rows of each cell."""
    cells = _contract_cells(pid, n_batches, n_dev, seed)
    counts = [0] * (n_batches * n_dev)
    for c in cells:
        counts[c] += 1
    order = sorted(range(len(cells)), key=cells.__getitem__)
    return (np.array(order, np.int64),
            np.array(counts, np.int64).reshape(n_batches, n_dev))


def _encoded(pid):
    encoded = types.SimpleNamespace(pid=pid, n_rows=len(pid))
    config = types.SimpleNamespace(bounds_already_enforced=False)
    return config, encoded


def _host(pid, n_batches, n_dev, seed):
    """The stream's assignment on a CPU device, the host path's numpy:
    ``(order int64, counts [n_batches, n_dev])``."""
    return streaming._stream_assignment(*_encoded(pid), n_batches, seed,
                                        n_dev, torch.device("cpu"))


def _assert_same(order, counts, want_order, want_counts, what):
    """K7's and the plain version's int32 order, or the stream's int64
    one, and the counts against the wanted arrays."""
    wide = not torch.is_tensor(order)
    if not wide:
        order, counts = order.cpu().numpy(), counts.cpu().numpy()
    assert order.dtype == (np.int64 if wide else np.int32), what
    assert counts.dtype == np.int64, what
    np.testing.assert_array_equal(counts.ravel(), want_counts.ravel(),
                                  err_msg=what)
    diff = order != want_order
    assert not diff.any(), (
        f"{what}: the order differs at {int(diff.sum())} of {len(order)} "
        f"rows, first {int(np.flatnonzero(diff)[0])}")


@pytest.mark.parametrize("n_dev", RANKS)
@pytest.mark.parametrize("n_batches", BATCHES)
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_the_host_path(n, n_batches, n_dev):
    """The stream's host path and the plain version both give the
    contract's order and counts."""
    for family in ID_FAMILIES:
        pid = _ids(n, family, seed=n + n_batches)
        for seed in SEEDS:
            want = _contract(pid, n_batches, n_dev, seed)
            _assert_same(*_host(pid, n_batches, n_dev, seed), *want,
                         f"host {family} seed {seed}")
            got = assign.group_by_cell_plain(torch.from_numpy(pid),
                                             n_batches, n_dev, seed)
            _assert_same(*got, *want, f"plain {family} seed {seed}")


@pytest.mark.parametrize("family", ID_FAMILIES)
def test_cells_are_the_shard_and_batch_hashes(family):
    """A row's cell is its batch hash's bucket times the ranks plus the
    unsalted shard hash that ``parallel/sharded.py`` places rows by."""
    from pipelinedp_tpu_torch.ingest import assign as host_assign
    from pipelinedp_tpu_torch.parallel import sharded
    pid = _ids(5000, family, seed=3)
    seed = 2**31 + 17
    cell = host_assign.cell_of_rows(pid, 7, 4, seed)
    np.testing.assert_array_equal(
        cell, np.array(_contract_cells(pid, 7, 4, seed), np.int64))
    np.testing.assert_array_equal(cell % 4, sharded.shard_of_rows(pid, 4))
    np.testing.assert_array_equal(
        sharded.shard_of_rows(pid, 4),
        np.array([_fmix32(p & M32) % 4 for p in pid.tolist()], np.int64))


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    pid = torch.from_numpy(_ids(3 * SEG, "random"))
    before = dict(assign.LAUNCHES)
    got = assign.group_by_cell(pid, 3, 4, 2**31 + 1)
    want = assign.group_by_cell_plain(pid, 3, 4, 2**31 + 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert assign.LAUNCHES == before


@pytest.mark.parametrize("n_batches,n_dev,error", [
    (assign.MAX_CELLS + 1, 1, ValueError), (1025, 4, ValueError),
    (0, 1, ValueError), (2, 0, ValueError)])
def test_cell_spaces_past_the_limit_are_refused(n_batches, n_dev, error):
    pid = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(error):
        assign.group_by_cell(pid, n_batches, n_dev, 1)


def test_ids_must_be_int32():
    with pytest.raises(TypeError):
        assign.group_by_cell(torch.zeros(10, dtype=torch.int64), 2, 1, 1)


@pytest.mark.parametrize("n,n_cells", [
    (0, 2), (1, 2), (NETFLIX_ROWS, 2), (NETFLIX_ROWS, 8),
    (NETFLIX_ROWS, assign.MAX_CELLS), ((1 << 31) - 1, assign.MAX_CELLS)])
def test_segments_keep_the_table_small(n, n_cells):
    """A segment is ``SEGMENT_ROWS`` rows, or a multiple of a warp's four
    rounds large enough that the count table stays near
    ``TABLE_ENTRIES``."""
    seg = assign.segment_rows(n, n_cells)
    assert seg >= SEG and seg % 128 == 0
    n_seg = -(-n // seg)
    assert n_seg * n_cells <= assign.TABLE_ENTRIES + n_cells
    if n * n_cells <= SEG * assign.TABLE_ENTRIES:
        assert seg == SEG


def test_work_counts_one_read_and_one_write_a_row():
    w = assign.work(torch.zeros(1000, dtype=torch.int32), 4)
    assert (w.ops, w.bytes) == (1000, 8 * 1000 + 8 * 4)


def _counters():
    c = obs.ledger().snapshot()["counters"]
    return (c.get("ingest.assign_card", 0), c.get("ingest.assign_host", 0),
            c.get("ingest.assign_card_bytes", 0))


@pytest.mark.parametrize("cells", [(2, 1), (3, 4)])
def test_the_stream_assigns_on_the_host_without_a_card(cells):
    """On a CPU device the stream keeps the numpy path and counts it."""
    obs.reset()
    pid = _ids(SEG + 1, "random")
    order, counts = _host(pid, *cells, 2**31 + 3)
    _assert_same(order, counts, *_contract(pid, *cells, 2**31 + 3), "cpu")
    assert counts.shape == cells
    assert _counters() == (0, 1, 0)


def _card_stub(monkeypatch):
    """Stands in for ``streaming._card_assignment`` on the CPU: records
    its calls and answers with the contract."""
    calls = []

    def stub(pid, n_batches, n_dev, seed, device):
        calls.append((len(pid), n_batches, n_dev, device.type))
        return _contract(pid, n_batches, n_dev, seed)

    monkeypatch.setattr(streaming, "_card_assignment", stub)
    return calls


@pytest.mark.parametrize("cells", [(2, 1), (assign.MAX_CELLS // 4, 4)])
def test_a_card_stream_within_k7s_limits_assigns_on_the_card(
        cells, monkeypatch):
    """On a CUDA device, at K7's row limit and within its cells, the
    stream sends the assignment to the card and counts it there."""
    calls = _card_stub(monkeypatch)
    monkeypatch.setattr(assign, "MAX_ROWS", SEG + 1)
    obs.reset()
    pid = _ids(SEG + 1, "random", seed=4)
    streaming._stream_assignment(*_encoded(pid), cells[0], 9, cells[1],
                                 torch.device("cuda"))
    assert calls == [(SEG + 1, *cells, "cuda")]
    assert _counters()[:2] == (1, 0)


@pytest.mark.parametrize("past", ["rows", "cells"])
def test_a_card_stream_past_k7s_limits_keeps_the_host_path(
        past, monkeypatch):
    """On a CUDA device, a table past K7's rows (2^31 or more at full
    size) or a cell space past its limit takes the numpy path, counted
    as ``ingest.assign_host``, and gives the contract's answer."""
    calls = _card_stub(monkeypatch)
    monkeypatch.setattr(assign, "MAX_ROWS", SEG)
    cells = (assign.MAX_CELLS // 4 + 1, 4) if past == "cells" else (3, 1)
    obs.reset()
    pid = _ids(SEG + 1, "random", seed=5)
    got = streaming._stream_assignment(*_encoded(pid), cells[0], 2**31 + 9,
                                       cells[1], torch.device("cuda"))
    assert calls == []
    assert _counters() == (0, 1, 0)
    _assert_same(*got, *_contract(pid, *cells, 2**31 + 9), past)


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------


def _card_assignment(pid, n_batches, n_dev, seed):
    return streaming._stream_assignment(*_encoded(pid), n_batches, seed,
                                        n_dev, torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset_view"])
@pytest.mark.parametrize("n_dev", RANKS)
@pytest.mark.parametrize("n_batches", BATCHES)
@pytest.mark.parametrize("n", SIZES)
def test_cuda_kernel_matches_the_host_path(n, n_batches, n_dev, offset):
    _card()
    for family in ID_FAMILIES:
        pid = _ids(n, family, seed=n + n_batches)
        on_card = torch.from_numpy(np.concatenate(
            [np.zeros(offset, np.int32), pid])).cuda()[offset:]
        for seed in SEEDS:
            want = _host(pid, n_batches, n_dev, seed)
            got = assign.group_by_cell(on_card, n_batches, n_dev, seed)
            assert got[0].is_cuda and got[1].is_cuda
            _assert_same(*got, *want, f"{family} seed {seed}")


@pytest.mark.cuda
def test_cuda_the_netflix_shape_through_the_stream():
    """100,480,507 ids of 480,189 users in two batches, through the
    stream's own assignment on the card: K7 once, the int64 order and
    the counts of the host path, the bytes across the bus counted."""
    _card()
    pid = np.random.default_rng(23).integers(
        0, NETFLIX_USERS, NETFLIX_ROWS).astype(np.int32)
    seed = 2**40 + 2**31 + 99
    obs.reset()
    assign.reset_launches()
    order, counts = _card_assignment(pid, 2, 1, seed)
    assert assign.LAUNCHES["group_by_cell"] == 1
    c = obs.ledger().snapshot()["counters"]
    assert (c.get("ingest.assign_card", 0),
            c.get("ingest.assign_host", 0)) == (1, 0)
    # The int32 ids in, the int64 order and the counts out.
    assert c["ingest.assign_card_bytes"] == 12 * NETFLIX_ROWS + 16
    _assert_same(order, counts, *_host(pid, 2, 1, seed), "netflix")


@pytest.mark.cuda
@pytest.mark.parametrize("n_batches,n_dev", [(assign.MAX_CELLS, 1),
                                             (assign.MAX_CELLS // 4, 4)])
def test_cuda_a_cell_space_at_the_limit(n_batches, n_dev):
    _card()
    pid = _ids(3_000_017, "random", seed=5)
    order, counts = _card_assignment(pid, n_batches, n_dev, 2**31 + 77)
    _assert_same(order, counts, *_host(pid, n_batches, n_dev, 2**31 + 77),
                 f"{n_batches} x {n_dev} cells")


@pytest.mark.cuda
def test_cuda_one_cell_past_the_limit_takes_the_host_path():
    _card()
    pid = _ids(100_000, "random", seed=6)
    obs.reset()
    assign.reset_launches()
    order, counts = _card_assignment(pid, assign.MAX_CELLS // 4 + 1, 4, 11)
    assert assign.LAUNCHES["group_by_cell"] == 0
    c = obs.ledger().snapshot()["counters"]
    assert (c.get("ingest.assign_card", 0),
            c.get("ingest.assign_host", 0)) == (0, 1)
    assert order.dtype == np.int64
    want = _host(pid, assign.MAX_CELLS // 4 + 1, 4, 11)
    np.testing.assert_array_equal(order, want[0])
    np.testing.assert_array_equal(counts, want[1])
