"""Kernel K6, the run scans of the bounding and the sweep
(``pipelinedp_tpu_torch/ops/kernels/segscan.py``, ``csrc/segscan.cu``), on
the card (``cuda`` marker), against its plain version (``cummax``), bit for
bit: the generic epilogue (both outputs, and each alone) and the bounding
epilogue at the seams of its carries (``segscan.seam_layout``), as offset
views, at n = 0, 1, one tile and 25,000,095 rows (the MovieLens-25M table's
count), at ML-1M's stage-A shape with ``_run_ends``, and
``torch_engine._bound_sorted``'s ``keep_row`` and ``seg_marker`` with the
bounding epilogue against the same call with the plain one, alone and as a
fused batch (``req``). The plain version is held to the JAX package in
``tests/test_torch_segment.py``; this file imports no JAX.
"""

import numpy as np
import pytest
import torch

from pipelinedp_tpu_torch.ops.kernels import segscan

CAPS = ((1, 1), (2, 4), (3, 2), (0, 0))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


def _random(n, seed, run_rate=0.3, group_rate=0.4):
    rng = np.random.default_rng(seed)
    new_run = rng.random(n) < run_rate
    new_group = new_run & (rng.random(n) < group_rate)
    if n:
        new_run[0] = new_group[0] = True
    return new_run, new_group


def _case(case):
    if case in segscan.SEAM_LAYOUTS:
        return segscan.seam_layout(case)
    if case == "ml25m_rows":
        # Users of about 150 rows, (user, item) pairs of one or two rows.
        return _random(25_000_095, 70, run_rate=0.7, group_rate=0.0067)
    if case == "ml1m_stage_a":
        # The sweep's stage A over ML-1M: 1,000,209 rows sorted by (user,
        # item), users of about 165 rows, every pair one row.
        return _random(1_000_209, 71, run_rate=1.0, group_rate=1 / 165)
    return _random(int(case[1:]), 72)


def _on_card(flags, offset):
    pad = np.zeros(offset, bool)
    return torch.from_numpy(np.concatenate([pad, flags])).cuda()[offset:]


def _assert_equal(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    diff = got != want
    assert not bool(diff.any()), (
        f"{what}: K6 differs from its plain version at "
        f"{int(diff.sum())} rows, first {int(diff.nonzero()[0])}")


CASES = list(segscan.SEAM_LAYOUTS) + [
    "n0", "n1", f"n{segscan.TILE_ROWS}", f"n{segscan.TILE_ROWS + 1}",
    "ml25m_rows", "ml1m_stage_a"]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset_view"])
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(case, offset):
    _card()
    new_run, new_group = _case(case)
    r, g = _on_card(new_run, offset), _on_card(new_group, offset)
    start, ordinal = segscan.run_scan_plain(r, g)
    got_start, got_ord = segscan.run_scan(r, g)
    _assert_equal(got_start, start, "run_start")
    _assert_equal(got_ord, ordinal, "run_ord")
    _assert_equal(segscan.run_scan(r)[0], start, "run_start alone")
    assert segscan.run_scan(r)[1] is None
    got = segscan.run_scan(r, g, starts=False)
    assert got[0] is None
    _assert_equal(got[1], ordinal, "run_ord alone")
    for linf_cap, l0 in CAPS + ((len(new_run), 10**6),):
        got = segscan.bound_linf_l0(r, g, linf_cap, l0)
        want = segscan.bound_linf_l0_plain(r, g, linf_cap, l0)
        _assert_equal(got[0], want[0], f"keep_row {linf_cap} {l0}")
        _assert_equal(got[1], want[1], f"seg_marker {linf_cap} {l0}")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_run_ends_at_ml1m_stage_a():
    _card()
    from pipelinedp_tpu_torch.analysis import torch_sweep
    for flags in _case("ml1m_stage_a"):
        f = torch.from_numpy(flags).cuda()
        want = len(flags) - 1 - torch.flip(segscan.run_scan_plain(
            torch.flip(torch_sweep._last_of_run(f), (0,)))[0], (0,))
        _assert_equal(torch_sweep._run_ends(f), want, "_run_ends")


@pytest.mark.cuda
def test_cuda_launches_count_one_per_epilogue_call():
    _card()
    new_run, new_group = (torch.from_numpy(x).cuda()
                          for x in _random(10_000, 73))
    segscan.reset_launches()
    segscan.run_scan(new_run, new_group)
    segscan.run_scan(new_run)
    segscan.bound_linf_l0(new_run, new_group, 2, 4)
    empty = torch.zeros(0, dtype=torch.bool, device="cuda")
    assert segscan.run_scan(empty, empty)[1].shape == (0,)
    assert segscan.LAUNCHES == {"run_scan": 2, "bound_linf_l0": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["solo", "with_req"])
def test_cuda_bound_sorted_epilogue_matches_plain(fused, monkeypatch):
    """``_bound_sorted``'s ``keep_row`` and ``seg_marker`` through K6's
    bounding epilogue against the same call through the plain epilogue,
    on the same card tensors; ``with_req`` is a fused batch of three
    requests, whose runs break where the request changes."""
    _card()
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    from pipelinedp_tpu_torch.ops import prng
    rng = np.random.default_rng(74)
    n = 300_000
    pid = torch.from_numpy(rng.integers(0, 2000, n).astype(np.int32)).cuda()
    pk = torch.from_numpy(rng.integers(0, 300, n).astype(np.int32)).cuda()
    values = torch.from_numpy(rng.random(n).astype(np.float32)).cuda()
    config = te.FusedConfig.from_params(pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
        noise_kind=pdt.NoiseKind.LAPLACE, max_partitions_contributed=3,
        max_contributions_per_partition=2, min_value=0.0, max_value=1.0),
        public=False)
    req = None
    if fused:
        req = torch.repeat_interleave(
            torch.arange(3, device="cuda"),
            torch.tensor([100_000, 150_000, 50_000], device="cuda"))

    def bound():
        streams = te._bounding_streams(pid, pk, prng.PRNGKey(9))
        return te._bound_sorted(config, pid, pk, values, streams, req)

    segscan.reset_launches()
    got = bound()
    assert segscan.LAUNCHES["bound_linf_l0"] == 1
    monkeypatch.setattr(segscan, "bound_linf_l0",
                        segscan.bound_linf_l0_plain)
    want = bound()
    _assert_equal(got.keep_row, want.keep_row, "keep_row")
    _assert_equal(got.seg_marker, want.seg_marker, "seg_marker")
    assert bool(got.keep_row.any()) and not bool(got.keep_row.all())
