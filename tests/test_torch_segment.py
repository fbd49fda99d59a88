"""The port's row-space segment primitives against
``pipelinedp_tpu.ops.segment``, on the CPU. Bit-equal: at random flags,
at n = 0, and at the seams of kernel K6's carries (``segscan.seam_layout``:
runs and groups across one tile or many, runs ending on a tile's last row,
every row marked, only row 0 marked). K6's two epilogues through the
wrapper, which takes the plain version for CPU tensors and counts no
launch: the generic one's two outputs at once, and the bounding one's
Linf/L0 sample against ``jax_engine._partials``' arithmetic."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipelinedp_tpu.ops import segment as jax_seg
from pipelinedp_tpu_torch.ops import segment as seg
from pipelinedp_tpu_torch.ops.kernels import segscan


def _runs(n, seed):
    """Sorted group/run boundaries: a group boundary is also a run
    boundary, and row 0 starts both. A ``seed`` that names a layout of
    ``segscan.seam_layout`` gives that layout (``n`` is None)."""
    if isinstance(seed, str):
        return segscan.seam_layout(seed)
    rng = np.random.default_rng(seed)
    new_run = rng.random(n) < 0.3
    new_group = new_run & (rng.random(n) < 0.4)
    if n:
        new_run[0] = new_group[0] = True
    return new_run, new_group


def test_pad_id():
    assert seg.PAD_ID == int(jax_seg.PAD_ID)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fmix32(seed):
    x = np.random.default_rng(seed).integers(0, 2**32, 100_000,
                                             dtype=np.uint32)
    x[:4] = [0, 1, 2**31 - 1, 2**32 - 1]
    ref = np.asarray(jax_seg.fmix32(jnp.asarray(x))).astype(np.int64)
    got = seg.fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)


# Random flags at a few sizes, then n = 0, then the seam layouts.
CASES = [(1, 0), (2, 1), (1000, 2), (8192, 3), (0, 4)] + [
    pytest.param(None, name, id=name) for name in segscan.SEAM_LAYOUTS]


@pytest.mark.parametrize("n,seed", CASES)
def test_run_starts_and_rank(n, seed):
    new_run, _ = _runs(n, seed)
    t = torch.from_numpy(new_run)
    np.testing.assert_array_equal(
        seg.run_starts(t).numpy(),
        np.asarray(jax_seg.run_starts(jnp.asarray(new_run))))
    np.testing.assert_array_equal(
        seg.rank_in_run(t).numpy(),
        np.asarray(jax_seg.rank_in_run(jnp.asarray(new_run))))


@pytest.mark.parametrize("n,seed", CASES)
def test_run_ordinal_in_group(n, seed):
    new_run, new_group = _runs(n, seed)
    got = seg.run_ordinal_in_group(torch.from_numpy(new_run),
                                   torch.from_numpy(new_group)).numpy()
    ref = np.asarray(jax_seg.run_ordinal_in_group(jnp.asarray(new_run),
                                                  jnp.asarray(new_group)))
    np.testing.assert_array_equal(got, ref)
    # K6's generic epilogue gives both outputs of one scan.
    start, ordinal = segscan.run_scan(torch.from_numpy(new_run),
                                      torch.from_numpy(new_group))
    np.testing.assert_array_equal(ordinal.numpy(), ref)
    np.testing.assert_array_equal(
        start.numpy(), np.asarray(jax_seg.run_starts(jnp.asarray(new_run))))


@pytest.mark.parametrize("linf,l0", [(1, 1), (2, 4), (3, 2), (None, 10**6),
                                     (0, 0)])
@pytest.mark.parametrize("n,seed", CASES)
def test_bound_linf_l0_matches_jax_arithmetic(n, seed, linf, l0):
    """K6's bounding epilogue: ``keep_row`` and ``seg_marker`` of
    ``jax_engine._partials`` (Linf by rank in run, L0 by run ordinal in
    the pid), with the runs as (pid, pk) segments and the groups as pids;
    no Linf cap is the row count."""
    new_seg, new_pid = _runs(n, seed)
    linf_cap = len(new_seg) if linf is None else linf
    keep_l0 = jax_seg.run_ordinal_in_group(jnp.asarray(new_seg),
                                           jnp.asarray(new_pid)) < l0
    want_keep = (jax_seg.rank_in_run(jnp.asarray(new_seg)) < linf_cap) \
        & keep_l0
    want_marker = jnp.asarray(new_seg) & keep_l0
    keep_row, seg_marker = segscan.bound_linf_l0(
        torch.from_numpy(new_seg), torch.from_numpy(new_pid), linf_cap, l0)
    assert keep_row.dtype == seg_marker.dtype == torch.bool
    np.testing.assert_array_equal(keep_row.numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(seg_marker.numpy(),
                                  np.asarray(want_marker))


def test_cpu_tensors_count_no_k6_launch():
    new_run, new_group = _runs(8192, 5)
    r, g = torch.from_numpy(new_run), torch.from_numpy(new_group)
    before = dict(segscan.LAUNCHES)
    seg.run_starts(r)
    seg.rank_in_run(r)
    seg.run_ordinal_in_group(r, g)
    segscan.run_scan(r, g)
    segscan.bound_linf_l0(r, g, 2, 4)
    assert segscan.LAUNCHES == before


@pytest.mark.parametrize("bad", ["int_flags", "shape", "two_dims"])
def test_k6_wrappers_reject_what_the_kernel_does_not_take(bad):
    new_run = torch.zeros(10, dtype=torch.bool)
    new_group = torch.zeros(10, dtype=torch.bool)
    if bad == "int_flags":
        new_group = new_group.int()
    elif bad == "shape":
        new_group = new_group[:5]
    else:
        new_run, new_group = new_run[None], new_group[None]
    with pytest.raises((TypeError, ValueError)):
        segscan.run_scan(new_run, new_group)
    with pytest.raises((TypeError, ValueError)):
        segscan.bound_linf_l0(new_run, new_group, 2, 4)
