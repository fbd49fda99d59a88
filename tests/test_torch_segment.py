"""The port's row-space segment primitives against
``pipelinedp_tpu.ops.segment``, on the CPU. Bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipelinedp_tpu.ops import segment as jax_seg
from pipelinedp_tpu_torch.ops import segment as seg


def _runs(n, seed):
    """Sorted group/run boundaries: a group boundary is also a run
    boundary, and row 0 starts both."""
    rng = np.random.default_rng(seed)
    new_run = rng.random(n) < 0.3
    new_group = new_run & (rng.random(n) < 0.4)
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


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (1000, 2),
                                    (8192, 3)])
def test_run_starts_and_rank(n, seed):
    new_run, _ = _runs(n, seed)
    t = torch.from_numpy(new_run)
    np.testing.assert_array_equal(
        seg.run_starts(t).numpy(),
        np.asarray(jax_seg.run_starts(jnp.asarray(new_run))))
    np.testing.assert_array_equal(
        seg.rank_in_run(t).numpy(),
        np.asarray(jax_seg.rank_in_run(jnp.asarray(new_run))))


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (1000, 2),
                                    (8192, 3)])
def test_run_ordinal_in_group(n, seed):
    new_run, new_group = _runs(n, seed)
    got = seg.run_ordinal_in_group(torch.from_numpy(new_run),
                                   torch.from_numpy(new_group)).numpy()
    ref = np.asarray(jax_seg.run_ordinal_in_group(jnp.asarray(new_run),
                                                  jnp.asarray(new_group)))
    np.testing.assert_array_equal(got, ref)
