"""The ordered keyed float32 sums of the utility-analysis sweep
(``pipelinedp_tpu_torch/ops/kernels/segkeyed.py``, kernel K5).

On the CPU: first the contract on XLA itself: ``jax.ops.segment_sum`` of a
``[n, Cc, k]`` update folds every column of every key in row order from
+0.0 (the sequential fold in plain Python equals it on values whose sums
depend on the order, and another order would not); then the plain version
against ``jax.ops.segment_sum`` bit for bit, at the sweep's own call
shapes (``[n, Cc, 5]`` and ``[n, Cc, 3]`` over skewed keys) and on
``segkeyed.seam_layout``'s layouts; a key without rows and a run of
``-0.0`` total +0.0; ``key_layout`` and the wrapper's checks. On the card
(``cuda`` marker): the CUDA kernel against the plain version, bit for bit,
on the same layouts and at an offset view.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pipelinedp_tpu_torch.ops.kernels import segkeyed


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _jax_sums(values, keys, P, k):
    """``jax.ops.segment_sum`` of ``values`` [n, W] seen as [n, W/k, k],
    as the sweep calls it, flattened back to [P, W]."""
    n, W = values.shape
    upd = jnp.asarray(values.reshape(n, W // k, k))
    out = jax.ops.segment_sum(upd, jnp.asarray(keys), num_segments=P)
    return np.asarray(out).reshape(P, W)


def _fold(values, keys, P):
    """A float32 left fold per key and column in plain Python."""
    out = np.zeros((P, values.shape[1]), np.float32)
    with np.errstate(over="ignore"):
        for r in range(values.shape[0]):
            out[keys[r]] = (out[keys[r]] + values[r]).astype(np.float32)
    return out


def _plain(values, keys, P):
    layout = segkeyed.key_layout(torch.from_numpy(keys), P)
    return segkeyed.segmented_sums_plain(torch.from_numpy(values),
                                         layout).numpy()


def _width_split(W):
    return 5 if W % 5 == 0 else 3


def test_order_claim_xla_cpu_folds_columns_in_row_order():
    """The ported contract: XLA's CPU scatter adds a [n, Cc, k] update
    row after row into every (key, column) from +0.0, so the sequential
    fold equals it; the same rows in reverse order would not."""
    values, keys, P = segkeyed.seam_layout("odd_width", order_sensitive=True)
    ref = _jax_sums(values, keys, P, 5)
    np.testing.assert_array_equal(_bits(ref), _bits(_fold(values, keys, P)))
    rev = _fold(values[::-1].copy(), keys[::-1].copy(), P)
    assert np.count_nonzero(_bits(rev) != _bits(ref)) > 100


@pytest.mark.parametrize("order_sensitive", [False, True])
@pytest.mark.parametrize("name", segkeyed.SEAM_LAYOUTS)
def test_plain_matches_jax_on_seam_layouts(name, order_sensitive):
    values, keys, P = segkeyed.seam_layout(name, order_sensitive)
    ref = _jax_sums(values, keys, P, _width_split(values.shape[1]))
    np.testing.assert_array_equal(_bits(_plain(values, keys, P)),
                                  _bits(ref))


@pytest.mark.parametrize("k", [5, 3])
def test_plain_matches_jax_at_sweep_shapes(k):
    """The sweep's stacks: [n, Cc, 5] per metric and [n, Cc, 3] moments,
    keyed by zipf-skewed partitions over a power-of-two P with empty
    keys."""
    rng = np.random.default_rng(7 + k)
    n, Cc, P = 3000, 6, 64
    keys = (rng.zipf(1.3, n) % 40).astype(np.int32)
    values = (rng.standard_normal((n, Cc * k)) *
              rng.choice([1e-3, 1.0, 1e4], (n, 1))).astype(np.float32)
    ref = _jax_sums(values, keys, P, k)
    np.testing.assert_array_equal(_bits(_plain(values, keys, P)),
                                  _bits(ref))


def test_empty_key_and_negative_zeros_total_plus_zero():
    keys = np.array([1, 1, 3], np.int32)
    values = np.array([[-0.0, 2.0], [-0.0, -2.0], [-0.0, 1.0]], np.float32)
    out = _plain(values, keys, 4)
    ref = _jax_sums(values, keys, 4, 2)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert not np.signbit(out).any()  # +0.0 start: -0.0 rows give +0.0


def test_key_layout_is_a_stable_order():
    keys = torch.tensor([2, 0, 2, 1, 0, 2], dtype=torch.int32)
    layout = segkeyed.key_layout(keys, 4)
    assert layout.order.tolist() == [1, 4, 3, 0, 2, 5]
    assert layout.offsets.tolist() == [0, 2, 3, 6, 6]
    assert layout.P == 4
    with pytest.raises(ValueError):
        segkeyed.key_layout(keys, 2)
    with pytest.raises(TypeError):
        segkeyed.key_layout(keys.long(), 4)


def test_wrapper_checks_and_cpu_dispatch():
    keys = torch.tensor([0, 1, 1], dtype=torch.int32)
    layout = segkeyed.key_layout(keys, 2)
    segkeyed.reset_launches()
    out = segkeyed.segmented_sums(torch.ones(3, 4), layout)
    assert out.tolist() == [[1.0] * 4, [2.0] * 4]
    assert segkeyed.LAUNCHES["segmented_sums"] == 0  # the plain version
    with pytest.raises(TypeError):
        segkeyed.segmented_sums(torch.ones(3, 4, dtype=torch.float64),
                                layout)
    with pytest.raises(ValueError):
        segkeyed.segmented_sums(torch.ones(4, 4), layout)
    with pytest.raises(ValueError):
        segkeyed.segmented_sums(torch.ones(4, 3).t(), layout)


@pytest.mark.cuda
@pytest.mark.parametrize("order_sensitive", [False, True])
@pytest.mark.parametrize("name", segkeyed.SEAM_LAYOUTS)
def test_cuda_kernel_matches_plain(name, order_sensitive):
    if not torch.cuda.is_available():
        pytest.skip("K5 is a CUDA kernel; this host has no CUDA device")
    values, keys, P = segkeyed.seam_layout(name, order_sensitive)
    layout = segkeyed.key_layout(torch.from_numpy(keys).cuda(), P)
    got = segkeyed.segmented_sums(torch.from_numpy(values).cuda(), layout)
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(_plain(values, keys, P)))
