"""Sampling helpers: a copy of ``pipelinedp_tpu/sampling_utils.py``
(capability parity with the reference's ``pipeline_dp/sampling_utils.py``).
The contribution bounders and ``select_partitions`` of the host graph
sample with ``choose_from_list_without_replacement``; the utility-analysis
sweep samples partitions with ``ValueSampler`` when
``partitions_sampling_prob < 1``."""

from __future__ import annotations

import hashlib
from typing import List

from pipelinedp_tpu_torch.ops import noise as noise_ops


def choose_from_list_without_replacement(a: List, size: int) -> List:
    """Uniform sample without replacement, preserving element types.

    Indices (not elements) are drawn so values never round-trip through
    numpy scalar types: accumulator objects and big ints survive
    untouched. Draws from the module-global host RNG
    (``ops.noise._host_rng``), so the same ``seed_host_rng`` seed gives
    the JAX package's sample."""
    if len(a) <= size:
        return a
    sampled_indices = noise_ops._host_rng.choice(len(a), size,
                                                 replace=False)
    return [a[i] for i in sampled_indices]


def _compute_64bit_hash(v) -> int:
    m = hashlib.sha1()
    m.update(repr(v).encode())
    return int(m.hexdigest()[:16], 16)


class ValueSampler:
    """Deterministic keep-decision by hashing (reference :38-51): a fixed
    value always gets the same decision; over random values the keep rate
    is ``sampling_rate``. The same value gets the same decision in both
    packages, so the port samples the partitions the JAX package does."""

    def __init__(self, sampling_rate: float):
        if not 0 <= sampling_rate <= 1:
            raise ValueError("sampling_rate must be in [0, 1]")
        self._sample_bound = int(round(2**64 * sampling_rate))

    def keep(self, value) -> bool:
        return _compute_64bit_hash(value) < self._sample_bound
