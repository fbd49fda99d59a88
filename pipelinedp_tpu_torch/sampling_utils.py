"""Deterministic value sampling: the ``ValueSampler`` of
``pipelinedp_tpu/sampling_utils.py`` (capability parity with the
reference's ``pipeline_dp/sampling_utils.py``). The utility-analysis sweep
samples partitions with it when ``partitions_sampling_prob < 1``."""

from __future__ import annotations

import hashlib


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
