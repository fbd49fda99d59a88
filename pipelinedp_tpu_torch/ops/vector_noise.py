"""Batched per-coordinate vector noise on the engine's device.

Port of ``pipelinedp_tpu/ops/vector_noise.py``. VECTOR_SUM's release adds
independent calibrated noise to every coordinate of every released [D]
vector. The draw is one batched counter-based threefry pass
(``ops/counter_rng.py``): the (global partition vocab index, coordinate
index) pair is the counter, so a partition's noise vector is the same
wherever it is released (compact or full fetch, public or private
partitions), and the same as the JAX package's for the same seed.

The key is the engine seed folded with a stream label of its own
(``0x7EC``). The hardened path does not come here: with
``set_secure_host_noise(True)`` and no ``rng``, the engine releases
VECTOR_SUM through the host's native samplers, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pipelinedp_tpu_torch.aggregate_params import NoiseKind
from pipelinedp_tpu_torch.ops import counter_rng
from pipelinedp_tpu_torch.ops import noise as noise_ops
from pipelinedp_tpu_torch.ops import prng

#: Stream label folded into the engine key for the vector-noise counter
#: stream (selection uses the raw key, the quantile tree 0x7EE).
_VECTOR_STREAM = 0x7EC


def unit_noise_block(noise_kind: NoiseKind, seed: int, pk_index, d: int,
                     device="cpu") -> np.ndarray:
    """[len(pk_index), d] float32 unit-scale noise, element (i, j) a pure
    function of (seed, pk_index[i], j), drawn on ``device`` and returned
    on the host."""
    key = prng.fold_in(prng.PRNGKey(int(seed) & prng.MASK32),
                       _VECTOR_STREAM)
    pk = torch.as_tensor(np.asarray(pk_index, dtype=np.int64) & prng.MASK32,
                         device=device)
    n = pk.shape[0]
    x0 = pk[:, None].expand(n, d)
    x1 = torch.arange(d, dtype=torch.int64, device=device)[None, :].expand(
        n, d)
    if noise_kind == NoiseKind.LAPLACE:
        block = counter_rng.laplace(key, x0, x1)
    else:
        block = counter_rng.normal(key, x0, x1)
    return block.cpu().numpy()


def add_vector_noise(clipped: np.ndarray, noise_params,
                     rng_seed: Optional[int], pk_index=None,
                     device="cpu") -> np.ndarray:
    """``clipped`` [n, D] float64 (already norm-clipped) plus the unit
    draws times the calibrated per-coordinate scale of
    ``dp_computations.add_noise_vector``, in float64 on the host.
    ``pk_index`` holds the global partition vocab indices of the released
    rows (default ``arange(n)``); an unseeded engine takes a fresh stream
    from host entropy."""
    clipped = np.asarray(clipped, dtype=np.float64)
    n, d = clipped.shape
    if pk_index is None:
        pk_index = np.arange(n, dtype=np.uint32)
    if rng_seed is None:
        rng_seed = int(np.random.SeedSequence().entropy & 0x7FFFFFFF)
    if noise_params.noise_kind == NoiseKind.LAPLACE:
        scale = noise_ops.laplace_scale(
            noise_params.eps_per_coordinate,
            noise_ops.compute_l1_sensitivity(
                noise_params.l0_sensitivity,
                noise_params.linf_sensitivity))
    elif noise_params.noise_kind == NoiseKind.GAUSSIAN:
        scale = noise_ops.gaussian_sigma(
            noise_params.eps_per_coordinate,
            noise_params.delta_per_coordinate,
            noise_ops.compute_l2_sensitivity(
                noise_params.l0_sensitivity,
                noise_params.linf_sensitivity))
    else:
        raise ValueError("Noise kind must be either Laplace or Gaussian.")
    unit = unit_noise_block(noise_params.noise_kind, rng_seed, pk_index, d,
                            device)
    return clipped + unit.astype(np.float64) * float(scale)
