"""DP quantile tree: the host accumulator of the host path and the tree
shape of the fused percentile walk. A copy of
``pipelinedp_tpu/ops/quantile_tree.py`` (it replaces the C++
``QuantileTree`` of the reference's ``QuantileCombiner``,
``pipeline_dp/combiners.py:402-476``; C++ defaults height 4, branching
16, so 16^4 = 65536 leaves).

* **Host accumulator** (``QuantileTree``): a sparse ``{node_index:
  count}`` dict per level, like the C++ tree; merge is an add, and it
  serializes to bytes so it flows through any backend's shuffle.
* **Dense form**: ``to_dense()``/``from_dense()`` flatten the levels into
  one fixed-shape vector (level order), and ``tree_constants`` gives the
  fused walk's histogram shapes.

Algorithm: values are clipped to ``[lower, upper]`` and mapped to one of
``branching^height`` leaves; each value adds one to one node per level
along its root-to-leaf path. At quantile time every visited node count
gets noise calibrated with the per-level budget split ``eps/height``, and
ranks descend the tree: at each node, the child where the cumulative
noisy count crosses the target rank, then a linear interpolation inside
the final interval. The host tree draws its noise from the module-global
host RNG (``ops.noise._host_rng``), in the JAX package's order.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from pipelinedp_tpu_torch.aggregate_params import NoiseKind
from pipelinedp_tpu_torch.ops import noise as noise_ops

DEFAULT_TREE_HEIGHT = 4
DEFAULT_BRANCHING_FACTOR = 16


class QuantileTree:
    """Sparse host-side quantile-tree accumulator (the accumulator of
    ``combiners.QuantileCombiner`` on the host path)."""

    def __init__(self,
                 lower: float,
                 upper: float,
                 height: int = DEFAULT_TREE_HEIGHT,
                 branching_factor: int = DEFAULT_BRANCHING_FACTOR):
        if not lower < upper:
            raise ValueError("lower must be < upper")
        if height < 1 or branching_factor < 2:
            raise ValueError("need height >= 1 and branching_factor >= 2")
        self.lower = float(lower)
        self.upper = float(upper)
        self.height = height
        self.branching_factor = branching_factor
        # node counts per level: level l (0-based) has branching^(l+1) nodes.
        self._counts: List[Dict[int, float]] = [{} for _ in range(height)]

    # -- building --

    def add_entry(self, value: float) -> None:
        leaf = self._leaf_index(value)
        idx = leaf
        for level in reversed(range(self.height)):
            d = self._counts[level]
            d[idx] = d.get(idx, 0.0) + 1.0
            idx //= self.branching_factor

    def _leaf_index(self, value: float) -> int:
        n_leaves = self.branching_factor**self.height
        v = min(max(value, self.lower), self.upper)
        frac = (v - self.lower) / (self.upper - self.lower)
        return min(int(frac * n_leaves), n_leaves - 1)

    # -- merging / serialization --

    def merge(self, other: Union["QuantileTree", bytes]) -> None:
        if isinstance(other, bytes):
            other = QuantileTree.deserialize(other)
        if (other.height != self.height or
                other.branching_factor != self.branching_factor or
                other.lower != self.lower or other.upper != self.upper):
            raise ValueError("cannot merge trees with different shapes")
        for level in range(self.height):
            mine = self._counts[level]
            for idx, c in other._counts[level].items():
                mine[idx] = mine.get(idx, 0.0) + c

    def serialize(self) -> bytes:
        return pickle.dumps(
            (self.lower, self.upper, self.height, self.branching_factor,
             self._counts))

    @staticmethod
    def deserialize(data: bytes) -> "QuantileTree":
        lower, upper, height, branching, counts = pickle.loads(data)
        tree = QuantileTree(lower, upper, height, branching)
        tree._counts = counts
        return tree

    # -- dense form (level order) --

    def num_dense_nodes(self) -> int:
        b = self.branching_factor
        return sum(b**(l + 1) for l in range(self.height))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.num_dense_nodes(), dtype=np.float64)
        offset = 0
        for level in range(self.height):
            for idx, c in self._counts[level].items():
                out[offset + idx] = c
            offset += self.branching_factor**(level + 1)
        return out

    @staticmethod
    def from_dense(dense: np.ndarray, lower: float, upper: float,
                   height: int = DEFAULT_TREE_HEIGHT,
                   branching_factor: int = DEFAULT_BRANCHING_FACTOR
                   ) -> "QuantileTree":
        tree = QuantileTree(lower, upper, height, branching_factor)
        offset = 0
        for level in range(height):
            n = branching_factor**(level + 1)
            chunk = dense[offset:offset + n]
            nz = np.nonzero(chunk)[0]
            tree._counts[level] = {int(i): float(chunk[i]) for i in nz}
            offset += n
        return tree

    # -- DP quantiles --

    def compute_quantiles(self,
                          eps: float,
                          delta: float,
                          max_partitions_contributed: int,
                          max_contributions_per_partition: int,
                          quantiles: Sequence[float],
                          noise_kind: Union[NoiseKind, str] = NoiseKind.
                          LAPLACE,
                          rng: Optional[np.random.Generator] = None
                          ) -> List[float]:
        """DP estimates for ``quantiles`` (fractions in [0, 1]).

        Budget/sensitivity treatment mirrors the C++ tree: the budget is
        split evenly across the ``height`` levels; within one level a single
        privacy unit changes at most ``max_contributions_per_partition``
        node counts in each of ``max_partitions_contributed`` partitions.
        """
        if isinstance(noise_kind, str):
            noise_kind = NoiseKind(noise_kind)
        for q in quantiles:
            if not 0 <= q <= 1:
                raise ValueError(f"quantile {q} outside [0, 1]")
        # lint: disable=rng-purity(tree node noise from the seed_host_rng generator unless the caller passes one)
        rng = rng or noise_ops._host_rng
        eps_per_level = eps / self.height
        l0 = max_partitions_contributed
        linf = max_contributions_per_partition
        if noise_kind == NoiseKind.LAPLACE:
            scale = noise_ops.laplace_scale(
                eps_per_level, noise_ops.compute_l1_sensitivity(l0, linf))
            noise_fn = lambda: rng.laplace(0.0, scale)
        else:
            delta_per_level = delta / self.height
            sigma = noise_ops.gaussian_sigma(
                eps_per_level, delta_per_level,
                noise_ops.compute_l2_sensitivity(l0, linf))
            noise_fn = lambda: rng.normal(0.0, sigma)

        b = self.branching_factor
        # THE MEMOIZATION CONTRACT: each (level, node) is noised at most
        # once, and every quantile walk that revisits it sees the SAME
        # noisy count. This is what bounds the per-level sensitivity at
        # linf node counts per partition (the calibration above) no
        # matter how many quantiles are requested. The fused device walk
        # honors the same contract statelessly: node noise there is a
        # pure counter-based function of (partition, node id)
        # (``ops/counter_rng.py``), so revisits reproduce the draw with
        # no cache.
        noisy_cache: Dict[tuple, float] = {}

        def noisy_count(level: int, idx: int) -> float:
            key = (level, idx)
            if key not in noisy_cache:
                raw = self._counts[level].get(idx, 0.0)
                noisy_cache[key] = max(raw + noise_fn(), 0.0)
            return noisy_cache[key]

        results = []
        for q in quantiles:
            lo, hi = self.lower, self.upper
            idx = 0  # index of the first child at current level
            target = q
            for level in range(self.height):
                children = [noisy_count(level, idx * b + i)
                            for i in range(b)]
                total = sum(children)
                if total <= 0:
                    # No noisy signal below this node: stop descending and
                    # interpolate the residual quantile fraction over the
                    # current interval.
                    break
                rank = target * total
                cum = 0.0
                child = b - 1
                for i, c in enumerate(children):
                    if cum + c >= rank:
                        child = i
                        break
                    cum += c
                width = (hi - lo) / b
                lo = lo + child * width
                hi = lo + width
                c = children[child]
                target = 0.0 if c <= 0 else min(
                    max((rank - cum) / c, 0.0), 1.0)
                idx = idx * b + child
            results.append(lo + (hi - lo) * target)
        # Quantile estimates should be monotone in q; enforce like the C++
        # post-processing step.
        order = np.argsort(quantiles, kind="stable")
        vals = np.asarray(results)
        vals[order] = np.maximum.accumulate(vals[order])
        return [float(v) for v in vals]


# ---------------------------------------------------------------------------
# Dense helpers: the fused path's tree shape
# ---------------------------------------------------------------------------


def tree_constants(height: int = DEFAULT_TREE_HEIGHT,
                   branching_factor: int = DEFAULT_BRANCHING_FACTOR
                   ) -> tuple:
    """``(b, height, n_mid, subtree_span)`` — the one derivation of the
    fused walk's histogram shapes from the tree shape. ``n_mid = b^2``
    is the mid-level histogram width (bucket width ``b^(height-2)``
    serves every level whose node width is at least that), and
    ``subtree_span = b^(height-2)`` is the leaf count of one chosen
    subtree at the first bottom level — the trailing dimension of every
    pass-B ``[P, Q, span]`` block the sweep planner budgets against."""
    b = branching_factor
    return b, height, b * b, b**(height - 2)


def dense_level_slices(height: int = DEFAULT_TREE_HEIGHT,
                       branching_factor: int = DEFAULT_BRANCHING_FACTOR
                       ) -> List[tuple]:
    """[(offset, size)] of each level inside the dense layout."""
    slices = []
    offset = 0
    for level in range(height):
        n = branching_factor**(level + 1)
        slices.append((offset, n))
        offset += n
    return slices


def values_to_dense_paths(values: np.ndarray, lower: float, upper: float,
                          height: int = DEFAULT_TREE_HEIGHT,
                          branching_factor: int = DEFAULT_BRANCHING_FACTOR
                          ) -> np.ndarray:
    """Maps each value to the ``height`` dense node indices it increments —
    the scatter-add targets of the batched tree build."""
    n_leaves = branching_factor**height
    v = np.clip(values, lower, upper)
    frac = (v - lower) / (upper - lower)
    leaves = np.minimum((frac * n_leaves).astype(np.int64), n_leaves - 1)
    out = np.empty((values.shape[0], height), dtype=np.int64)
    slices = dense_level_slices(height, branching_factor)
    idx = leaves
    for level in reversed(range(height)):
        out[:, level] = slices[level][0] + idx
        idx = idx // branching_factor
    return out
