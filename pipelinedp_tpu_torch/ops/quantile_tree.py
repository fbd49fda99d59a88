"""The quantile tree's shape, for the fused percentile walk.

Port of the constants of ``pipelinedp_tpu/ops/quantile_tree.py`` that the
fused walk reads: a tree of height 4 and branching factor 16 (the C++
``QuantileTree`` defaults), so 16^4 = 65536 leaves. The host
``QuantileTree`` accumulator is not on the fused path and is not ported
(ROADMAP step 2).
"""

from __future__ import annotations

DEFAULT_TREE_HEIGHT = 4
DEFAULT_BRANCHING_FACTOR = 16


def tree_constants(height: int = DEFAULT_TREE_HEIGHT,
                   branching_factor: int = DEFAULT_BRANCHING_FACTOR
                   ) -> tuple:
    """``(b, height, n_mid, subtree_span)``: ``n_mid = b^2`` is the width
    of the mid-level histogram (bucket width ``b^(height-2)``, which
    serves the top two levels), and ``subtree_span = b^(height-2)`` the
    leaf count of one chosen subtree at the first bottom level — the
    trailing dimension of every ``[P, Q, span]`` subtree histogram."""
    b = branching_factor
    return b, height, b * b, b**(height - 2)
