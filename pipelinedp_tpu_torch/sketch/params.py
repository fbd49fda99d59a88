"""``SketchParams`` — the sketch-first entry point's DP knob set.

A port of ``pipelinedp_tpu/sketch/params.py``, with the same fields,
validation and defaults. The fields split into two tiers:

* **DP parameters** — ``eps``/``delta`` (the phase-1 candidate
  selection's own budget, drawn through a dedicated
  ``NaiveBudgetAccountant``), ``width``/``depth``/``candidate_cap``/
  ``max_buckets_contributed`` (they change which buckets are selected
  and therefore which keys the exact pass can release).
* **Execution choices** — ``backend`` (the one-hot-matmul binner or the
  scatter twin, bit-identical by construction) and ``chunk_rows`` (device
  batch sizing of the bounded-pair stream; the sketch is a sum, so
  chunking is associativity-exact).

Fields left ``None`` resolve through the knob registry
(``plan/knobs.py``): the explicit parameter first, then the environment
(``PIPELINEDP_TPU_SKETCH_WIDTH``, ``_DEPTH``, ``_CANDIDATE_CAP``,
``_BACKEND``) or a plan file (``sketch_backend`` only: the other three are
not dp-safe), then the registry's defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from pipelinedp_tpu_torch.sketch import hashing

#: The matmul binner factors buckets into (hi, lo) radix digits with a
#: 256-wide low digit; widths round up to this multiple on device.
WIDTH_MULTIPLE = 256

_BACKENDS = ("matmul", "xla")

@dataclasses.dataclass(frozen=True)
class SketchParams:
    """Parameters of the two-phase sketch-first DP heavy-hitters path
    (``DPEngine.aggregate(..., sketch_first=SketchParams(...))``).

    ``eps``/``delta`` fund phase 1 only (bucket-level candidate
    selection); the engine's own accountant funds phase 2 exactly as a
    dense run — total privacy cost is the sum of the two.
    """

    #: Phase-1 selection epsilon: the per-bucket noisy mass vector is
    #: released at Laplace scale ``max_buckets_contributed / eps``
    #: (L1 sensitivity of the bounded per-user contributions), so the
    #: selected-bucket set is ``eps``-DP before any thresholding.
    eps: float
    #: Funds the suppression threshold's tail calibration (the same
    #: Laplace-thresholding formula as dense partition selection).
    #: With the bucket axis public the threshold is post-processing of
    #: the eps-DP noisy vector — delta tightens utility, it is not
    #: load-bearing for privacy. May be 0 (threshold falls back to 1).
    delta: float
    #: Hash buckets per sketch row (row 0 is the selection axis).
    #: None → the ``sketch_width`` knob. Rounded up to a multiple of
    #: 256 on device (the matmul binner's radix width).
    width: Optional[int] = None
    #: Sketch rows (independent hash remixes). Row 0 selects; rows 1+
    #: refine the count-min mass estimate. None → the ``sketch_depth``
    #: knob.
    depth: Optional[int] = None
    #: Max SELECTED buckets (DP top-K over noisy mass — the cap lives
    #: inside the DP mechanism, so a neighbor dataset can never slide
    #: un-selected keys into the candidate set). None → the
    #: ``sketch_candidate_cap`` knob.
    candidate_cap: Optional[int] = None
    #: Per-user bound on distinct keys entering the sketch (the L0 of
    #: phase 1, bounded BEFORE accumulation by a deterministic seeded
    #: per-user sample). None → the aggregation's
    #: ``max_partitions_contributed`` (or ``max_contributions``).
    max_buckets_contributed: Optional[int] = None
    #: Explicit suppression threshold on noisy bucket mass (post-
    #: processing). None → the Laplace-thresholding formula at
    #: (eps, delta, L0); with delta == 0, 1.0.
    threshold: Optional[float] = None
    #: Seed of the stable key hash (NOT the noise seed — noise keys
    #: derive from the backend ``rng_seed``).
    hash_seed: int = hashing.DEFAULT_SEED
    #: "matmul" (one-hot radix binner) or "xla" (scatter twin).
    #: Bit-identical; None → the ``sketch_backend`` knob.
    backend: Optional[str] = None
    #: Bounded (user, key) pairs per device batch of the sketch
    #: accumulation stream. Exact for any value (integer sum).
    chunk_rows: int = 1 << 20

    def __post_init__(self):
        if not self.eps > 0:
            raise ValueError("SketchParams.eps must be positive")
        if not 0 <= self.delta < 1:
            raise ValueError("SketchParams.delta must be in [0, 1)")
        for name in ("width", "depth", "candidate_cap",
                     "max_buckets_contributed"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v <= 0):
                raise ValueError(f"SketchParams.{name} must be a "
                                 f"positive int (got {v!r})")
        if self.backend is not None and self.backend not in _BACKENDS:
            raise ValueError("SketchParams.backend must be 'matmul' or "
                             f"'xla' (got {self.backend!r})")
        if self.chunk_rows <= 0:
            raise ValueError("SketchParams.chunk_rows must be positive")

    # --- knob resolution (explicit param > environment > default) ---

    def _knob(self, explicit, knob_name: str):
        if explicit is not None:
            return explicit
        from pipelinedp_tpu_torch import plan as plan_mod
        return plan_mod.knob_value(knob_name)

    def resolved_width(self) -> int:
        w = int(self._knob(self.width, "sketch_width"))
        return -(-w // WIDTH_MULTIPLE) * WIDTH_MULTIPLE

    def resolved_depth(self) -> int:
        return int(self._knob(self.depth, "sketch_depth"))

    def resolved_candidate_cap(self) -> int:
        return int(self._knob(self.candidate_cap, "sketch_candidate_cap"))

    def resolved_backend(self) -> str:
        return str(self._knob(self.backend, "sketch_backend"))

    def resolved_l0(self, agg_params) -> int:
        if self.max_buckets_contributed is not None:
            return self.max_buckets_contributed
        l0 = (getattr(agg_params, "max_partitions_contributed", None)
              or getattr(agg_params, "max_contributions", None))
        if not l0:
            raise ValueError(
                "sketch-first needs a cross-partition bound: set "
                "SketchParams.max_buckets_contributed or the "
                "aggregation's max_partitions_contributed")
        return int(l0)
