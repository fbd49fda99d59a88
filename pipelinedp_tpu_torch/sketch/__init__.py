"""Sketch-first ingest + DP heavy hitters: the unbounded-key path.

A port of ``pipelinedp_tpu/sketch``. When the partition axis is URLs,
queries or other user-generated strings, the key space is **discovered**
through a two-phase path instead of being encoded up front:

* phase 1 — a device-resident ``[depth, width]`` counting sketch over
  seeded stable hashes of the keys (a one-hot-matmul or scatter binner,
  fed in chunks through the ingest ring; per-user contribution bounded
  BEFORE accumulation), then DP candidate selection over the bucket
  masses (Laplace noise via the counter-based generator, budget drawn
  through ``budget_accounting``);
* phase 2 — the exact dense fused path over ONLY the selected
  candidates, via a host-side key→candidate-id table; private
  partition selection and noise run exactly as a dense run.

Entry point: ``DPEngine.aggregate(col, params, extractors,
sketch_first=SketchParams(eps=..., delta=...))`` on a ``TorchBackend``.

This ``__init__`` stays light (hashing and params only, numpy) so the
stable hash is importable without pulling in the engine.
"""

from pipelinedp_tpu_torch.sketch import hashing
from pipelinedp_tpu_torch.sketch.hashing import (DEFAULT_SEED, bucket_ids,
                                                 stable_hash64,
                                                 stable_hash_any)
from pipelinedp_tpu_torch.sketch.params import SketchParams

__all__ = [
    "DEFAULT_SEED",
    "SketchParams",
    "bucket_ids",
    "hashing",
    "stable_hash64",
    "stable_hash_any",
]
