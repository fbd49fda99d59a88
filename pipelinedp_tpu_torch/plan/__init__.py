"""Self-tuning execution planner: the measure→decide loop, closed.

The obs stack measures (spans, device costs, the durable run ledger);
this package decides: the knob forest that used to be hand-set per
device — ``_SUBHIST_BYTE_CAP``, pass-B tile packing, stream cache
bytes, ``q_chunk``, the ingest-executor switch — resolves through one
registry, optionally steered by a ledger-fit cost model persisted as
a plan file.

* :mod:`~pipelinedp_tpu_torch.plan.knobs` — the registry: every tunable's
  unit, hardcoded default, env override, module seam and dp-safety,
  plus the ONE resolution precedence (env > seam > plan > default).
* :mod:`~pipelinedp_tpu_torch.plan.model` — a stdlib-only cost model fit
  from accumulated ledger entries: per (device kind, phase,
  shape-signature bucket), predicted device seconds and HBM peak from
  (rows, partitions, quantiles), falling back to the static roofline
  peak table; empty/degraded/foreign-fingerprint history predicts
  nothing and leaves the defaults in force.
* :mod:`~pipelinedp_tpu_torch.plan.planner` — the plan file (atomic JSON
  under ``PIPELINEDP_TPU_PLAN_DIR``, keyed by the stable env-fingerprint
  hash; stale fingerprints ignored with a ``plan.stale`` event) and
  per-request :func:`resolve` (one ``plan.applied`` event per knob,
  the run report's schema-v4 ``plan`` section).

A tuning run measures :func:`autotune_candidates` and writes the plan
(:func:`build_plan`, :func:`write_plan`); a subsequent plain run loads it. Planner on vs off is DP-bit-identical
(PARITY row 32): plans only select among parity-tested paths.
"""

from __future__ import annotations

from pipelinedp_tpu_torch.plan import knobs, model, planner
from pipelinedp_tpu_torch.plan.knobs import (KnobSpec, REGISTRY, defaults,
                                             resolve_all, seam_override)
from pipelinedp_tpu_torch.plan.knobs import value as knob_value
from pipelinedp_tpu_torch.plan.model import CostModel, bucket_key, fit
from pipelinedp_tpu_torch.plan.planner import (Resolved, autotune_candidates,
                                               build_plan, load_plan,
                                               note_observed, plan_dir,
                                               plan_hash, plan_path, reset,
                                               resolve, set_default_dir,
                                               snapshot, source_summary,
                                               write_plan)

__all__ = [
    "knobs", "model", "planner",
    "KnobSpec", "REGISTRY", "defaults", "resolve_all", "seam_override",
    "knob_value",
    "CostModel", "bucket_key", "fit",
    "Resolved", "autotune_candidates", "build_plan", "load_plan",
    "note_observed", "plan_dir", "plan_hash", "plan_path", "reset",
    "resolve", "set_default_dir", "snapshot", "source_summary",
    "write_plan",
]
