"""Privacy/utility audit registry — the run report's ``privacy`` section.

The reference exposes per-run privacy facts through
``explain_computations_report`` (human text) and the utility-analysis
engine (expected errors); here the same facts become a **structured,
machine-readable audit record** that outlives the process via the run
ledger store:

* ``record_accountant`` — every ``BudgetAccountant.compute_budgets()``
  pushes its finalized audit record: per-mechanism metric label,
  mechanism type, granted (eps, delta) split, and noise standard
  deviation (PLD-granted or derived from the standard calibration).
* ``record_aggregation`` — ``DPEngine.aggregate``/``select_partitions``
  push the aggregation's shape: metrics, noise kind, contribution
  bounds, and the partition-selection strategy.
* ``record_metric_error`` — the fused release seam pushes per-metric
  expected relative error (calibrated noise stddev vs the mean released
  aggregate magnitude — the audit twin of the utility-analysis engine's
  ``error_expected``).
* ``build_privacy_section`` — assembles the ``privacy`` section of the
  schema-v2 run report from the registry plus the selection-seam
  counters (``selection.partitions_pre`` / ``selection.partitions_post``
  emitted by ``streaming.py``/``torch_engine.py``).

Capture is ON by default (it is host-side dict appends, rare and cheap,
like the counters/events tier) and can be disabled with
``PIPELINEDP_TPU_AUDIT=0``. Auditing on vs off changes ONLY the record:
DP outputs are bit-identical either way (parity-tested like the trace
flag). This module is stdlib-only at import time — producers push plain
dicts; no engine/jax imports ever flow through here.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, List, Optional

ENV_VAR = "PIPELINEDP_TPU_AUDIT"

#: Registry caps, mirroring the ledger's span/event caps: a pathological
#: run (thousands of engines in one process) must not OOM the host
#: through its own audit trail. Drops are counted and surfaced.
MAX_RECORDS = 10_000

_lock = threading.Lock()
_accountants: List[Dict[str, Any]] = []
_aggregations: List[Dict[str, Any]] = []
_metric_errors: List[Dict[str, Any]] = []
_sketches: List[Dict[str, Any]] = []
_dropped = 0


def audit_enabled() -> bool:
    """True unless ``PIPELINEDP_TPU_AUDIT`` opts out (0/false/off).
    Default-on: the audit record is the counters tier, not the span
    tier — rare, load-bearing, and cheap to capture."""
    return os.environ.get(ENV_VAR, "").lower() not in ("0", "false", "off")


def reset() -> None:
    """Start a fresh audit registry (tests; run boundaries — called by
    ``obs.reset()``)."""
    global _dropped
    with _lock:
        _accountants.clear()
        _aggregations.clear()
        _metric_errors.clear()
        _sketches.clear()
        _dropped = 0


#: Per-thread "whose books is this" tag: the resident service wraps
#: each request's compute in :func:`books_context`, and every record a
#: producer (accountant finalize, engine aggregation audit, release-
#: seam error estimate) appends on that thread is stamped with the
#: (tenant, request_id) pair — so a multi-tenant process's interleaved
#: audit trail still attributes each record to one request. Thread-
#: local, not a contextvar: the serve worker model is one request per
#: worker thread end-to-end.
_books = threading.local()


@contextlib.contextmanager
def books_context(tenant: str, request_id: str):
    """Stamp every audit record appended by THIS thread inside the
    block with ``{"tenant", "request_id"}`` (nests; inner wins)."""
    prev = getattr(_books, "value", None)
    _books.value = {"tenant": str(tenant), "request_id": str(request_id)}
    try:
        yield
    finally:
        _books.value = prev


def current_books() -> Optional[Dict[str, str]]:
    """The calling thread's active (tenant, request_id) stamp, if any."""
    value = getattr(_books, "value", None)
    return dict(value) if value else None


def _append(bucket: List[Dict[str, Any]], record: Dict[str, Any]) -> None:
    global _dropped
    stamped = dict(record)
    books = current_books()
    if books is not None:
        stamped.setdefault("books", books)
    with _lock:
        if len(bucket) < MAX_RECORDS:
            bucket.append(stamped)
        else:
            _dropped += 1


def record_accountant(record: Dict[str, Any]) -> None:
    """A finalized ``BudgetAccountant.audit_record()`` dict."""
    _append(_accountants, record)


def record_aggregation(record: Dict[str, Any]) -> None:
    """One DPEngine aggregation's structured shape (metrics, bounds,
    selection strategy, noise kind)."""
    _append(_aggregations, record)


def record_metric_error(record: Dict[str, Any]) -> None:
    """One released metric's expected-error estimate: ``{"metric",
    "noise_stddev", "aggregate_scale", "expected_relative_error"}``."""
    _append(_metric_errors, record)


def record_sketch(record: Dict[str, Any]) -> None:
    """One sketch-first phase-1 run's shape and outcome: width/depth/
    cap/backend, the selection budget and threshold, bucket pre/post
    counts and candidate counts (``sketch/engine.py`` pushes it; the
    run report's schema-v5 ``sketch`` section reads it). Counts are
    data-dependent diagnostics, same tier as the selection pre/post
    counters — the record never carries key material."""
    _append(_sketches, record)


def cursor() -> Dict[str, int]:
    """Current registry lengths — pass back as ``since`` to
    :func:`build_privacy_section` for a delta view (the per-request
    ledger appends use this so entry k never duplicates entries
    1..k-1)."""
    with _lock:
        return {"accountants": len(_accountants),
                "aggregations": len(_aggregations),
                "expected_errors": len(_metric_errors),
                "sketches": len(_sketches)}


def build_sketch_section(since: Optional[Dict[str, int]] = None
                         ) -> List[Dict[str, Any]]:
    """The run report's ``sketch`` section body: every sketch-first
    phase-1 record since ``since`` (a :func:`cursor` value), oldest
    first. Empty list when no sketch ran — the report then omits the
    section (the v1–v4-compatible reading)."""
    since = since or {}
    with _lock:
        start = min(int(since.get("sketches", 0)), len(_sketches))
        return [dict(r) for r in _sketches[start:]]


def build_privacy_section(
        counters: Optional[Dict[str, int]] = None,
        since: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """The run report's ``privacy`` section (schema v2): everything the
    registry accumulated since the last reset, plus the selection-seam
    pre/post partition counters. ``since`` (a :func:`cursor` value)
    restricts the record lists to entries appended after that point —
    the delta view behind per-request ledger appends. Safe to call with
    capture disabled — the section then records only that it was off."""
    counters = counters or {}
    since = since or {}

    def _tail(bucket: List[Dict[str, Any]], key: str) -> List[Dict[str, Any]]:
        start = min(int(since.get(key, 0)), len(bucket))
        return [dict(r) for r in bucket[start:]]

    with _lock:
        accountants = _tail(_accountants, "accountants")
        aggregations = _tail(_aggregations, "aggregations")
        metric_errors = _tail(_metric_errors, "expected_errors")
        dropped = _dropped
    strategies = sorted({
        str(a.get("partition_selection"))
        for a in aggregations if a.get("partition_selection")
    })
    return {
        "enabled": audit_enabled(),
        "accountants": accountants,
        "aggregations": aggregations,
        "expected_errors": metric_errors,
        "partition_selection": {
            "strategies": strategies,
            "partitions_pre": int(
                counters.get("selection.partitions_pre", 0)),
            "partitions_post": int(
                counters.get("selection.partitions_post", 0)),
        },
        "dropped_records": dropped,
    }
