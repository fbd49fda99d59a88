"""Typed metrics registry + Prometheus text exposition.

The :class:`~pipelinedp_tpu_torch.obs.tracer.RunLedger` already holds the
process's counters; what a resident multi-tenant service additionally
needs is (a) **latency distributions** without unbounded sample
retention, and (b) **labeled gauges** (per-tenant budget remaining,
serve occupancy) — neither of which a monotonically-growing counter
map can express. This module layers exactly those two primitives on
top of the ledger and renders all three as Prometheus text exposition
(format 0.0.4) for ``obs/http.py``'s ``/metrics``:

* :class:`Histogram` — FIXED buckets chosen at creation; an observe
  is one bisect + three integer adds, and p50/p99 come from bucket
  interpolation, so memory is O(buckets) forever (the
  no-unbounded-sample-retention rule);
* :class:`Gauge` — last-write-wins values keyed by a label set
  (``tenant="acme"``), the shape per-tenant ε/δ remaining needs;
* counters are NOT duplicated here — the exposition reads them
  straight from the run ledger, so ``obs.inc`` call sites stay the
  single source of truth.

Naming scheme: every exposed metric is prefixed ``pdp_``, dots and
hyphens become underscores, ledger counters gain the Prometheus
``_total`` suffix (``serve.requests_served`` →
``pdp_serve_requests_served_total``). Histogram seconds use base-unit
``_seconds`` names per Prometheus convention.

Recording is always-on and cheap (like counters/events); rendering
happens only when something asks (the endpoint, a test). ``reset()``
forgets everything — ``obs.reset()`` calls it at run boundaries.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: Default latency buckets (seconds): sub-millisecond through one
#: minute, roughly log-spaced — wide enough for a warm fused request
#: (~ms) and a cold first-compile request (~10s) on one scale.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def prometheus_name(name: str, suffix: str = "") -> str:
    """``serve.request_seconds`` → ``pdp_serve_request_seconds``."""
    base = _NAME_SANITIZE.sub("_", str(name))
    if not base.startswith("pdp_"):
        base = "pdp_" + base
    return base + suffix


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    """Float formatting for exposition lines: integral values print
    without a trailing ``.0`` (matches common client_golang output)."""
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Histogram:
    """Fixed-bucket histogram: cumulative-on-render bucket counts, sum
    and count; p50/p99 by linear interpolation inside the bucket the
    rank lands in (the overflow bucket reports its lower edge — an
    honest floor, never an invented tail)."""

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram '{name}' buckets must be "
                             f"strictly increasing, got {bounds}")
        if not bounds:
            raise ValueError(f"histogram '{name}' needs >= 1 bucket")
        self.name = str(name)
        self.help = str(help)
        self.bounds = bounds
        self._lock = threading.Lock()
        #: Per-bucket (non-cumulative) counts; last slot is +Inf.
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        # Prometheus ``le`` is an INCLUSIVE upper bound: a value equal
        # to a boundary counts in that boundary's bucket (bisect_left
        # finds the first bound >= v — the boundary-exactness contract
        # tests/test_torch_metrics.py pins).
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def _quantile_locked(self, q: float) -> float:
        if self._count == 0:
            return 0.0
        rank = q * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            prev = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i]
                frac = (rank - prev) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.bounds[-1]

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 < q < 1) from the bucket counts."""
        with self._lock:
            return self._quantile_locked(float(q))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            cum: List[Tuple[float, int]] = []
            running = 0
            for bound, c in zip(self.bounds, self._counts):
                running += c
                cum.append((bound, running))
            return {"buckets": cum, "sum": self._sum,
                    "count": self._count,
                    "p50": self._quantile_locked(0.50),
                    "p99": self._quantile_locked(0.99)}


class Gauge:
    """Labeled last-write-wins values (one value per label set; the
    empty label set is just another key)."""

    def __init__(self, name: str, help: str = ""):
        self.name = str(name)
        self.help = str(help)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    @staticmethod
    def _key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, delta: float = 1.0, **labels) -> None:
        with self._lock:
            key = self._key(labels)
            self._values[key] = self._values.get(key, 0.0) + float(delta)

    def get(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(self._key(labels))

    def remove(self, **labels) -> None:
        with self._lock:
            self._values.pop(self._key(labels), None)

    def snapshot(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            return [(dict(k), v)
                    for k, v in sorted(self._values.items())]


class MetricsRegistry:
    """Get-or-create registry over histograms and gauges. Creation is
    idempotent by name (the first creation's help/buckets win — call
    sites re-declare freely)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._histograms: Dict[str, Histogram] = {}
        self._gauges: Dict[str, Gauge] = {}

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = Histogram(name, help,
                              buckets or DEFAULT_LATENCY_BUCKETS)
                self._histograms[name] = h
            return h

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = Gauge(name, help)
                self._gauges[name] = g
            return g

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            hists = dict(self._histograms)
            gauges = dict(self._gauges)
        return {"histograms": {n: h.snapshot()
                               for n, h in sorted(hists.items())},
                "gauges": {n: g.snapshot()
                           for n, g in sorted(gauges.items())}}

    def reset(self) -> None:
        with self._lock:
            self._histograms.clear()
            self._gauges.clear()


#: The one process-global registry (``obs.reset()`` clears it).
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def reset() -> None:
    _REGISTRY.reset()


def observe(name: str, value: float, help: str = "",
            buckets: Optional[Sequence[float]] = None) -> None:
    """Convenience: one observation into the global registry."""
    _REGISTRY.histogram(name, help, buckets).observe(value)


def set_gauge(name: str, value: float, help: str = "", **labels) -> None:
    """Convenience: one gauge write into the global registry."""
    _REGISTRY.gauge(name, help).set(value, **labels)


def render_prometheus(counters: Optional[Dict[str, int]] = None) -> str:
    """The full ``/metrics`` exposition: run-ledger counters (the
    single source of truth for counts), then this registry's gauges
    and histograms. Pass ``counters`` to pin a snapshot; by default
    the ledger's live counter map is read (without copying spans)."""
    if counters is None:
        from pipelinedp_tpu_torch import obs
        counters, _ = obs.ledger().tail_snapshot(0)
    lines: List[str] = []
    for name in sorted(counters):
        pname = prometheus_name(name, "_total")
        lines.append(f"# HELP {pname} run-ledger counter {name}")
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {_fmt(counters[name])}")
    snap = _REGISTRY.snapshot()
    for name, rows in snap["gauges"].items():
        pname = prometheus_name(name)
        g = _REGISTRY.gauge(name)
        lines.append(f"# HELP {pname} {g.help or name}")
        lines.append(f"# TYPE {pname} gauge")
        if not rows:
            continue
        for labels, value in rows:
            if labels:
                inner = ",".join(f'{k}="{_escape_label(v)}"'
                                 for k, v in sorted(labels.items()))
                lines.append(f"{pname}{{{inner}}} {_fmt(value)}")
            else:
                lines.append(f"{pname} {_fmt(value)}")
    for name, h in snap["histograms"].items():
        pname = prometheus_name(name)
        hh = _REGISTRY.histogram(name)
        lines.append(f"# HELP {pname} {hh.help or name}")
        lines.append(f"# TYPE {pname} histogram")
        for bound, cum in h["buckets"]:
            lines.append(f'{pname}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{pname}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{pname}_sum {_fmt(h['sum'])}")
        lines.append(f"{pname}_count {h['count']}")
    return "\n".join(lines) + "\n"
