"""Arithmetic the metric readers of ``benchmark/metrics/`` share. A
reader that finds nothing to read returns None, and the harness leaves
its metric out of the line."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark.roofline import bound_s


def units_per_s(run) -> Optional[float]:
    """All the work units of the window's completed calls over the whole
    window: from its start to the last completion."""
    done = sum(c.units for c in run.calls if not c.failed)
    return done / run.window_s if done else None


def mean_timing_ms(run, key: str) -> Optional[float]:
    """The mean over the window's calls of the program's ``timings[key]``
    (seconds), in milliseconds."""
    vals = [c.timings[key] for c in run.calls
            if c.timings is not None and key in c.timings]
    return 1e3 * sum(vals) / len(vals) if vals else None


def host_other_ms(run) -> Optional[float]:
    """The mean host time of a call outside the program's encode and
    device spans: the benchmark's own span around the call less both."""
    vals = [(c.t1 - c.t0) - c.timings["host_encode_s"] -
            c.timings["device_s"] for c in run.calls
            if c.timings is not None]
    return 1e3 * sum(vals) / len(vals) if vals else None


def idle_share_pct(run) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device."""
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(run, key: str, kernel_names: Sequence[str]
                 ) -> Optional[float]:
    """The summed least time of ``key``'s launches in the window over
    the summed device time of its kernels in the trace."""
    if run.trace is None or run.kernels is None:
        return None
    device_s = run.trace.kernel_time(kernel_names)
    least_s, launches = run.kernels.bound_s(key, bound_s)
    if device_s <= 0 or launches == 0:
        return None
    return 100.0 * least_s / device_s
