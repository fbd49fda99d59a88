"""The program's own spans in a traced run.

While ``torch.profiler`` records, every span of the port opens a
``record_function`` range ``pdp.<span name>`` on the profiler's clock.
This module reads them from the same raw events ``trace.read_profile``
reads:

- each device operation of the window is joined to the CUDA runtime call
  that launched it (the device operation's ``correlation_id``, else its
  ``linked_correlation_id``, against the runtime call's
  ``correlation_id``), and takes the ``pdp.*`` ranges open on the host at
  that launch;
- each idle gap of the device is named by the innermost ``pdp.*`` range
  open at its midpoint, ``OUTSIDE`` when none is.

``install()`` wraps ``trace.read_profile`` once per process, so that the
``Trace`` it returns carries a ``ProgramTrace`` as ``trace.program``, and
the wrapped reader sees no device-side copy of a ``pdp.*`` range: the
program's ranges are never device work, and ``busy_s``, ``kernel_s``,
``idle_by_span`` and the breakdown read as they would without them. The
metric readers that read the program's spans call it when imported. A
program that opens no ``pdp.*`` range leaves ``trace.program`` None, and
those readers return None."""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import time
import traceback
import types
from typing import (Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Tuple)

from benchmark.core import trace as trace_mod

PREFIX = "pdp."
OUTSIDE = "outside"
# The host's CUDA API calls (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
# ``cuLaunchKernel``): the profiler's events carry no activity type in
# every torch release, so they are known by name.
LAUNCH = re.compile(r"cu(da)?[A-Z]")


class Op(NamedTuple):
    """A device operation clipped to the window (microseconds), and the
    names of the ``pdp.*`` ranges open when it was launched, outermost
    first (None when no launch was found for it)."""
    start: float
    end: float
    name: str
    stack: Optional[Tuple[str, ...]]


def _union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(intervals: Sequence[Sequence[float]]) -> float:
    return sum(b - a for a, b in intervals)


def _stacks(points: List[float], ranges: List[Tuple[float, float, str]]
            ) -> List[Tuple[str, ...]]:
    """For each sorted time point, the names of the ranges open then,
    outermost first (the earlier start, then the later end). A range is
    open on ``[start, end)``."""
    edges = sorted([(a, 1, i) for i, (a, _, _) in enumerate(ranges)] +
                   [(b, 0, i) for i, (_, b, _) in enumerate(ranges)])
    open_: Dict[int, None] = {}
    stack: Tuple[str, ...] = ()
    out, j = [], 0
    for t in points:
        changed = False
        while j < len(edges) and edges[j][0] <= t:
            _, is_start, i = edges[j]
            if is_start:
                open_[i] = None
            else:
                open_.pop(i, None)
            changed = True
            j += 1
        if changed:
            stack = tuple(ranges[i][2] for i in sorted(
                open_, key=lambda i: (ranges[i][0], -ranges[i][1], i)))
        out.append(stack)
    return out


@dataclasses.dataclass
class ProgramTrace:
    """The program's ranges and the window's device operations, in
    microseconds on the profiler's clock."""
    window: Tuple[float, float]
    ranges: List[Tuple[float, float, str]]
    ops: List[Op]
    joins: Dict[str, int]

    def __post_init__(self):
        self.busy = _union((o.start, o.end) for o in self.ops)
        w0, w1 = self.window
        self.gaps, t = [], w0
        for a, b in self.busy:
            if a > t:
                self.gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            self.gaps.append((t, w1))
        self._gap_stacks = _stacks([(a + b) / 2 for a, b in self.gaps],
                                   self.ranges)

    def has(self, name: str) -> bool:
        return any(n == name for _, _, n in self.ranges)

    def host_s(self, names: Sequence[str]) -> float:
        """Summed host seconds of the ranges named ``names``, clipped to
        the window."""
        w0, w1 = self.window
        return 1e-6 * sum(max(0.0, min(b, w1) - max(a, w0))
                          for a, b, n in self.ranges if n in names)

    def launched_in(self, name: str) -> List[Op]:
        """The device operations launched while a range ``name`` was open
        (at any depth)."""
        return [o for o in self.ops if o.stack and name in o.stack]

    def device_s(self, name: str) -> float:
        """Seconds of the union of the device intervals of the operations
        launched inside ``name``."""
        return 1e-6 * _length(_union((o.start, o.end)
                                     for o in self.launched_in(name)))

    def copy_s(self, name: str, direction: str = "HtoD") -> float:
        """Summed device seconds of the copies in ``direction`` launched
        inside ``name``."""
        return 1e-6 * sum(o.end - o.start for o in self.launched_in(name)
                          if "Memcpy" in o.name and direction in o.name)

    def idle_s(self, name: str) -> float:
        """Seconds of the device's idle gaps whose midpoint lies inside a
        range ``name`` (at any depth): the gaps ``trace.read_profile``
        names by its own spans, named by the program's."""
        return 1e-6 * sum(b - a for (a, b), stack in
                          zip(self.gaps, self._gap_stacks) if name in stack)

    def attributed_share(self) -> Optional[float]:
        """The share of busy time covered by operations launched inside
        some ``pdp.*`` range."""
        busy = _length(self.busy)
        if busy <= 0:
            return None
        inside = _union((o.start, o.end) for o in self.ops if o.stack)
        return _length(inside) / busy

    def by_span(self) -> Dict[str, Dict[str, float]]:
        """Per range name: its host seconds in the window (``host_s``,
        children included), and, by innermost range, the device seconds
        of the operations it launched (their union) and the idle seconds
        of the gaps whose midpoint it holds; ``OUTSIDE`` holds what no
        range does, ``"unmatched"`` the operations with no launch
        found."""
        out: Dict[str, Dict[str, float]] = {}

        def entry(key):
            return out.setdefault(key, {"host_s": 0.0, "device_s": 0.0,
                                        "idle_s": 0.0})

        for name in {n for _, _, n in self.ranges}:
            entry(name)["host_s"] = self.host_s((name,))
        groups: Dict[str, List[Tuple[float, float]]] = {}
        for o in self.ops:
            key = ("unmatched" if o.stack is None else
                   o.stack[-1] if o.stack else OUTSIDE)
            groups.setdefault(key, []).append((o.start, o.end))
        for key, v in groups.items():
            entry(key)["device_s"] = 1e-6 * _length(_union(v))
        for (a, b), stack in zip(self.gaps, self._gap_stacks):
            entry(stack[-1] if stack else OUTSIDE)["idle_s"] += (
                1e-6 * (b - a))
        return out


def _device(e, cuda) -> bool:
    return e.device_type() == cuda


def read_program(events, cuda) -> Optional[ProgramTrace]:
    """The window's ``ProgramTrace`` from the profiler's raw events, or
    None without a window range or without any ``pdp.*`` range in it."""
    window = None
    ranges, launches, device = [], {}, []
    for e in events:
        name = e.name()
        if _device(e, cuda):
            if not name.startswith((PREFIX, trace_mod.SPAN_PREFIX,
                                    "Activity Buffer")):
                device.append(e)
            continue
        start = e.start_ns() * 1e-3
        if name == trace_mod.WINDOW_SPAN:
            window = (start, start + e.duration_ns() * 1e-3)
        elif name.startswith(PREFIX):
            ranges.append((start, start + e.duration_ns() * 1e-3,
                           name[len(PREFIX):]))
        elif LAUNCH.match(name) and e.correlation_id():
            launches[e.correlation_id()] = start
    if window is None:
        return None
    w0, w1 = window
    ranges = [r for r in ranges if r[1] > w0 and r[0] < w1]
    if not ranges:
        return None
    joins = {"correlation_id": 0, "linked_correlation_id": 0, "none": 0}
    clipped, at = [], []
    for e in device:
        a = e.start_ns() * 1e-3
        b = a + e.duration_ns() * 1e-3
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        t = launches.get(e.correlation_id())
        how = "correlation_id"
        if t is None:
            t = launches.get(e.linked_correlation_id())
            how = "linked_correlation_id" if t is not None else "none"
        joins[how] += 1
        clipped.append((a, b, e.name()))
        at.append(t)
    order = sorted((t, i) for i, t in enumerate(at) if t is not None)
    stacks = _stacks([t for t, _ in order], ranges)
    by_op: List[Optional[Tuple[str, ...]]] = [None] * len(clipped)
    for (_, i), stack in zip(order, stacks):
        by_op[i] = stack
    ops = [Op(a, b, n, s) for (a, b, n), s in zip(clipped, by_op)]
    return ProgramTrace(window, ranges, ops, joins)


def _without_range_copies(events, cuda) -> list:
    return [e for e in events
            if not (_device(e, cuda) and e.name().startswith(PREFIX))]


def _as_profile(events):
    """An object ``read_profile`` reads as a finished profile holding
    ``events``."""
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def report(program: ProgramTrace, read_s: float) -> None:
    """One line of standard error: device and idle seconds per innermost
    program range, the attributed share of busy time, the joins and the
    seconds this module took to read them."""
    spans = {k: {kk: round(vv, 6) for kk, vv in v.items()}
             for k, v in sorted(program.by_span().items())}
    print("program_spans " + json.dumps(
        {"spans": spans, "attributed_share": program.attributed_share(),
         "ranges": len(program.ranges), "joins": program.joins,
         "read_s": round(read_s, 3)}), file=sys.stderr)


def install() -> None:
    """Wraps ``trace.read_profile`` (once per process) as the module's
    docstring says."""
    if getattr(trace_mod.read_profile, "reads_program", False):
        return
    original = trace_mod.read_profile

    def read_profile(prof):
        from torch.autograd import DeviceType
        events = list(prof.profiler.kineto_results.events())
        trace = original(_as_profile(
            _without_range_copies(events, DeviceType.CUDA)))
        if trace is not None:
            t = time.perf_counter()
            try:
                trace.program = read_program(events, DeviceType.CUDA)
            except Exception:  # the other metrics still read
                print("program_spans not read: " + traceback.format_exc(),
                      file=sys.stderr)
                trace.program = None
            if trace.program is not None:
                report(trace.program, time.perf_counter() - t)
        return trace

    read_profile.reads_program = True
    trace_mod.read_profile = read_profile


def program_of(run) -> Optional[ProgramTrace]:
    """The run's ``ProgramTrace``, or None."""
    return getattr(run.trace, "program", None)


def per_call_ms(run, seconds: float) -> Optional[float]:
    return 1e3 * seconds / len(run.calls) if run.calls else None
