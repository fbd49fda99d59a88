"""The traced run's instruments, all from the benchmark's own files:

- ``Spans``: ``torch.profiler.record_function`` ranges named
  ``bench.<name>`` around calls into the program's layers, installed by
  wrapping module or class attributes for the traced run only;
- ``KernelRecorder``: counts the launches of a kernel wrapper of the
  program during the window, with each launch's least work from the
  frozen counts of ``benchmark/roofline``, counted once per input shape
  during set-up;
- ``read_profile``: the device's busy time inside the window, the device
  time of each kernel by name, and the idle gaps, each named by the
  benchmark span that was open on the host then.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "window"
CALL_SPAN = SPAN_PREFIX + "call"
BETWEEN_CALLS = "between calls"


def _resolve(path: str):
    """``"pkg.module"`` or ``"pkg.module:Class"`` to the object."""
    mod, _, cls = path.partition(":")
    obj = importlib.import_module(mod)
    return getattr(obj, cls) if cls else obj


class _Patches:
    """Attribute replacements undone in reverse order on ``close``."""

    def __init__(self):
        self._saved: List[Tuple[object, str, object]] = []

    def replace(self, owner, attr: str, make: Callable):
        fn = getattr(owner, attr)
        self._saved.append((owner, attr, fn))
        setattr(owner, attr, make(fn))

    def close(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


class Spans(_Patches):
    """Wraps each ``(owner path, attribute, name)`` of ``targets`` in a
    ``bench.<name>`` profiler range."""

    def __init__(self, targets: Sequence[Tuple[str, str, str]]):
        super().__init__()
        for path, attr, name in targets:
            def make(fn, _label=SPAN_PREFIX + name):
                def spanned(*args, **kwargs):
                    with torch.profiler.record_function(_label):
                        return fn(*args, **kwargs)
                return spanned
            self.replace(_resolve(path), attr, make)


@dataclasses.dataclass
class KernelTarget:
    """A kernel wrapper of the program (``owner`` path and ``attr``), the
    frozen count of one launch's least work from its arguments, and the
    names of the device kernels one launch runs."""
    key: str
    owner: str
    attr: str
    work: Callable
    kernel_names: Tuple[str, ...]


class KernelRecorder(_Patches):
    """Counts each target's launches by input shapes while ``counting``;
    a shape's work is counted from the arguments the first time it is
    seen, which set-up's warm-up arranges to be outside the window."""

    def __init__(self, targets: Sequence[KernelTarget]):
        super().__init__()
        self.work: Dict[Tuple, object] = {}
        self.launches: Dict[Tuple, int] = {}
        self.counting = False
        for t in targets:
            def make(fn, _t=t):
                def recorded(*args, **kwargs):
                    shape = (_t.key,) + tuple(
                        tuple(a.shape) if isinstance(a, torch.Tensor) else
                        _shape_of(a) for a in args)
                    if shape not in self.work:
                        self.work[shape] = _t.work(*args, **kwargs)
                    if self.counting:
                        self.launches[shape] = self.launches.get(shape, 0) + 1
                    return fn(*args, **kwargs)
                return recorded
            self.replace(_resolve(t.owner), t.attr, make)

    def bound_s(self, key: str, bound: Callable) -> Tuple[float, int]:
        """(summed least seconds, launches) of ``key`` in the window."""
        total, n = 0.0, 0
        for shape, count in self.launches.items():
            if shape[0] == key:
                total += count * bound(self.work[shape])
                n += count
        return total, n


def _shape_of(a):
    """A hashable stand-in for a non-tensor argument: tensors inside a
    named tuple by shape, numbers as they are."""
    if isinstance(a, tuple):
        return tuple(tuple(x.shape) if isinstance(x, torch.Tensor) else
                     _shape_of(x) for x in a)
    if isinstance(a, (int, float, str, bool)) or a is None:
        return a
    return type(a).__name__


@dataclasses.dataclass
class Trace:
    """What the profiler saw inside the window (seconds)."""
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    idle_by_span: Dict[str, float]

    def kernel_time(self, names: Sequence[str]) -> float:
        """Summed device seconds of every kernel whose name holds one of
        ``names``."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))

    def breakdown(self) -> Dict[str, List]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _name_points(points: List[float], spans: List[Tuple[float, float, str]]
                 ) -> List[str]:
    """For each sorted time point, the innermost span open then (the one
    that started last), else ``BETWEEN_CALLS``."""
    edges = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)] +
                   [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    open_: Dict[int, float] = {}
    names, j = [], 0
    for t in points:
        while j < len(edges) and edges[j][0] <= t:
            _, is_start, i = edges[j]
            if is_start:
                open_[i] = spans[i][0]
            else:
                open_.pop(i, None)
            j += 1
        if open_:
            inner = max(open_, key=lambda i: open_[i])
            names.append(spans[inner][2][len(SPAN_PREFIX):])
        else:
            names.append(BETWEEN_CALLS)
    return names


def read_profile(prof) -> Optional[Trace]:
    """The window's ``Trace`` from a finished ``torch.profiler.profile``
    whose window ran inside a ``WINDOW_SPAN`` range; None when the window
    range is missing. Reads the profiler's raw events (microseconds on
    one clock for host and device), not its operator tree, which takes
    minutes to build for a window of small kernels."""
    from torch.autograd import DeviceType
    device, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() * 1e-3
        end = start + e.duration_ns() * 1e-3
        if e.device_type() == DeviceType.CUDA:
            if (name.startswith(SPAN_PREFIX) or
                    name.startswith("Activity Buffer")):
                continue  # the ranges' device-side copies, the buffer
            device.append((start, end, name))
        elif name == WINDOW_SPAN:
            window = (start, end)
        elif name.startswith(SPAN_PREFIX):
            spans.append((start, end, name))
    if window is None:
        return None
    w0, w1 = window
    kernel_s: Dict[str, float] = {}
    clipped = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
    busy = _union(clipped)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    names = _name_points([(a + b) / 2 for a, b in gaps], spans)
    idle: Dict[str, float] = {}
    for (a, b), n in zip(gaps, names):
        idle[n] = idle.get(n, 0.0) + (b - a) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernel_s=kernel_s, idle_by_span=idle)
