"""Device cost observatory: per-program device time, memory and rooflines.

Port of ``pipelinedp_tpu/obs/costs.py``. The JAX package captures what
XLA's compiler says about each jitted program (``cost_analysis``,
``memory_analysis``); PyTorch has no compiler to ask, so the port measures
what it can and counts what it knows:

* :func:`instrumented` — the ONE seam the port's device phases run
  through (``torch_engine.py``, ``streaming.py``,
  ``analysis/torch_sweep.py``, ``sketch/device.py``), with the JAX
  package's phase labels (``engine``, ``fetch``, ``pass_a``, ``pass_b``,
  ``walk``, ``select``, ``sweep``, ``sketch``). With
  ``PIPELINEDP_TPU_COSTS`` unset it calls the function after one
  environment check: no event, no synchronise, no table entry. Enabled,
  each call is keyed by (function, argument shapes and dtypes) and
  records its time — between two CUDA events on the card, on the host
  clock for CPU tensors — and, on the card, its peak memory where the
  phase set the process's peak (see :func:`_measure`). A phase made
  of torch operators has no flop or byte count: its entry says so
  (``cost.unavailable``), it never gets a made-up one.
* :func:`kernel_launch` — the seam of the hand kernels K1-K5
  (``ops/kernels/*.py``). Each launch is a program of its own, booked
  under the phase it launched in, whose counts are its kernel module's
  ``work`` of these inputs: the same :class:`Work` that ``chip_smoke.py``
  bounds each kernel with, so the table's ``bound_ms`` and the kernels
  line's are one number. K1-K5 get a roofline verdict against
  :data:`DEVICE_PEAKS`.
* :func:`build_span` — the first build of each hand kernel
  (``ops/kernels/_build.py``) and native library (``native/``) in a
  process: a ``compile.program`` span and a build record with the
  hashed build cache's hit or miss, in place of XLA's compile-cache
  listener.
* :func:`sample_live_bytes` — device memory sampling for the monitor's
  heartbeat (``torch.cuda.memory_allocated``), into the ``hbm.live_bytes``
  gauge and the ``hbm.watermark`` running max.

Bit-identity: the seams time and count around the same calls, so released
values are bit-identical with the flag on and off (PARITY row 31).

This module imports only the stdlib at module level; ``torch`` is imported
where a measurement needs it, by which point the caller has imported it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time as _time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

ENV_VAR = "PIPELINEDP_TPU_COSTS"

#: Peak FLOP/s and device-memory bytes/s per device kind — the roofline
#: ceilings arithmetic intensity is judged against. Matching is by
#: lowercase substring of ``torch.cuda.get_device_name``. The H100 row
#: is NVIDIA's SXM data sheet: 3.35 TB/s of HBM3, and 67 TFLOP/s of
#: float32 outside the tensor cores, the rate taken for the kernels'
#: int32 adds. The CPU rows are order-of-magnitude PROXIES (one desktop
#: core's vector units and DDR channel; an interpreter ~100x below): good
#: enough to rank programs against each other, NOT a machine model, so
#: their verdicts carry ``proxy: true``.
DEVICE_PEAKS: Tuple[Dict[str, Any], ...] = (
    {"match": ("h100",),
     "kind": "h100_sxm", "flops_per_s": 67e12,
     "hbm_bytes_per_s": 3.35e12, "sm_clock_hz": 1.98e9, "proxy": False,
     "source": "NVIDIA H100 SXM data sheet (float32 non-tensor; HBM3; "
               "1980 MHz top SM clock)"},
    {"match": ("cpu",),
     "kind": "cpu_proxy", "flops_per_s": 1e11,
     "hbm_bytes_per_s": 5e10, "sm_clock_hz": 3e9, "proxy": True},
    {"match": ("interpret", "host"),
     "kind": "cpu_interpret", "flops_per_s": 1e9,
     "hbm_bytes_per_s": 5e8, "sm_clock_hz": 3e7, "proxy": True},
)

#: Cycles of one dependent float32 add: the adds of one segment (K4) or
#: key (K5) form one chain, so the longest takes at least its length
#: times this at the top SM clock.
ADD_CHAIN_CYCLES = 4


class Work(NamedTuple):
    """The least work one kernel launch needs on its inputs, counted
    from this run's data (each kernel module's ``work``): the adds the
    result needs, the bytes it must move (each needed input byte read
    once, each output written once), and the longest chain of dependent
    adds (0 where the adds are independent)."""
    ops: int
    bytes: int
    chain: int = 0


def kernel_bound(work: Work, peaks: Dict[str, Any]) -> Dict[str, Any]:
    """The least time the device could take for ``work``: the larger of
    its bytes over the memory rate and its operations — the adds over the
    peak rate, or the longest add chain at the top SM clock, whichever is
    longer. {bound_ms, bound_by ("bytes" | "operations"), bytes_ms,
    ops_ms, chain_ms}."""
    bytes_ms = 1e3 * work.bytes / peaks["hbm_bytes_per_s"]
    ops_ms = 1e3 * work.ops / peaks["flops_per_s"]
    chain_ms = 1e3 * work.chain * ADD_CHAIN_CYCLES / peaks["sm_clock_hz"]
    op_ms = max(ops_ms, chain_ms)
    return {"bound_ms": max(bytes_ms, op_ms),
            "bound_by": "bytes" if bytes_ms >= op_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "chain_ms": chain_ms}


def costs_enabled() -> bool:
    """True when ``PIPELINEDP_TPU_COSTS`` requests device-cost capture
    (any value except empty/0/false/off)."""
    return os.environ.get(ENV_VAR, "").lower() not in ("", "0", "false",
                                                       "off")


def device_peaks(device_kind: Optional[str]) -> Optional[Dict[str, Any]]:
    """The peak-table row for a ``device_kind`` string, or None when no
    row matches (the verdict is then ``unknown`` — an honest answer
    beats a made-up ceiling)."""
    if not device_kind:
        return None
    kind = device_kind.lower()
    for row in DEVICE_PEAKS:
        if any(m in kind for m in row["match"]):
            return row
    return None


def roofline_verdict(flops: Optional[float],
                     bytes_accessed: Optional[float],
                     peaks: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Classify one program (or one phase's aggregate) against the
    device roofline: ``compute_bound`` when arithmetic intensity
    (flops/byte) is at or above the ridge point (peak FLOP/s over peak
    bytes/s), ``bandwidth_bound`` below it, ``unknown`` when the
    counts or the peak row are missing."""
    out: Dict[str, Any] = {"verdict": "unknown", "intensity": None,
                           "ridge": None}
    if peaks is not None:
        out["ridge"] = round(peaks["flops_per_s"] /
                             peaks["hbm_bytes_per_s"], 3)
    if flops is None or bytes_accessed is None or bytes_accessed <= 0:
        return out
    # Intensity is a property of the program: it stays even without a
    # peak row (only the verdict needs the ridge).
    intensity = flops / bytes_accessed
    out["intensity"] = round(intensity, 4)
    if peaks is None:
        return out
    out["verdict"] = ("compute_bound" if intensity >= out["ridge"]
                      else "bandwidth_bound")
    return out


class CostTable:
    """Process-global per-program cost table (thread-safe). One entry
    per (program, shape signature); the run report's ``device_costs``
    section and ``store --summarize``'s cost/roofline columns are views
    over :meth:`snapshot`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: Dict[str, Dict[str, Any]] = {}
        self._builds: Dict[str, Dict[str, Any]] = {}
        self._device_kind: Optional[str] = None
        self._platform: Optional[str] = None

    def note_device(self, platform: Optional[str],
                    device_kind: Optional[str]) -> None:
        with self._lock:
            if device_kind:
                self._device_kind = device_kind
            if platform:
                self._platform = platform

    def record(self, key: str, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._programs[key] = entry

    def note_call(self, key: str, ms: Optional[float] = None,
                  peak_bytes: Optional[int] = None,
                  work: Optional[Work] = None) -> None:
        """One call of a recorded program: its time, its peak memory
        where known, and for a kernel launch its :class:`Work`. A
        kernel's counts and bound are summed over its calls, as its
        time is, since each call's data decides its work."""
        with self._lock:
            entry = self._programs.get(key)
            if entry is None:
                return
            entry["calls"] = entry.get("calls", 0) + 1
            if ms is not None:
                entry["ms"] = round(entry.get("ms", 0.0) + ms, 6)
            if work is not None:
                entry["flops"] += work.ops
                entry["bytes_accessed"] += work.bytes
                peaks = device_peaks(entry.get("device_kind"))
                if peaks is not None:
                    entry["bound_ms"] = (entry["bound_ms"] or 0.0) + (
                        kernel_bound(work, peaks)["bound_ms"])
                entry.update({k: v for k, v in roofline_verdict(
                    entry["flops"], entry["bytes_accessed"],
                    peaks).items() if k in ("intensity", "verdict")})
            if peak_bytes is not None:
                mem = entry.setdefault("memory", {}) or {}
                mem["peak_bytes"] = max(mem.get("peak_bytes", 0),
                                        int(peak_bytes))
                entry["memory"] = mem

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._programs

    def note_build(self, name: str, record: Dict[str, Any]) -> None:
        """A hand kernel's or native library's first build (or load) in
        this process: kept across :meth:`reset`, since the process holds
        the library until it exits."""
        with self._lock:
            self._builds[name] = dict(record)

    def reset(self) -> None:
        with self._lock:
            self._programs = {}

    def snapshot(self) -> Dict[str, Any]:
        """The ``device_costs`` section: the peak row in force, every
        program entry, the builds, and per-phase aggregates (flops/bytes
        summed over the phase's analysed programs, one roofline verdict
        per phase — ``unknown`` only where no program in the phase
        carried counts; ``ms`` sums the phase's own programs and
        ``kernel_ms`` the hand-kernel launches inside them)."""
        with self._lock:
            programs = {k: dict(v) for k, v in self._programs.items()}
            builds = {k: dict(v) for k, v in self._builds.items()}
            device_kind = self._device_kind
            platform = self._platform
        peaks = device_peaks(device_kind)
        phases: Dict[str, Dict[str, Any]] = {}
        for entry in programs.values():
            ph = phases.setdefault(entry.get("phase") or "device", {
                "programs": 0, "calls": 0, "compile_s": 0.0, "ms": 0.0,
                "kernel_ms": 0.0, "flops": 0.0, "bytes_accessed": 0.0,
                "analyzed": 0})
            ph["programs"] += 1
            ph["calls"] += entry.get("calls", 0)
            ph["compile_s"] += entry.get("compile_s") or 0.0
            ph["kernel_ms" if entry.get("kernel") else "ms"] += (
                entry.get("ms") or 0.0)
            if entry.get("flops") is not None and (
                    entry.get("bytes_accessed") is not None):
                ph["analyzed"] += 1
                ph["flops"] += entry["flops"]
                ph["bytes_accessed"] += entry["bytes_accessed"]
        for ph in phases.values():
            for k in ("compile_s", "ms", "kernel_ms"):
                ph[k] = round(ph[k], 6)
            verdict = roofline_verdict(
                ph["flops"] if ph["analyzed"] else None,
                ph["bytes_accessed"] if ph["analyzed"] else None, peaks)
            ph.update(verdict)
        return {
            "platform": platform,
            "device_kind": device_kind,
            "peaks": ({k: peaks[k] for k in ("kind", "flops_per_s",
                                             "hbm_bytes_per_s", "proxy")}
                      if peaks else None),
            "programs": programs,
            "phases": phases,
            "builds": builds,
        }


#: The one process-global cost table (``pipelinedp_tpu_torch.obs``
#: re-exports it; ``obs.reset()`` clears it at run boundaries).
TABLE = CostTable()

#: This thread's open measurements: ``phase``, the phase of the
#: innermost instrumented call, under which a kernel launched inside it
#: is booked.
_STATE = threading.local()

#: The phase a kernel launch is booked under outside every instrumented
#: call.
KERNEL_PHASE = "kernel"


def _first_tensor(args, kwargs):
    import torch
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    return b
    return None


def _describe(v) -> str:
    import torch
    if isinstance(v, torch.Tensor):
        return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
    if isinstance(v, (list, tuple)):
        return "(" + ", ".join(_describe(b) for b in v) + ")"
    if isinstance(v, (bool, int, float, str, type(None))):
        return repr(v)
    return type(v).__name__


def signature_label(args, kwargs) -> str:
    """The shapes and dtypes of the tensor arguments and the values of
    the plain ones — the key one program's entry is recorded under."""
    frags = [_describe(a) for a in args]
    frags.extend(f"{k}={_describe(kwargs[k])}" for k in sorted(kwargs))
    label = ", ".join(frags)
    return label if len(label) <= 512 else label[:509] + "..."


def _table_key(name: str, signature: str) -> str:
    import zlib
    return f"{name}#{zlib.crc32(signature.encode()):08x}"


def _note_device(dev) -> Optional[str]:
    """Records the device a measurement ran on; returns its kind."""
    if dev is not None and dev.type == "cuda":
        import torch
        kind = torch.cuda.get_device_name(dev)
        TABLE.note_device("gpu", kind)
        return kind
    TABLE.note_device("cpu", "cpu")
    return "cpu"


@contextlib.contextmanager
def _measure(name: str, phase: str, signature: str, dev,
             work: Optional[Callable[[], Work]] = None):
    """Times the body (CUDA events on the card, the host clock for CPU
    tensors) and records it under (name, signature). ``work`` marks a
    hand kernel's launch: it is called once per launch, before the
    timed body, for the launch's counts.

    Peak memory: the allocator's peak counter belongs to the process
    and is never reset here (a caller may be reading it across a run).
    A phase whose peak passes every earlier peak of the process moves
    the counter, and that new value is the phase's exact peak; a phase
    that stays under an earlier peak records none. A kernel's ``work``
    runs inside the phase that launched it, so its temporaries count
    toward that phase's peak."""
    from pipelinedp_tpu_torch import obs
    on_card = dev is not None and dev.type == "cuda"
    kernel = work is not None
    # A kernel launched from two phases is two programs, one per phase.
    key = _table_key(name, f"{phase}|{signature}" if kernel else signature)
    if not TABLE.has(key):
        device_kind = _note_device(dev)
        unavailable = None
        if not kernel:
            # Torch operators: no compiler reports their work, so the
            # entry carries time and memory only.
            unavailable = ["flops/bytes: torch operators"]
            obs.inc("cost.unavailable")
            obs.event("cost.unavailable", program=name,
                      analyses=unavailable[0])
        TABLE.record(key, {
            "program": name, "phase": phase, "signature": signature,
            "kernel": kernel, "device_kind": device_kind,
            "timer": "cuda_event" if on_card else "host_clock",
            "flops": 0 if kernel else None,
            "bytes_accessed": 0 if kernel else None,
            "intensity": None, "verdict": "unknown",
            "bound_ms": None,
            "memory": None, "unavailable": unavailable,
            "calls": 0, "ms": 0.0})
        obs.inc("cost.programs_captured")
    counts = work() if kernel else None
    outer = getattr(_STATE, "phase", None)
    if not kernel:
        _STATE.phase = phase
    try:
        if on_card:
            import torch
            peak_before = torch.cuda.max_memory_allocated(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            TABLE.note_call(key, ms=start.elapsed_time(end),
                            peak_bytes=peak if peak > peak_before else None,
                            work=counts)
        else:
            t0 = _time.perf_counter()
            yield
            TABLE.note_call(key, ms=(_time.perf_counter() - t0) * 1e3,
                            work=counts)
    finally:
        _STATE.phase = outer


class _Instrumented:
    """The callable :func:`instrumented` returns: the function itself,
    plus, under ``PIPELINEDP_TPU_COSTS``, a measured call."""

    def __init__(self, fn: Callable, phase: str):
        self._fn = fn
        self._phase = phase
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        if not costs_enabled():
            return self._fn(*args, **kwargs)
        sig = signature_label(args, kwargs)
        with _measure(self._fn.__name__, self._phase, sig,
                      _device_of(args, kwargs)):
            return self._fn(*args, **kwargs)


def _device_of(args, kwargs):
    t = _first_tensor(args, kwargs)
    return t.device if t is not None else None


def instrumented(fn: Optional[Callable] = None, *, phase: str = "device"):
    """Measures a device phase under ``PIPELINEDP_TPU_COSTS`` and calls it
    plainly otherwise. ``phase`` labels the program's roofline bucket
    (``engine`` / ``pass_a`` / ``pass_b`` / ``walk`` / ...). Usable bare
    (``@instrumented``) or configured (``@instrumented(phase="walk")``)."""
    if fn is not None:
        return _Instrumented(fn, phase)

    def wrap(f: Callable) -> _Instrumented:
        return _Instrumented(f, phase)
    return wrap


def kernel_launch(name: str, args: Tuple[Any, ...],
                  work: Callable[[], Work]):
    """The context a hand kernel's wrapper launches in: under
    ``PIPELINEDP_TPU_COSTS`` it records the launch as program ``name``,
    booked under the phase of the instrumented call it runs in
    (:data:`KERNEL_PHASE` outside any), with the counts ``work()``
    returns for these inputs; otherwise the shared no-op context, and
    ``work`` is never called."""
    from pipelinedp_tpu_torch.obs.tracer import NOOP_SPAN
    if not costs_enabled():
        return NOOP_SPAN
    return _measure(name, getattr(_STATE, "phase", None) or KERNEL_PHASE,
                    signature_label(args, {}), _device_of(args, {}),
                    work=work)


@contextlib.contextmanager
def build_span(name: str, cached: bool):
    """Around the first build (or load) of a hand kernel's or native
    library's shared object in this process: a ``compile.program`` span
    and a build record with the hashed build cache's ``hit`` (the
    library was on disk) or ``miss`` (it was compiled)."""
    from pipelinedp_tpu_torch import obs
    t0 = _time.perf_counter()
    with obs.tracer().span("compile.program", cat="compile", program=name,
                           compile_cache="hit" if cached else "miss"):
        yield
    obs.inc("compile.cache_hits" if cached else "compile.cache_misses")
    TABLE.note_build(name, {"compile_s": round(_time.perf_counter() - t0,
                                               6),
                            "compile_cache": "hit" if cached else "miss"})


# --- device memory sampling (monitor beat hook) ---

_HBM_LOCK = threading.Lock()
_HBM = {"live_bytes": None, "watermark": 0}


def _live_device_bytes() -> Optional[int]:
    import torch
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.memory_allocated())


def sample_live_bytes() -> Optional[int]:
    """Live device bytes (``torch.cuda.memory_allocated``) into the
    ``hbm.live_bytes`` gauge, the ``hbm.watermark`` running max and the
    ledger time-series behind the Chrome-trace counter track. Called by
    the monitor each heartbeat beat; a no-op (None) when
    ``PIPELINEDP_TPU_COSTS`` is off or no card is present — sampling
    must never take the beat down."""
    if not costs_enabled():
        return None
    try:
        n = _live_device_bytes()
    except Exception:
        return None
    if n is None:
        return None
    from pipelinedp_tpu_torch import obs
    from pipelinedp_tpu_torch.obs.tracer import trace_enabled
    with _HBM_LOCK:
        _HBM["live_bytes"] = n
        _HBM["watermark"] = max(_HBM["watermark"], n)
    led = obs.ledger()
    led.gauge("hbm.live_bytes", n)
    led.gauge_max("hbm.watermark", n)
    # The time series only feeds the Chrome-trace counter track, so it
    # accumulates only when tracing will export it.
    if trace_enabled():
        led.sample("hbm.live_bytes", n)
    return n


def hbm_snapshot() -> Optional[Dict[str, int]]:
    """{live_bytes, watermark} from the most recent sample, or None
    before the first one (the heartbeat omits the section then)."""
    with _HBM_LOCK:
        if _HBM["live_bytes"] is None:
            return None
        return {"live_bytes": _HBM["live_bytes"],
                "watermark": _HBM["watermark"]}


def reset() -> None:
    """Clear the cost table and the memory watermark (run boundaries;
    tests). Build records stay: the process still holds the libraries."""
    TABLE.reset()
    with _HBM_LOCK:
        _HBM["live_bytes"] = None
        _HBM["watermark"] = 0
