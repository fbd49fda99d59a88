"""One run of one cell: set-up, the measured window, the reading of the
trace, the check of the outputs, the result line.

The window: calls of the cell's runner back to back from one client; a
call that starts before the deadline completes, and the window ends at
the last completion. Every rate is all the work of the window over all
its time. Peak device memory is the window's, after
``reset_peak_memory_stats()`` at its start. The reference runs after the
window, after the peak is read and the program's state is freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark.core import spec, trace as trace_mod

# The port's optional planes stay off, so every run of a cell does the
# same work; the planner loads no plan file.
PLANE_VARS = ("PIPELINEDP_TPU_TRACE", "PIPELINEDP_TPU_COSTS",
              "PIPELINEDP_TPU_HEARTBEAT", "PIPELINEDP_TPU_LEDGER_DIR")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pipelinedp_tpu")


@dataclasses.dataclass
class Call:
    t0: float
    t1: float
    units: float
    timings: Optional[Dict[str, float]]
    failed: bool


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    calls: List[Call]
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: Optional[trace_mod.Trace] = None
    kernels: Optional[trace_mod.KernelRecorder] = None


def quiet_planes() -> None:
    os.environ["PIPELINEDP_TPU_PLAN_DIR"] = "off"
    for var in PLANE_VARS:
        os.environ.pop(var, None)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is one of
    ``FORBIDDEN_MODULES``, compared whole."""
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def call_seed(seed: int, i: int) -> int:
    """A 31-bit seed for call ``i`` of the run seeded ``seed``."""
    ss = np.random.SeedSequence([seed % (1 << 63), (seed >> 63) % (1 << 32),
                                 i])
    return int(ss.generate_state(1)[0] >> 1)


def device_record(device: torch.device, peak: int) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def kernel_sources() -> List[str]:
    """Every kernel library of the port: ``csrc/<source>.cu``."""
    import pipelinedp_tpu_torch
    csrc = os.path.join(os.path.dirname(pipelinedp_tpu_torch.__file__),
                        "csrc")
    return sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))


def _kernel_targets(cell: spec.Cell) -> List[trace_mod.KernelTarget]:
    return [m.module.KERNEL for m in cell.per_layer
            if getattr(m.module, "KERNEL", None) is not None]


def _window(runner, seconds: float, device: torch.device):
    calls: List[Call] = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        with torch.profiler.record_function(trace_mod.CALL_SPAN):
            try:
                units, timings = runner.call(i)
                failed = False
            except Exception as exc:  # a failed call is counted, not fatal
                print(f"call {i} raised {type(exc).__name__}: {exc}",
                      file=sys.stderr)
                units, timings, failed = 0, None, True
        calls.append(Call(t0, time.perf_counter(), units, timings, failed))
        i += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    calls[-1].t1 = time.perf_counter()
    return calls, t_start


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t_process: float
             ) -> Dict[str, Any]:
    """Runs the cell and returns the result line's object, the compared
    numbers under ``checks``; set-up's steps go to standard error."""
    phases = {"start_s": time.perf_counter() - t_process}
    cell = spec.load_cell(root, workload)
    quiet_planes()
    t = time.perf_counter()
    import pipelinedp_tpu_torch  # noqa: F401
    from pipelinedp_tpu_torch.ops import kernels as port_kernels
    phases["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        port_kernels.build(kernel_sources())
    phases["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    table = spec.load_generator(cell).generate(cell.config, seed, device)
    phases["data_s"] = time.perf_counter() - t
    runner = spec.load_runner(cell).Runner(cell, seed, device, table)
    kernels = spans = None
    if traced:
        kernels = trace_mod.KernelRecorder(_kernel_targets(cell))
        spans = trace_mod.Spans(runner.spans())
    try:
        t = time.perf_counter()
        runner.setup()
        phases["warmup_s"] = time.perf_counter() - t
        # The interpreter's first full collection after start-up walks
        # every object the imports made: set-up, not a call.
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_process
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with (_profiler(device) if traced else
              contextlib.nullcontext()) as prof:
            if traced:
                kernels.counting = True
            with torch.profiler.record_function(trace_mod.WINDOW_SPAN):
                calls, t_start = _window(runner, seconds, device)
            if traced:
                kernels.counting = False
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        window_s = calls[-1].t1 - t_start
    finally:
        if spans is not None:
            spans.close()
        if kernels is not None:
            kernels.close()
    run = Run(calls, window_s, setup_s, peak, kernels=kernels)
    if traced:
        run.trace = trace_mod.read_profile(prof)
        del prof
    # The comparison: the program's state goes first, then the reference.
    runner.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    outputs_ok, numbers = runner.judge()
    phases.update(setup_s=setup_s, window_s=window_s,
                  judge_s=time.perf_counter() - t_judge)
    print("phases " + " ".join(f"{k}={v!r}" for k, v in phases.items()),
          file=sys.stderr)
    failed = sum(c.failed for c in calls)
    checks = {}
    correct = outputs_ok and failed == 0
    for name, limit in cell.limits.items():
        value = numbers.get(name, float("inf"))
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            correct = False
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": int(failed), "metrics": metrics,
              "device": device_record(device, peak)}
    if traced and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result
