"""The program's spans read from the profiler's raw events
(``benchmark/core/program.py``), on synthetic events and on a traced tiny
CPU cell."""

import dataclasses
import os
import types

import pytest
from torch.autograd import DeviceType

from benchmark.core import program, spec
from benchmark.core import trace as trace_mod
from benchmark.tests.conftest import REPO, run_cpu

US = 1000  # nanoseconds in a microsecond


@dataclasses.dataclass
class Ev:
    """A stand-in for the profiler's raw event (times in microseconds)."""
    name_: str
    start: float
    dur: float
    device: DeviceType = DeviceType.CPU
    corr: int = 0
    linked: int = 0

    def name(self):
        return self.name_

    def device_type(self):
        return self.device

    def start_ns(self):
        return int(self.start * US)

    def duration_ns(self):
        return int(self.dur * US)

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def host_range(name, start, end):
    return Ev(name, start, end - start)


def launch(corr, at):
    return Ev("cudaLaunchKernel", at, 2, corr=corr)


def kernel(name, start, end, corr=0, linked=0):
    return Ev(name, start, end - start, DeviceType.CUDA, corr, linked)


def copy_of(rng):
    """The device-side copy of a host range, as the profiler records it
    on the card."""
    return Ev(rng.name_, rng.start, rng.dur, DeviceType.CUDA)


def window(end=200.0):
    return host_range(trace_mod.WINDOW_SPAN, 0.0, end)


def read(events):
    return program.read_program(events, DeviceType.CUDA)


NESTED = [
    window(),
    host_range("pdp.engine.device", 10, 110),
    host_range("pdp.engine.bound", 20, 50),
    host_range("pdp.engine.fetch", 60, 105),
    launch(1, 25), kernel("cummax", 30, 70, corr=1),
    launch(2, 55), kernel("k1", 72, 90, corr=2),
    launch(3, 65), kernel("Memcpy DtoH (Device -> Pinned)", 92, 100,
                          corr=3),
]


def test_nested_ranges_take_their_launches():
    p = read(NESTED)
    assert p.joins == {"correlation_id": 3, "linked_correlation_id": 0,
                       "none": 0}
    stacks = {o.name: o.stack for o in p.ops}
    assert stacks["cummax"] == ("engine.device", "engine.bound")
    assert stacks["k1"] == ("engine.device",)
    assert stacks["Memcpy DtoH (Device -> Pinned)"] == ("engine.device",
                                                        "engine.fetch")
    assert p.device_s("engine.bound") == pytest.approx(40e-6)
    # The union: [30, 70) and [72, 90) and [92, 100).
    assert p.device_s("engine.device") == pytest.approx(66e-6)
    # Idle gaps [0, 30), [70, 72), [90, 92) have their midpoints inside
    # engine.device; [100, 200) does not.
    assert p.idle_s("engine.device") == pytest.approx(34e-6)
    assert p.idle_s("engine.fetch") == pytest.approx(4e-6)
    assert p.host_s(("engine.bound", "engine.fetch")) == pytest.approx(
        75e-6)
    assert p.attributed_share() == pytest.approx(1.0)


def test_a_launch_at_a_range_edge():
    events = [window(), host_range("pdp.engine.device", 0, 100),
              host_range("pdp.engine.bound", 20, 40),
              launch(1, 20), kernel("at_start", 50, 60, corr=1),
              launch(2, 40), kernel("at_end", 60, 70, corr=2)]
    stacks = {o.name: o.stack for o in read(events).ops}
    assert stacks["at_start"] == ("engine.device", "engine.bound")
    assert stacks["at_end"] == ("engine.device",)


def test_ranges_starting_together_nest_by_their_ends():
    events = [window(), host_range("pdp.inner", 10, 20),
              host_range("pdp.outer", 10, 90),
              launch(1, 10), kernel("k", 30, 40, corr=1)]
    (op,) = read(events).ops
    assert op.stack == ("outer", "inner")


def test_the_linked_id_joins_when_the_correlation_id_does_not():
    events = [window(), host_range("pdp.sweep.chunk", 0, 50),
              launch(7, 10), kernel("fold_ring", 20, 30, corr=99,
                                    linked=7)]
    p = read(events)
    assert p.joins["linked_correlation_id"] == 1
    assert p.device_s("sweep.chunk") == pytest.approx(10e-6)


def test_only_cuda_api_calls_are_launches():
    """An operator or a range that shares a launch's id is no launch."""
    events = [window(), host_range("pdp.engine.bound", 0, 50),
              launch(1, 10), Ev("aten::sort", 60, 5, corr=1),
              Ev("cuLaunchKernel", 20, 1, corr=2),
              kernel("k", 30, 40, corr=1), kernel("fold", 40, 45, corr=2)]
    assert [o.stack for o in read(events).ops] == [("engine.bound",)] * 2


def test_a_device_operation_with_no_launch():
    events = [window(), host_range("pdp.engine.device", 0, 100),
              launch(1, 10), kernel("k", 20, 30, corr=1),
              kernel("orphan", 40, 60, corr=5)]
    p = read(events)
    assert p.joins["none"] == 1
    (orphan,) = [o for o in p.ops if o.name == "orphan"]
    assert orphan.stack is None
    # Busy still, but in no range.
    assert p.device_s("engine.device") == pytest.approx(10e-6)
    # Gaps [0, 20), [30, 40) inside; [60, 200) has its midpoint outside.
    assert p.idle_s("engine.device") == pytest.approx(30e-6)
    assert p.attributed_share() == pytest.approx(10 / 30)
    assert p.by_span()["unmatched"]["device_s"] == pytest.approx(20e-6)


def test_idle_gaps_named_by_the_innermost_range_at_their_midpoint():
    events = [window(100.0), host_range("pdp.engine.device", 0, 60),
              host_range("pdp.engine.fetch", 40, 60),
              launch(1, 1), kernel("k", 10, 30, corr=1),
              launch(2, 41), kernel("d2h", 45, 50, corr=2)]
    spans = read(events).by_span()
    # Gaps: [0, 10) device, [30, 45) fetch (midpoint 37.5 is outside
    # fetch: device), [50, 100) outside (midpoint 75).
    assert spans["engine.device"]["idle_s"] == pytest.approx(25e-6)
    assert spans["outside"]["idle_s"] == pytest.approx(50e-6)
    assert spans["engine.device"]["device_s"] == pytest.approx(20e-6)
    assert spans["engine.fetch"]["device_s"] == pytest.approx(5e-6)
    assert spans["engine.device"]["host_s"] == pytest.approx(60e-6)
    assert spans["engine.fetch"]["host_s"] == pytest.approx(20e-6)


def test_copies_by_direction():
    events = [window(), host_range("pdp.engine.put", 0, 100),
              launch(1, 1), kernel("Memcpy HtoD (Pageable -> Device)",
                                   10, 40, corr=1),
              launch(2, 2), kernel("Memcpy HtoD (Pageable -> Device)",
                                   40, 50, corr=2),
              launch(3, 3), kernel("Memcpy DtoH (Device -> Pageable)",
                                   50, 55, corr=3)]
    p = read(events)
    assert p.copy_s("engine.put", "HtoD") == pytest.approx(40e-6)
    assert p.copy_s("engine.put", "DtoH") == pytest.approx(5e-6)


def test_no_program_ranges_reads_none():
    events = [window(), launch(1, 5), kernel("k", 10, 20, corr=1)]
    assert read(events) is None
    assert read([launch(1, 5), kernel("k", 10, 20, corr=1)]) is None


def as_profile(events):
    return program._as_profile(events)


def test_range_copies_on_the_card_are_not_device_work():
    """The wrapped reader drops the device-side copies of the program's
    ranges: the trace reads as it does for the same run with no
    ranges."""
    program.install()
    ranges = [host_range("pdp.engine.device", 10, 150),
              host_range("pdp.engine.bound", 20, 50)]
    plain = [window(), host_range("bench.device", 5, 160),
             launch(1, 25), kernel("cummax", 30, 70, corr=1),
             launch(2, 60), kernel("k1", 100, 120, corr=2)]
    with_ranges = plain + ranges + [copy_of(r) for r in ranges]
    got = trace_mod.read_profile(as_profile(with_ranges))
    want = trace_mod.read_profile(as_profile(plain))
    for f in ("window_s", "busy_s", "kernel_s", "idle_by_span"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.breakdown() == want.breakdown()
    assert got.busy_s == pytest.approx(60e-6)
    assert want.program is None
    assert got.program.device_s("engine.bound") == pytest.approx(40e-6)
    assert "pdp.engine.device" not in got.kernel_s


def test_program_idle_agrees_with_the_breakdown_on_one_clock():
    """Where a benchmark span and a program range cover the same call,
    both name the same idle gaps."""
    program.install()
    events = NESTED + [host_range("bench.device", 10, 110)]
    got = trace_mod.read_profile(as_profile(events))
    assert got.idle_by_span["device"] == pytest.approx(
        got.program.idle_s("engine.device"))


def test_install_wraps_once():
    program.install()
    first = trace_mod.read_profile
    program.install()
    assert trace_mod.read_profile is first
    assert first.reads_program


def load_metric(name):
    return spec.load_module(os.path.join(REPO, "benchmark", "metrics",
                                         name + ".py"),
                            "test_metric_" + name.replace(".", "_"))


def fake_run(events, calls=2):
    program.install()
    return types.SimpleNamespace(
        trace=trace_mod.read_profile(as_profile(events)),
        calls=[None] * calls)


@pytest.mark.parametrize("name,value", [
    ("bound_ms.query", 40e-3 / 2),
    ("device_path_idle_ms.query", 34e-3 / 2),
    ("factorize_ms.release", None),
    ("h2d_ms.release", None),
    ("sweep_chunk_ms.sweep", None),
])
def test_metric_readers_on_synthetic_ranges(name, value):
    got = load_metric(name).read(fake_run(NESTED))
    if value is None:
        assert got is None
    else:
        assert got == pytest.approx(value)


@pytest.mark.parametrize("name", [
    "bound_ms.query", "device_path_idle_ms.query", "factorize_ms.release",
    "h2d_ms.release", "sweep_chunk_ms.sweep"])
def test_metric_readers_read_nothing_from_a_program_without_ranges(name):
    events = [window(), launch(1, 5), kernel("k", 10, 20, corr=1)]
    assert load_metric(name).read(fake_run(events)) is None


def test_traced_tiny_release_reads_factorize_ms(root):
    r = run_cpu(root, "tiny.release", seed=2**40 + 3, traced=True)
    metrics = r["metrics"]
    assert metrics["factorize_ms.release"]["value"] > 0
    assert metrics["factorize_ms.release"]["unit"] == "ms"
    # No device here: the device-timed readers find nothing to read.
    assert "h2d_ms.release" not in metrics
    assert r["correct"], r["checks"]


def test_a_failed_program_read_leaves_the_trace(monkeypatch, capsys):
    program.install()

    def broken(events, cuda):
        raise KeyError("x")

    monkeypatch.setattr(program, "read_program", broken)
    got = trace_mod.read_profile(as_profile(NESTED))
    assert got.program is None
    assert got.busy_s == pytest.approx(66e-6)
    err = capsys.readouterr().err
    assert "program_spans not read: Traceback" in err
    assert "KeyError" in err
