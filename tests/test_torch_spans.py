"""The port's spans on the profiler's clock (``pipelinedp_tpu_torch/obs``).

While ``torch.profiler`` records, every span opens a ``record_function``
range ``pdp.<span name>``; with no profiler it dispatches no profiler op.
``obs.tracer()`` hands out the range-only tracer under the profiler. The
fused aggregation and the utility sweep open their layers' spans, nested
as the layers are, and release the same bits with the profiler on.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import analysis, obs

# ``obs.tracer`` is the global-tracer function; the module by its path.
tracer_mod = importlib.import_module("pipelinedp_tpu_torch.obs.tracer")

PLANE_VARS = ("PIPELINEDP_TPU_TRACE", "PIPELINEDP_TPU_HEARTBEAT",
              "PIPELINEDP_TPU_COSTS", "PIPELINEDP_TPU_LEDGER_DIR")

ENCODE_SPANS = ("encode.pk", "encode.pid", "encode.values")
DEVICE_SPANS = ("engine.put", "engine.bound", "engine.reduce",
                "engine.select", "engine.fetch")
SWEEP_SPANS = ("sweep.encode", "sweep.stage_a", "sweep.chunk",
               "sweep.fetch", "sweep.pack")


@pytest.fixture(autouse=True)
def quiet_planes(monkeypatch):
    for var in PLANE_VARS:
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    yield
    obs.reset()


@dataclasses.dataclass
class Range:
    name: str
    start: int
    end: int

    def holds(self, other: "Range") -> bool:
        return self.start <= other.start and other.end <= self.end


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def program_ranges(prof):
    """The ``pdp.*`` ranges the profiler recorded, names without the
    prefix, in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(obs.RANGE_PREFIX):
            out.append(Range(e.name()[len(obs.RANGE_PREFIX):], e.start_ns(),
                             e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda r: r.start)


def by_name(ranges):
    out = {}
    for r in ranges:
        out.setdefault(r.name, []).append(r)
    return out


class CountingRecordFunction:
    """Stands in for ``record_function``: counts the ranges opened."""

    def __init__(self, real):
        self.real = real
        self.names = []

    def __call__(self, name, *args):
        self.names.append(name)
        return self.real(name, *args)


@pytest.fixture
def counting(monkeypatch):
    rec = CountingRecordFunction(autograd_profiler.record_function)
    monkeypatch.setattr(autograd_profiler, "record_function", rec)
    return rec


# ---------------------------------------------------------------------
# The tracer core
# ---------------------------------------------------------------------


class TestSpanRanges:

    @pytest.mark.parametrize("make", ["run_tracer", "recording", "global"])
    def test_span_opens_a_profiler_range(self, make, monkeypatch):
        if make == "recording":
            monkeypatch.setenv(obs.ENV_VAR, "1")
        with cpu_profile() as prof:
            tr = obs.run_tracer() if make != "global" else obs.tracer()
            with tr.span("layer.outer", cat="test"):
                with tr.span("layer.inner", cat="test"):
                    torch.ones(8).sum()
        got = by_name(program_ranges(prof))
        (outer,), (inner,) = got["layer.outer"], got["layer.inner"]
        assert outer.holds(inner)

    @pytest.mark.parametrize("make", ["run_tracer", "recording", "global",
                                      "range"])
    def test_no_profiler_op_without_a_profiler(self, make, counting,
                                               monkeypatch):
        if make == "recording":
            monkeypatch.setenv(obs.ENV_VAR, "1")
        tr = {"run_tracer": obs.run_tracer, "recording": obs.run_tracer,
              "global": obs.tracer,
              "range": lambda: obs.RANGE_TRACER}[make]()
        assert not obs.profiler_recording()
        with tr.span("layer.quiet"):
            torch.ones(4).sum()
        assert counting.names == []

    def test_profiler_state_is_read_through_sys_modules(self):
        assert not obs.profiler_recording()
        with cpu_profile():
            assert obs.profiler_recording()
        assert not obs.profiler_recording()

    def test_range_closes_when_the_body_raises(self):
        with cpu_profile() as prof:
            tr = obs.run_tracer()
            with pytest.raises(ValueError):
                with tr.span("layer.fails"):
                    raise ValueError("boom")
            with tr.span("layer.after"):
                pass
        got = by_name(program_ranges(prof))
        (fails,), (after,) = got["layer.fails"], got["layer.after"]
        assert fails.end <= after.start
        assert tr.count("layer.fails") == 1

    def test_range_is_outside_the_span_duration(self):
        reads = []

        class Clock:
            def monotonic(self):
                reads.append(None)
                return float(len(reads))

        with cpu_profile() as prof:
            tr = obs.run_tracer(clock=Clock())
            with tr.span("layer.timed"):
                pass
        assert tr.total("layer.timed") == 1.0
        assert [r.name for r in program_ranges(prof)] == ["layer.timed"]

    def test_recording_span_pushes_nvtx_when_cuda_is_up(self, monkeypatch):
        calls = []

        class FakeNvtx:
            def range_push(self, name):
                calls.append(("push", name))

            def range_pop(self):
                calls.append(("pop",))

        monkeypatch.setattr(tracer_mod, "_nvtx", lambda: FakeNvtx())
        with obs.run_tracer().span("layer.quiet"):
            pass
        assert calls == []  # tracing off: no NVTX
        monkeypatch.setenv(obs.ENV_VAR, "1")
        with obs.run_tracer().span("layer.outer"):
            with obs.tracer().span("layer.inner"):
                pass
        assert calls == [("push", "pdp.layer.outer"),
                         ("push", "pdp.layer.inner"), ("pop",), ("pop",)]

    def test_no_nvtx_before_cuda_is_initialised(self):
        if torch.cuda.is_initialized():
            pytest.skip("CUDA is initialised in this process")
        assert tracer_mod._nvtx() is None


class TestGlobalTracer:

    def test_noop_without_a_profiler(self):
        assert obs.tracer() is obs.NOOP_TRACER
        assert obs.span("x") is obs.NOOP_SPAN

    def test_range_only_under_the_profiler(self):
        with cpu_profile() as prof:
            tr = obs.tracer()
            assert tr is obs.RANGE_TRACER
            assert not tr.recording
            with tr.span("layer.ranged", batch=3) as sp:
                assert sp.duration == 0.0
        assert [r.name for r in program_ranges(prof)] == ["layer.ranged"]
        snap = obs.ledger().snapshot()
        assert snap["spans"] == []
        assert tr.total("layer.ranged") == 0.0
        assert obs.tracer() is obs.NOOP_TRACER

    def test_recording_wins_over_the_profiler(self, monkeypatch):
        monkeypatch.setenv(obs.ENV_VAR, "1")
        with cpu_profile() as prof:
            tr = obs.tracer()
            assert tr.recording
            with tr.span("layer.recorded"):
                pass
        assert [s.name for s in obs.ledger().snapshot()["spans"]] == [
            "layer.recorded"]
        assert [r.name for r in program_ranges(prof)] == ["layer.recorded"]

    def test_range_tracer_keeps_no_state(self):
        assert not hasattr(obs.RANGE_TRACER, "__dict__")
        assert isinstance(obs.RANGE_TRACER, obs.RangeTracer)


# ---------------------------------------------------------------------
# The layers' spans on the cells' paths
# ---------------------------------------------------------------------


def make_ds(seed=4, n=3_000, users=400, parts=30):
    rng = np.random.default_rng(seed)
    return pdt.ArrayDataset(privacy_ids=rng.integers(0, users, n),
                            partition_keys=rng.integers(0, parts, n),
                            values=rng.uniform(0.0, 5.0, n))


def aggregate(ds, metrics=("COUNT", "SUM", "MEAN"), seed=11):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = pdt.DPEngine(acc, pdt.TorchBackend(device="cpu",
                                                rng_seed=seed))
    params = pdt.AggregateParams(
        metrics=[getattr(pdt.Metrics, m) if isinstance(m, str) else m
                 for m in metrics],
        noise_kind=pdt.NoiseKind.LAPLACE,
        max_partitions_contributed=4, max_contributions_per_partition=2,
        min_value=0.0, max_value=5.0)
    res = engine.aggregate(ds, params, pdt.DataExtractors())
    acc.compute_budgets()
    return dict(res)


def assert_bit_identical(a, b):
    assert set(a) == set(b)
    for k in a:
        for f in a[k]._fields:
            assert (np.asarray(getattr(a[k], f)).tobytes() ==
                    np.asarray(getattr(b[k], f)).tobytes()), (k, f)


@pytest.fixture(scope="module")
def traced_aggregation():
    """(released rows with no profiler, released rows and ranges under
    the profiler) of one seeded aggregation of a fresh dataset."""
    obs.reset()
    plain = aggregate(make_ds())
    with cpu_profile() as prof:
        traced = aggregate(make_ds())
    return plain, traced, by_name(program_ranges(prof))


class TestAggregationSpans:

    @pytest.mark.parametrize("child", ENCODE_SPANS)
    def test_encode_children(self, traced_aggregation, child):
        _, _, ranges = traced_aggregation
        (encode,) = ranges["engine.encode"]
        (r,) = ranges[child]
        assert encode.holds(r)

    @pytest.mark.parametrize("child", DEVICE_SPANS)
    def test_device_children(self, traced_aggregation, child):
        _, _, ranges = traced_aggregation
        (device,) = ranges["engine.device"]
        (r,) = ranges[child]
        assert device.holds(r)

    def test_device_children_in_order_and_disjoint(self, traced_aggregation):
        _, _, ranges = traced_aggregation
        kids = [ranges[n][0] for n in DEVICE_SPANS]
        for a, b in zip(kids, kids[1:]):
            assert a.end <= b.start

    def test_no_walk_without_percentiles(self, traced_aggregation):
        _, _, ranges = traced_aggregation
        assert "engine.walk" not in ranges

    def test_release_outside_the_device_path(self, traced_aggregation):
        _, _, ranges = traced_aggregation
        (device,), (release,) = ranges["engine.device"], ranges[
            "engine.release"]
        assert device.end <= release.start

    def test_released_bits_unchanged(self, traced_aggregation):
        plain, traced, _ = traced_aggregation
        assert plain
        assert_bit_identical(plain, traced)

    def test_percentile_walk_span(self):
        metrics = ("COUNT", pdt.Metrics.PERCENTILE(50))
        plain = aggregate(make_ds(seed=5), metrics)
        with cpu_profile() as prof:
            traced = aggregate(make_ds(seed=5), metrics)
        ranges = by_name(program_ranges(prof))
        (device,) = ranges["engine.device"]
        walks = ranges["engine.walk"]
        assert len(walks) == 2  # the walk's rows, then the walk
        assert all(device.holds(w) for w in walks)
        assert_bit_identical(plain, traced)

    def test_cached_encode_skips_encode_children(self):
        ds = make_ds(seed=6)
        aggregate(ds)
        with cpu_profile() as prof:
            aggregate(ds)
        ranges = by_name(program_ranges(prof))
        assert "engine.encode" in ranges
        assert not set(ENCODE_SPANS) & set(ranges)
        assert "engine.put" in ranges


def sweep(seed=3):
    rng = np.random.default_rng(seed)
    n = 2_000
    ds = pdt.ArrayDataset(rng.integers(0, 200, n), rng.integers(0, 20, n),
                          rng.uniform(0, 5, n))
    opts = analysis.UtilityAnalysisOptions(
        epsilon=1.0, delta=1e-6,
        aggregate_params=pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT],
            max_partitions_contributed=2,
            max_contributions_per_partition=1),
        multi_param_configuration=analysis.MultiParameterConfiguration(
            max_partitions_contributed=[1, 2, 3, 4],
            max_contributions_per_partition=[1, 1, 2, 2]))
    out = analysis.perform_utility_analysis(
        ds, pdt.TorchBackend(device="cpu"), opts, pdt.DataExtractors())
    return list(out)[0]


class TestSweepSpans:

    @pytest.fixture(scope="class")
    def traced_sweep(self):
        obs.reset()
        plain = sweep()
        with cpu_profile() as prof:
            traced = sweep()
        return plain, traced, by_name(program_ranges(prof))

    @pytest.mark.parametrize("name", SWEEP_SPANS)
    def test_span_present(self, traced_sweep, name):
        _, _, ranges = traced_sweep
        assert ranges.get(name)

    def test_spans_in_order(self, traced_sweep):
        _, _, ranges = traced_sweep
        firsts = [ranges[n][0] for n in SWEEP_SPANS]
        for a, b in zip(firsts, firsts[1:]):
            assert a.end <= b.start

    def test_encode_children_under_sweep_encode(self, traced_sweep):
        _, _, ranges = traced_sweep
        (enc,) = ranges["sweep.encode"]
        for child in ENCODE_SPANS:
            (r,) = ranges[child]
            assert enc.holds(r)

    def test_results_unchanged(self, traced_sweep):
        plain, traced, _ = traced_sweep
        assert repr(plain) == repr(traced)

    def test_heartbeat_sweep_section_has_no_rate(self, monkeypatch):
        seen = []
        monkeypatch.setattr(obs.monitor, "update_sweep",
                            lambda snap: seen.append(snap))
        sweep()
        sections = [s for s in seen if s is not None]
        assert sections
        for s in sections:
            assert "configs_per_s" not in s
            assert s["configs_done"] == s["chunk"] * s["config_batch"]
