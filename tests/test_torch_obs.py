"""The port's observability plane (``pipelinedp_tpu_torch/obs``) on the CPU.

The cases of ``tests/test_obs.py`` that need no mesh and no serve, run on
``TorchBackend("cpu")``: the tracer core, the no-op mode, the tracer's
thread safety under a live overlapped stream, release parity with each
plane on and off, the Chrome-trace export, the run report and the
environment fingerprint (the port's: torch, CUDA, no jax field), the
resilience events, and the source scan for raw ``perf_counter`` timing.

The cross-package cases run the same seed-made dataset, params and
``rng_seed`` through both packages with audit on and hold the port's
audit records and counters to the JAX package's field for field. One case
holds the release bit for bit with every plane on against every plane
off.
"""

import json
import os
import threading

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu import obs as jobs
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert, obs
from pipelinedp_tpu_torch.obs import report as obs_report
from pipelinedp_tpu_torch.obs import store as obs_store
from pipelinedp_tpu_torch.obs.tracer import RunLedger, Span
from pipelinedp_tpu_torch.resilience import (CheckpointStore, FaultPlan,
                                             RetriesExhausted, RetryPolicy,
                                             call_with_retry,
                                             injected_faults)
from pipelinedp_tpu_torch.resilience.checkpoint import (CheckpointMismatch,
                                                        StreamCheckpoint)
from pipelinedp_tpu_torch.resilience.clock import FakeClock
from pipelinedp_tpu_torch.resilience.faults import ChunkFailure, check_chunk

BIG_EPS = 1e12
PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pipelinedp_tpu_torch")
PLANE_VARS = ("PIPELINEDP_TPU_TRACE", "PIPELINEDP_TPU_AUDIT",
              "PIPELINEDP_TPU_COSTS", "PIPELINEDP_TPU_HEARTBEAT",
              "PIPELINEDP_TPU_LEDGER_DIR", "PIPELINEDP_TPU_PLAN_DIR")


@pytest.fixture(autouse=True)
def fresh_ledger(monkeypatch):
    """Each test starts with empty ledgers in both packages, tiny stream
    chunks, and every plane off unless it opts in."""
    monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", "997")
    for var in PLANE_VARS:
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    jobs.reset()
    yield
    obs.monitor.stop()
    obs.reset()
    jobs.reset()


def run_streamed(ds, params, seed=0, eps=BIG_EPS, **backend):
    ds.invalidate_cache()
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-2)
    engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed,
                                                **backend))
    res = engine.aggregate(ds, params, pdt.DataExtractors())
    acc.compute_budgets()
    got = dict(res)
    assert res.timings.get("stream_batches", 0) > 1, (
        "dataset did not stream — test is not covering the chunked path")
    return got, res.timings


def make_ds(seed=1, n=9_000, users=2_000, parts=12):
    rng = np.random.default_rng(seed)
    return pdt.ArrayDataset(privacy_ids=rng.integers(0, users, n),
                            partition_keys=rng.integers(0, parts, n),
                            values=rng.uniform(0.0, 10.0, n)), parts


def count_params(parts):
    return pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM, pdt.Metrics.MEAN],
        max_partitions_contributed=parts,
        max_contributions_per_partition=50,
        min_value=0.0, max_value=10.0)


def assert_bit_identical(a, b):
    assert set(a) == set(b)
    for k in a:
        ta, tb = a[k], b[k]
        assert ta._fields == tb._fields
        for f in ta._fields:
            assert (np.asarray(getattr(ta, f)).tobytes() ==
                    np.asarray(getattr(tb, f)).tobytes()), (k, f)


class TestTracerCore:
    """The span substrate: totals, durations, ledger recording, driven by
    the injectable FakeClock (zero wall time)."""

    def test_totals_and_duration_from_fake_clock(self):
        clock = FakeClock()
        tr = obs.Tracer(clock=clock)
        with tr.span("outer", cat="t") as outer:
            clock.sleep(2.0)
            with tr.span("inner", cat="t"):
                clock.sleep(0.5)
        assert outer.duration == pytest.approx(2.5)
        assert tr.total("outer") == pytest.approx(2.5)
        assert tr.total("inner") == pytest.approx(0.5)
        assert tr.count("outer") == 1
        with tr.span("inner"):
            clock.sleep(1.0)
        assert tr.total("inner") == pytest.approx(1.5)
        assert tr.count("inner") == 2

    def test_ledger_records_spans_with_thread_identity(self):
        led = RunLedger()
        tr = obs.Tracer(clock=FakeClock(), ledger=led)
        with tr.span("a", cat="t", batch=3):
            pass
        snap = led.snapshot()
        assert len(snap["spans"]) == 1
        s = snap["spans"][0]
        assert s.name == "a" and s.cat == "t"
        assert s.args == {"batch": 3}
        assert s.tid == threading.current_thread().ident
        assert s.thread == threading.current_thread().name

    def test_span_cap_counts_drops(self):
        led = RunLedger()
        led.spans = [None] * obs.MAX_SPANS  # simulate a full ledger
        tr = obs.Tracer(clock=FakeClock(), ledger=led)
        with tr.span("over"):
            pass
        assert led.dropped_spans == 1
        assert len(led.spans) == obs.MAX_SPANS


class TestNoopMode:
    """PIPELINEDP_TPU_TRACE unset: the global tracer emits nothing and adds
    no attributes to hot objects."""

    def test_global_tracer_is_shared_noop(self):
        t = obs.tracer()
        assert t is obs.NOOP_TRACER
        assert t.span("x", batch=1) is obs.NOOP_SPAN
        assert t.span("y") is obs.NOOP_SPAN
        with t.span("z") as sp:
            assert sp.duration == 0.0
        assert not hasattr(obs.NOOP_SPAN, "__dict__")
        assert not hasattr(obs.NOOP_TRACER, "__dict__")
        assert obs.span("k") is obs.NOOP_SPAN

    def test_streamed_run_emits_no_spans(self):
        ds, parts = make_ds(seed=3)
        run_streamed(ds, count_params(parts), seed=11)
        snap = obs.ledger().snapshot()
        assert snap["spans"] == [], (
            "no-op mode leaked spans into the ledger")

    def test_run_tracer_still_measures(self):
        clock = FakeClock()
        tr = obs.run_tracer(clock=clock)
        assert not tr.recording
        with tr.span("phase"):
            clock.sleep(1.25)
        assert tr.total("phase") == pytest.approx(1.25)
        assert obs.ledger().snapshot()["spans"] == []


class TestLiveExecutorThreadSafety:
    """Tracing on under a live stager + fold-worker stream: spans arrive
    from three threads concurrently; none may be dropped or corrupt."""

    def test_spans_complete_and_well_formed(self, monkeypatch):
        monkeypatch.setenv(obs.ENV_VAR, "1")
        monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "1")
        ds, parts = make_ds(seed=5, n=9_000)
        _, timings = run_streamed(ds, count_params(parts), seed=7)
        assert timings["stream_executor"] == "overlapped"
        n_batches = timings["stream_batches"]
        snap = obs.ledger().snapshot()
        by_name = {}
        for s in snap["spans"]:
            assert isinstance(s, Span)
            assert isinstance(s.name, str) and s.name
            assert isinstance(s.ts, float)
            assert isinstance(s.dur, float) and s.dur >= 0.0
            assert isinstance(s.tid, int)
            by_name.setdefault(s.name, []).append(s)
        assert snap["dropped_spans"] == 0
        for name in ("ingest.stage", "ingest.fetch", "ingest.fold"):
            batches = sorted(s.args["batch"] for s in by_name[name])
            assert batches == list(range(n_batches)), (
                f"{name}: expected one span per batch, got {batches}")
        assert len(by_name["ingest.pass_a"]) == 1
        tids = {s.tid for s in snap["spans"]}
        assert len(tids) >= 3, (
            "expected spans from stager + fold + dispatch threads")
        stage_tids = {s.tid for s in by_name["ingest.stage"]}
        fold_tids = {s.tid for s in by_name["ingest.fold"]}
        assert stage_tids.isdisjoint(fold_tids)

    def test_percentile_pass_b_spans(self, monkeypatch):
        monkeypatch.setenv(obs.ENV_VAR, "1")
        rng = np.random.default_rng(30)
        n = 6_000
        ds = pdt.ArrayDataset(privacy_ids=rng.integers(0, 1_500, n),
                              partition_keys=rng.integers(0, 4, n),
                              values=rng.uniform(0, 10, n))
        params = pdt.AggregateParams(
            metrics=[pdt.Metrics.PERCENTILE(50),
                     pdt.Metrics.PERCENTILE(90)],
            max_partitions_contributed=4,
            max_contributions_per_partition=50,
            min_value=0.0, max_value=10.0)
        run_streamed(ds, params, seed=3)
        names = {s.name for s in obs.ledger().snapshot()["spans"]}
        assert {"walk.top", "walk.bottom", "ingest.pass_b_sweep",
                "ingest.stage", "ingest.fetch", "ingest.fold",
                "ingest.pass_a", "ingest.select"} <= names


class TestParity:
    """Each plane changes only the record: released values bit-identical,
    every timing field present either way."""

    TIMING_KEYS = ("host_encode_s", "device_s", "host_decode_s",
                   "stream_batches", "stream_stage_s",
                   "stream_fold_wait_s", "stream_t_stage",
                   "stream_t_fold", "stream_t_device", "stream_t_total",
                   "stream_overlap_frac", "stream_executor")

    def test_outputs_bit_identical_and_fields_stable(self, monkeypatch):
        ds, parts = make_ds(seed=9)
        params = count_params(parts)
        results, timings = {}, {}
        for mode in ("off", "on"):
            obs.reset()
            if mode == "on":
                monkeypatch.setenv(obs.ENV_VAR, "1")
            else:
                monkeypatch.delenv(obs.ENV_VAR, raising=False)
            results[mode], timings[mode] = run_streamed(ds, params,
                                                        seed=17)
        assert_bit_identical(results["off"], results["on"])
        for mode in ("off", "on"):
            for key in self.TIMING_KEYS:
                assert key in timings[mode], (mode, key)
            assert timings[mode]["stream_t_total"] > 0.0
            busy = (timings[mode]["stream_t_stage"] +
                    timings[mode]["stream_t_fold"] +
                    timings[mode]["stream_t_device"])
            assert busy > 0.0

    def test_audit_on_off_outputs_bit_identical(self, monkeypatch):
        ds, parts = make_ds(seed=23)
        params = count_params(parts)
        results, reports = {}, {}
        for mode in ("off", "on"):
            obs.reset()
            if mode == "off":
                monkeypatch.setenv(obs.audit.ENV_VAR, "0")
            else:
                monkeypatch.delenv(obs.audit.ENV_VAR, raising=False)
            results[mode], _ = run_streamed(ds, params, seed=29)
            reports[mode] = obs.build_run_report()
        assert_bit_identical(results["off"], results["on"])
        priv_on = reports["on"]["privacy"]
        assert priv_on["enabled"] is True
        assert priv_on["accountants"], "no accountant audit captured"
        mech = {m["metric"] for a in priv_on["accountants"]
                for m in a["mechanisms"]}
        assert "partition_selection" in mech
        assert priv_on["partition_selection"]["partitions_pre"] > 0
        assert priv_on["aggregations"][0]["method"] == "aggregate"
        assert priv_on["expected_errors"], "no expected errors captured"
        priv_off = reports["off"]["privacy"]
        assert priv_off["enabled"] is False
        assert priv_off["accountants"] == []
        assert priv_off["partition_selection"]["partitions_pre"] == 0

    def test_costs_on_off_outputs_bit_identical(self, monkeypatch):
        """PARITY row 31 on the port: ``PIPELINEDP_TPU_COSTS`` changes only
        the record. Off, no entry lands; on, every device phase of the
        stream and the K1 launches inside it have entries, and a repeat
        run at the same shapes adds calls, not programs."""
        ds, parts = make_ds(seed=41)
        params = count_params(parts)
        results, reports = {}, {}
        for mode in ("off", "on"):
            obs.reset()
            if mode == "on":
                monkeypatch.setenv(obs.costs.ENV_VAR, "1")
            else:
                monkeypatch.delenv(obs.costs.ENV_VAR, raising=False)
            results[mode], _ = run_streamed(ds, params, seed=37)
            reports[mode] = obs.build_run_report()
        assert_bit_identical(results["off"], results["on"])
        assert "device_costs" not in reports["off"]
        dc = reports["on"]["device_costs"]
        assert {"pass_a", "select"} <= set(dc["phases"])
        k1 = [e for e in dc["programs"].values()
              if e["program"] == "segment_sum_lanes"]
        # Booked under the phase that launched them: pass A's reductions.
        assert k1 and all(e["kernel"] and e["phase"] == "pass_a" and
                          e["flops"] > 0 and e["bytes_accessed"] > 0
                          for e in k1)
        assert all(e["verdict"] == "bandwidth_bound" for e in k1)
        for entry in dc["programs"].values():
            assert entry["timer"] == "host_clock"
            assert entry["calls"] >= 1 and entry["ms"] >= 0.0
        n1 = obs.ledger().snapshot()["counters"]["cost.programs_captured"]
        calls1 = sum(e["calls"] for e in dc["programs"].values())
        again, _ = run_streamed(ds, params, seed=37)
        assert_bit_identical(results["on"], again)
        n2 = obs.ledger().snapshot()["counters"]["cost.programs_captured"]
        assert n2 == n1, "a repeat run at the same shapes added programs"
        calls2 = sum(e["calls"] for e in
                     obs.costs.TABLE.snapshot()["programs"].values())
        assert calls2 == 2 * calls1


class TestChromeTrace:
    """Export round-trip: valid JSON, valid ph/ts/dur, thread lanes."""

    def _ledger_with_spans(self):
        led = RunLedger(clock=FakeClock())
        clock = FakeClock(10.0)
        tr = obs.Tracer(clock=clock, ledger=led)

        def worker():
            with tr.span("w", cat="test", batch=1):
                clock.sleep(0.25)

        t = threading.Thread(target=worker, name="obs-test-worker")
        with tr.span("main", cat="test"):
            t.start()
            t.join()
            clock.sleep(0.5)
        led.event("marker", detail="hello")
        return led

    def test_round_trip(self, tmp_path):
        led = self._ledger_with_spans()
        path = str(tmp_path / "trace.json")
        obs_report.write_chrome_trace(path, led.snapshot())
        with open(path, encoding="utf-8") as f:
            payload = json.loads(f.read())
        events = payload["traceEvents"]
        xs = [e for e in events if e["ph"] == "X"]
        assert {e["name"] for e in xs} == {"w", "main"}
        for e in xs:
            assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
            assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
            assert isinstance(e["tid"], int)
            assert e["pid"] == os.getpid()
        w = next(e for e in xs if e["name"] == "w")
        assert w["dur"] == pytest.approx(0.25e6)
        assert w["args"]["batch"] == 1
        instants = [e for e in events if e["ph"] == "i"]
        assert any(e["name"] == "marker" for e in instants)
        metas = [e for e in events if e["ph"] == "M"]
        assert {m["args"]["name"] for m in metas} >= {"obs-test-worker"}

    def test_global_export_path(self, tmp_path, monkeypatch):
        monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "t.json"))
        with obs.tracer().span("one", cat="test"):
            pass
        out = obs.write_chrome_trace()
        assert out == str(tmp_path / "t.json")
        with open(out, encoding="utf-8") as f:
            payload = json.load(f)
        assert any(e["name"] == "one" for e in payload["traceEvents"])


class TestRunReport:
    """Schema version, environment fingerprint, counters, summaries."""

    def test_schema_version_and_sections(self, monkeypatch):
        monkeypatch.setenv(obs.ENV_VAR, "1")
        with obs.tracer().span("phase", cat="test"):
            pass
        obs.inc("retry.attempts", 2)
        obs.event("health.degraded", target="cpu_platform")
        report = obs.build_run_report(extra={"note": "t"})
        assert report["schema_version"] == obs.SCHEMA_VERSION == 6
        assert obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
        assert report["counters"]["retry.attempts"] == 2
        assert report["spans"]["phase"]["count"] == 1
        assert any(e["name"] == "health.degraded"
                   for e in report["events"])
        assert report["note"] == "t"
        assert report["dropped"] == {"spans": 0, "events": 0,
                                     "samples": 0}
        assert "device_costs" not in report
        priv = report["privacy"]
        assert priv["enabled"] is True
        assert set(priv) >= {"accountants", "aggregations",
                             "expected_errors", "partition_selection"}

    def test_environment_fingerprint(self, monkeypatch):
        """The port's fingerprint: torch and CUDA versions, the device,
        the process count; no jax field, so its key never equals a JAX
        run's and ``last_known_good`` never hands one to the other."""
        import torch
        monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", "4242")
        fp = obs.environment_fingerprint()
        assert fp["torch_version"] == torch.__version__
        assert fp["cuda_version"] == torch.version.cuda
        assert fp["platform"] == "cpu" and fp["device_kind"] == "cpu"
        assert fp["device_count"] == 1 and fp["process_count"] == 1
        assert not any(k.startswith("jax") for k in fp)
        assert fp["flags"]["PIPELINEDP_TPU_STREAM_CHUNK"] == "4242"
        assert fp["degraded"] is False
        assert fp["git_sha"] is None or len(fp["git_sha"]) >= 40
        assert set(obs_store.FINGERPRINT_FIELDS) >= {
            "torch_version", "cuda_version", "device_kind", "power_limit"}
        jfp = jobs.environment_fingerprint()
        assert (obs_store.fingerprint_key(fp) !=
                obs_store.fingerprint_key(jfp))


class TestResilienceEvents:
    """The resilience branches land in the ledger."""

    def test_retry_attempts_with_backoff_delays(self):
        policy = RetryPolicy(max_attempts=3, base_delay_s=1.0,
                             multiplier=2.0, max_delay_s=30.0,
                             jitter=0.1, seed=4)
        clock = FakeClock()

        def always_fails():
            raise ValueError("boom")

        with pytest.raises(RetriesExhausted):
            call_with_retry(always_fails, policy, clock, label="test.op")
        snap = obs.ledger().snapshot()
        attempts = [e for e in snap["events"]
                    if e["name"] == "retry.attempt"]
        assert [e["attempt"] for e in attempts] == [0, 1]
        assert all(e["label"] == "test.op" for e in attempts)
        assert [e["delay_s"] for e in attempts] == (
            pytest.approx(policy.delays()))
        assert snap["counters"]["retry.attempts"] == 2
        exhausted = [e for e in snap["events"]
                     if e["name"] == "retry.exhausted"]
        assert len(exhausted) == 1 and "boom" in exhausted[0]["error"]

    def test_checkpoint_resume_and_mismatch_events(self, tmp_path):
        store = CheckpointStore(str(tmp_path / "s.ckpt"))
        store.save(StreamCheckpoint("fp_a", 3, {"acc:count": np.arange(4)}))
        assert store.load_for("fp_a").next_batch == 3
        with pytest.raises(CheckpointMismatch):
            store.load_for("fp_b")
        snap = obs.ledger().snapshot()
        assert snap["counters"]["checkpoint.saves"] == 1
        assert snap["counters"]["checkpoint.resumes"] == 1
        assert snap["counters"]["checkpoint.mismatch_refusals"] == 1
        refusal = next(e for e in snap["events"]
                       if e["name"] == "checkpoint.mismatch_refusal")
        assert refusal["expected"] == "fp_b"[:16]

    def test_fault_injection_event(self):
        with injected_faults(FaultPlan(fail_chunks=(2,))):
            check_chunk(0)
            with pytest.raises(ChunkFailure):
                check_chunk(2)
        ev = next(e for e in obs.ledger().snapshot()["events"]
                  if e["name"] == "fault.injected")
        assert ev["kind"] == "chunk_failure" and ev["index"] == 2


class TestNoRawPerfCounter:
    """Raw ``time.perf_counter`` phase timing (a call, a reference or an
    import of the name) stays under ``obs/`` (the monitor included: its
    deadlines ride the injectable clock), so every measured phase lands in
    the run ledger. The port's lint (``noperf``) makes the scan."""

    def test_no_perf_counter_outside_obs(self):
        from pipelinedp_tpu_torch import lint
        repo = os.path.dirname(PORT_DIR)
        result = lint.run(root=repo, rule_ids=["noperf"])
        assert result.files_scanned > 50
        assert [f.format() for f in result.findings] == []
        assert result.suppressed == []
        # The scope: every module but obs/'s, the monitor included.
        src = "import time\nT = time.perf_counter()\n"
        for rel, found in (("obs/costs.py", False), ("obs/monitor.py", True),
                           ("resilience/chaos.py", True)):
            result = lint.lint_source(src, "pipelinedp_tpu_torch/" + rel,
                                      [lint.rules.get("noperf")])
            assert bool(result.findings) == found, rel


# ---------------------------------------------------------------------------
# Cross-package: the same inputs through both packages, audit on
# ---------------------------------------------------------------------------


def _cross_data(seed=61, n=9_000, users=2_000, parts=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, users, n),
            (rng.zipf(1.4, n) % parts).astype(np.int64),
            rng.uniform(0.0, 10.0, n))


def _cross_params(percentiles=False):
    M = pdp.Metrics
    metrics = ([M.COUNT, M.PRIVACY_ID_COUNT, M.PERCENTILE(50)]
               if percentiles else
               [M.COUNT, M.PRIVACY_ID_COUNT, M.SUM, M.MEAN])
    return pdp.AggregateParams(
        metrics=metrics, noise_kind=pdp.NoiseKind.LAPLACE,
        max_partitions_contributed=4, max_contributions_per_partition=3,
        min_value=0.0, max_value=10.0)


def _both(cols, params, seed, stream_chunk=None, checkpoint=None,
          monkeypatch=None):
    """One aggregation per package from fresh ledgers: (jax release, jax
    report, port release, port report). The JAX stream runs serially, the
    port's stream too, so their counters are the same loop's."""
    pid, pk, values = cols
    if stream_chunk is not None:
        monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", str(stream_chunk))
    monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
    out = []
    jobs.reset()
    acc = pdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    jres = pdp.DPEngine(acc, JaxBackend(
        rng_seed=seed, checkpoint=checkpoint and checkpoint + ".jax")
    ).aggregate(pdp.ArrayDataset(pid, pk, values), params,
                pdp.DataExtractors())
    acc.compute_budgets()
    out += [dict(jres), jobs.build_run_report()]
    obs.reset()
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    tres = pdt.DPEngine(acc, pdt.TorchBackend(
        "cpu", rng_seed=seed, checkpoint=checkpoint and checkpoint + ".pt")
    ).aggregate(convert.dataset_from_arrays(pid, pk, values),
                convert.params_from_reference(params), pdt.DataExtractors())
    acc.compute_budgets()
    out += [dict(tres), obs.build_run_report()]
    return out


def _same_release(jrel, trel):
    assert list(jrel) == list(trel)
    for k in jrel:
        for a, b in zip(jrel[k], trel[k]):
            assert np.float64(a).tobytes() == np.float64(b).tobytes()


def _audit_view(privacy):
    """The audit records, with the backend's class name (JaxBackend or
    TorchBackend) left out."""
    aggs = [{k: v for k, v in a.items() if k != "backend"}
            for a in privacy["aggregations"]]
    return {"accountants": privacy["accountants"], "aggregations": aggs,
            "expected_errors": privacy["expected_errors"],
            "partition_selection": privacy["partition_selection"],
            "enabled": privacy["enabled"]}


class TestCrossPackageAudit:
    """The port's audit records equal the JAX package's field for field:
    eps/delta splits and noise stds, the aggregation's shape, selection
    counts and expected errors."""

    @pytest.mark.parametrize("stream_chunk", [None, 997])
    def test_audit_records_equal(self, stream_chunk, monkeypatch):
        jrel, jrep, trel, trep = _both(_cross_data(), _cross_params(), 5,
                                       stream_chunk,
                                       monkeypatch=monkeypatch)
        _same_release(jrel, trel)
        jp, tp = _audit_view(jrep["privacy"]), _audit_view(trep["privacy"])
        assert tp == jp
        assert tp["accountants"] and tp["expected_errors"]
        assert tp["partition_selection"]["partitions_post"] == len(trel)
        for name in ("selection.partitions_pre",
                     "selection.partitions_post"):
            assert trep["counters"][name] == jrep["counters"][name]
        jsel = [e for e in jrep["events"] if e["name"] ==
                "selection.applied"]
        tsel = [e for e in trep["events"] if e["name"] ==
                "selection.applied"]
        strip = ("ts",)
        assert ([{k: v for k, v in e.items() if k not in strip}
                 for e in tsel] ==
                [{k: v for k, v in e.items() if k not in strip}
                 for e in jsel])

    def test_pld_accountant_record_equal(self):
        """PLDBudgetAccountant's audit record (its books and the granted
        noise stds) equals the JAX package's."""
        for mod in (pdp, pdt):
            acc = mod.PLDBudgetAccountant(total_epsilon=1.0,
                                          total_delta=1e-6)
            acc.request_budget(mod.MechanismType.GAUSSIAN, sensitivity=2.0,
                               metric="sum")
            acc.request_budget(mod.MechanismType.LAPLACE, metric="count")
            acc.compute_budgets()
        jrec = jobs.audit.build_privacy_section()["accountants"]
        trec = obs.audit.build_privacy_section()["accountants"]
        assert trec == jrec and len(trec) == 1
        assert trec[0]["accountant"] == "PLDBudgetAccountant"
        assert all(m["noise_standard_deviation"] is not None
                   for m in trec[0]["mechanisms"])


class TestCrossPackageCounters:
    """The same counters on the same path: the checkpoint's and the
    stream's pass B."""

    def test_checkpoint_counters_equal(self, tmp_path, monkeypatch):
        """Each package: a stream killed at batch 4, then its resume from
        the checkpoint; the same checkpoint, fault and progress
        counters."""
        from pipelinedp_tpu import resilience as jres_mod
        from pipelinedp_tpu_torch import resilience as tres_mod
        pid, pk, values = _cross_data(seed=3)
        params = _cross_params()
        base = str(tmp_path / "ck")
        monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", "997")
        monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
        counters = {}
        for name, mod, o, make in (
                ("jax", jres_mod, jobs,
                 lambda: (pdp, JaxBackend(rng_seed=9,
                                          checkpoint=base + ".jax"),
                          pdp.ArrayDataset(pid, pk, values), params)),
                ("port", tres_mod, obs,
                 lambda: (pdt, pdt.TorchBackend("cpu", rng_seed=9,
                                                checkpoint=base + ".pt"),
                          convert.dataset_from_arrays(pid, pk, values),
                          convert.params_from_reference(params)))):
            o.reset()
            for kill in (True, False):
                pkg, backend, ds, p = make()
                acc = pkg.NaiveBudgetAccountant(total_epsilon=1.0,
                                                total_delta=1e-6)
                res = pkg.DPEngine(acc, backend).aggregate(
                    ds, p, pkg.DataExtractors())
                acc.compute_budgets()
                if kill:
                    with mod.injected_faults(mod.FaultPlan(
                            fail_chunks=(4,))):
                        with pytest.raises(mod.ChunkFailure):
                            list(res)
                else:
                    list(res)
            c = o.ledger().snapshot()["counters"]
            counters[name] = {k: c.get(k, 0) for k in (
                "checkpoint.saves", "checkpoint.resumes",
                "checkpoint.mismatch_refusals", "faults.injected",
                "ingest.streamed_runs", "ingest.rows_ingested",
                "progress.batches_planned", "progress.batches_staged",
                "progress.rows_staged")}
        assert counters["port"] == counters["jax"]
        assert counters["port"]["checkpoint.resumes"] == 1
        assert counters["port"]["checkpoint.saves"] > 4

    @pytest.mark.parametrize("cache", [None, 0])
    def test_pass_b_counters_equal(self, cache, monkeypatch):
        if cache is not None:
            monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CACHE", str(cache))
        jrel, jrep, trel, trep = _both(_cross_data(seed=8),
                                       _cross_params(percentiles=True), 13,
                                       997, monkeypatch=monkeypatch)
        _same_release(jrel, trel)
        names = ("stream.pass_b_stream_sweeps", "stream.pass_b_tiles",
                 "stream.pass_b_cache_hit_batches",
                 "stream.pass_b_reship_rounds", "progress.sweeps_planned",
                 "ingest.streamed_runs", "ingest.executor_serial")
        jc = {k: jrep["counters"].get(k, 0) for k in names}
        tc = {k: trep["counters"].get(k, 0) for k in names}
        assert tc == jc
        assert tc["stream.pass_b_stream_sweeps"] >= 1
        reship = trep["counters"].get("stream.pass_b_reshipped_bytes", 0)
        assert (reship > 0) == (cache == 0)


class TestAllPlanesBitParity:
    """The release is bit for bit the same with every plane on (trace,
    audit, costs, heartbeat, a plan file) as with every plane off, single
    batch and streamed."""

    @pytest.mark.parametrize("stream_chunk", [None, 997])
    def test_every_plane_on_equals_every_plane_off(self, stream_chunk,
                                                   tmp_path, monkeypatch):
        from pipelinedp_tpu_torch import plan as tplan
        if stream_chunk is None:
            monkeypatch.delenv("PIPELINEDP_TPU_STREAM_CHUNK")
        pid, pk, values = _cross_data(seed=17)
        params = convert.params_from_reference(
            _cross_params(percentiles=True))

        def run():
            acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            res = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=21)
                               ).aggregate(
                convert.dataset_from_arrays(pid, pk, values), params,
                pdt.DataExtractors())
            acc.compute_budgets()
            return dict(res)

        monkeypatch.setenv(obs.audit.ENV_VAR, "0")
        off = run()
        obs.reset()
        monkeypatch.delenv(obs.audit.ENV_VAR)
        monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "trace.json"))
        monkeypatch.setenv(obs.costs.ENV_VAR, "1")
        monkeypatch.setenv("PIPELINEDP_TPU_HEARTBEAT",
                           str(tmp_path / "hb.json"))
        monkeypatch.setenv(obs.store.ENV_VAR, str(tmp_path / "ledger"))
        monkeypatch.setenv(tplan.planner.ENV_DIR, str(tmp_path / "plan"))
        tplan.write_plan(tplan.build_plan(
            {"default": {"knobs": {"ingest_executor": False,
                                   "stream_cache_bytes": 0,
                                   "q_chunk": 1}}},
            tplan.CostModel(), "cpu", created_by="test"))
        on = run()
        assert_bit_identical(off, on)
        report = obs.build_run_report()
        assert report["device_costs"]["programs"]
        applied = report["plan"]["knobs"]
        assert applied["q_chunk"] == {"value": 1, "source": "plan"}
        assert obs.store.LedgerStore(str(tmp_path / "ledger")).entries()
        assert obs.monitor.active_monitor() is not None


class TestCrossPackageSelectPartitions:
    """``select_partitions`` leaves the JAX package's audit: the
    aggregation record, the accountant and the selection counters."""

    @pytest.mark.parametrize("stream_chunk", [None, 997])
    def test_select_partitions_audit_equal(self, stream_chunk,
                                           monkeypatch):
        if stream_chunk is None:
            monkeypatch.delenv("PIPELINEDP_TPU_STREAM_CHUNK")
        monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
        pid, pk, values = _cross_data(seed=29)
        reports, kept = [], []
        for pkg, o, backend, ds in (
                (pdp, jobs, JaxBackend(rng_seed=3),
                 pdp.ArrayDataset(pid, pk, values)),
                (pdt, obs, pdt.TorchBackend("cpu", rng_seed=3),
                 convert.dataset_from_arrays(pid, pk, values))):
            o.reset()
            acc = pkg.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            res = pkg.DPEngine(acc, backend).select_partitions(
                ds, pkg.SelectPartitionsParams(max_partitions_contributed=3),
                pkg.DataExtractors())
            acc.compute_budgets()
            kept.append(list(res))
            reports.append(o.build_run_report())
        assert kept[1] == kept[0] and kept[1]
        jp, tp = (_audit_view(r["privacy"]) for r in reports)
        assert tp == jp
        assert tp["aggregations"][0]["method"] == "select_partitions"
