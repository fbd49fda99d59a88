"""The port's live monitor (``pipelinedp_tpu_torch/obs/monitor.py``) on
the CPU: the cases of ``tests/test_monitor.py`` that need no mesh, no
serve, no health probe and no ``bench.py``. The heartbeat file (atomic
replacement, progress, phase, rate, active spans, the pace verdict against
the store's baseline), the stall watchdog on a FakeClock with its flight
record and pluggable action, release parity with the heartbeat on and off,
the store's analytics and CLI, the Chrome trace's thread names, and the
monitor's clock discipline.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.obs import monitor as obs_monitor
from pipelinedp_tpu_torch.obs import store as obs_store
from pipelinedp_tpu_torch.obs.tracer import ACTIVITY, FLIGHT_RING_SPANS
from pipelinedp_tpu_torch.resilience.clock import FakeClock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG_EPS = 1e12

ENV_A = {"torch_version": "2.x", "platform": "cpu", "device_kind": "cpu",
         "device_count": 1, "process_count": 1, "git_sha": "aaa"}


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    """Fresh ledger/activity registry, isolated store dir, heartbeat
    OFF unless a test opts in — and a guaranteed monitor stop so no
    test leaks an armed registry or a pdp-monitor thread."""
    monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", "997")
    monkeypatch.delenv(obs_monitor.ENV_VAR, raising=False)
    monkeypatch.setenv(obs_store.ENV_VAR, str(tmp_path / "ledger"))
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    obs.reset()
    yield
    obs_monitor.stop()
    ACTIVITY.reset(enabled=False)
    obs.reset()


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


def run_streamed(ds, params, seed=0):
    ds.invalidate_cache()
    acc = pdt.NaiveBudgetAccountant(total_epsilon=BIG_EPS, total_delta=1e-2)
    engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed))
    res = engine.aggregate(ds, params, pdt.DataExtractors())
    acc.compute_budgets()
    got = dict(res)
    assert res.timings.get("stream_batches", 0) > 1
    return got


def inline_monitor(tmp_path, clk, **kw):
    kw.setdefault("stall_s", 30.0)
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("heartbeat_path", str(tmp_path / "heartbeat.json"))
    kw.setdefault("run_name", "t")
    return obs_monitor.Monitor(clock=clk, **kw).start_inline()


def wait_activity_quiesce(timeout_s=30.0, stable_beats=3):
    """Wait (real time, short beats) until no span opens/closes — the
    held pipeline has fully backed up and only virtual time remains."""
    gate = threading.Event()
    deadline = time.monotonic() + timeout_s
    last, stable = -1, 0
    while time.monotonic() < deadline:
        cur = ACTIVITY.seq
        if cur == last:
            stable += 1
            if stable >= stable_beats:
                return
        else:
            last, stable = cur, 0
        gate.wait(0.05)
    raise AssertionError("pipeline activity never quiesced")


class TestHeartbeat:
    def test_atomic_replace_under_concurrent_reader(self, tmp_path):
        """A reader polling the heartbeat while the monitor rewrites it
        never observes a torn file: every read either hits the previous
        beat or the new one, always valid JSON."""
        clk = FakeClock()
        mon = inline_monitor(tmp_path, clk)
        mon.poll_once()  # the file exists before the reader starts
        done = threading.Event()
        errors = []

        def writer():
            try:
                for _ in range(300):
                    clk.sleep(1.0)
                    mon.poll_once()
            except BaseException as e:  # surfaced by the main thread
                errors.append(e)
            finally:
                done.set()

        t = threading.Thread(target=writer)
        t.start()
        reads = 0
        beats = set()
        while not done.is_set() or reads == 0:
            with open(mon.heartbeat_path, encoding="utf-8") as f:
                hb = json.loads(f.read())  # a torn write would raise
            assert hb["run"] == "t"
            beats.add(hb["beat"])
            reads += 1
        t.join()
        assert not errors, errors
        assert reads > 0 and len(beats) >= 1
        mon.stop()

    def test_progress_phase_rate_and_active_spans(self, tmp_path):
        clk = FakeClock()
        mon = inline_monitor(tmp_path, clk)
        obs.inc("progress.batches_staged", 3)
        obs.inc("progress.batches_planned", 10)
        obs.inc("stream.pass_b_stream_sweeps", 1)
        obs.inc("progress.sweeps_planned", 4)
        obs.inc("progress.rows_staged", 5_000)
        obs.inc("ingest.rows_ingested", 20_000)
        tr = obs.tracer()  # measuring tracer: the monitor is armed
        span = tr.span("ingest.pass_a", cat="ingest")
        span.__enter__()
        clk.sleep(2.0)
        hb = mon.poll_once()
        assert hb["phase"] == "ingest.pass_a"
        assert hb["progress"] == {
            "batches_done": 3, "batches_planned": 10,
            "sweeps_done": 1, "sweeps_planned": 4,
            "rows_done": 5_000, "rows_planned": 20_000,
            "rows_per_s": 2_500.0}
        (active,) = hb["active_spans"]
        assert active["name"] == "ingest.pass_a"
        assert active["age_s"] == pytest.approx(2.0)
        assert hb["stalled"] is False
        span.__exit__(None, None, None)
        mon.stop()

    def test_pace_verdict_vs_baseline(self, tmp_path):
        """With a same-fingerprint baseline run report in the store the
        heartbeat carries on-pace/behind + a projected ETA; a run at
        half the baseline rate is still on pace (slack), one far below
        is behind."""
        store = obs_store.LedgerStore(str(tmp_path / "ledger"))
        fp = obs_store.fingerprint_key(ENV_A)
        store.append("run_report", {
            "run_report": {
                "counters": {"progress.rows_staged": 10_000},
                "spans": {"ingest.pass_a": {"count": 1,
                                            "total_s": 10.0}}}},
            env=ENV_A)  # baseline: 1000 rows/s
        clk = FakeClock()
        mon = inline_monitor(tmp_path, clk, fingerprint=fp,
                             store_dir=str(tmp_path / "ledger"))
        obs.inc("progress.rows_staged", 1_600)
        obs.inc("ingest.rows_ingested", 20_000)
        clk.sleep(2.0)  # 800 rows/s >= 0.5 * 1000
        hb = mon.poll_once()
        assert hb["pace"]["verdict"] == "on_pace"
        assert hb["pace"]["baseline_rows_per_s"] == pytest.approx(1000.0)
        assert hb["pace"]["projected_eta_s"] == pytest.approx(
            (20_000 - 1_600) / 800.0, rel=1e-3)
        mon.stop()
        obs.reset()
        mon2 = inline_monitor(tmp_path, clk, fingerprint=fp,
                              store_dir=str(tmp_path / "ledger"))
        obs.inc("progress.rows_staged", 100)
        obs.inc("ingest.rows_ingested", 20_000)
        clk.sleep(10.0)  # 10 rows/s < 0.5 * 1000
        hb2 = mon2.poll_once()
        assert hb2["pace"]["verdict"] == "behind"
        mon2.stop()

    def test_pace_anchor_excludes_pre_ingest_wall(self, tmp_path):
        """A long pre-ingest prelude (the bench arms the monitor
        BEFORE the device probe and the cold compiles) must not dilute
        the pace verdict: the rate anchors at the first beat that saw
        staged rows, so a run at baseline speed reads on-pace even
        after a 60s silent prelude."""
        store = obs_store.LedgerStore(str(tmp_path / "ledger"))
        fp = obs_store.fingerprint_key(ENV_A)
        store.append("run_report", {
            "run_report": {
                "counters": {"progress.rows_staged": 10_000},
                "spans": {"ingest.pass_a": {"count": 1,
                                            "total_s": 10.0}}}},
            env=ENV_A)  # baseline: 1000 rows/s
        clk = FakeClock()
        mon = inline_monitor(tmp_path, clk, fingerprint=fp,
                             store_dir=str(tmp_path / "ledger"))
        clk.sleep(60.0)  # probe + compile: a minute of zero rows
        mon.poll_once()
        obs.inc("progress.rows_staged", 1_600)
        obs.inc("ingest.rows_ingested", 20_000)
        mon.poll_once()  # the anchor beat
        clk.sleep(2.0)
        obs.inc("progress.rows_staged", 1_600)
        hb = mon.poll_once()
        # 1600 rows over the 2s since the anchor — NOT 3200/64s.
        assert hb["progress"]["rows_per_s"] == pytest.approx(800.0)
        assert hb["pace"]["verdict"] == "on_pace"
        mon.stop()

    def test_degraded_baseline_never_paces(self, tmp_path):
        """A degraded capture can't set the pace bar (last_known_good
        discipline carries over to the live view)."""
        store = obs_store.LedgerStore(str(tmp_path / "ledger"))
        fp = obs_store.fingerprint_key(ENV_A)
        store.append("run_report", {
            "run_report": {"counters": {"progress.rows_staged": 10},
                           "spans": {"ingest.pass_a": {
                               "total_s": 10.0}}}},
            env=ENV_A, degraded=True)
        clk = FakeClock()
        mon = inline_monitor(tmp_path, clk, fingerprint=fp,
                             store_dir=str(tmp_path / "ledger"))
        obs.inc("progress.rows_staged", 100)
        clk.sleep(1.0)
        assert "pace" not in mon.poll_once()
        mon.stop()

    def test_off_is_zero_overhead(self):
        assert obs_monitor.maybe_start() is None
        assert not obs_monitor.heartbeat_enabled()
        assert ACTIVITY.enabled is False
        assert obs.tracer() is obs.NOOP_TRACER

    def test_maybe_start_global_lifecycle(self, tmp_path, monkeypatch):
        hb_path = str(tmp_path / "hb.json")
        monkeypatch.setenv(obs_monitor.ENV_VAR, hb_path)
        mon = obs_monitor.maybe_start(run_name="glob")
        assert mon is not None
        assert obs_monitor.maybe_start() is mon  # idempotent
        assert mon.heartbeat_path == hb_path
        assert ACTIVITY.enabled is True
        assert any(t.name == "pdp-monitor"
                   for t in threading.enumerate())
        obs_monitor.stop()
        assert obs_monitor.active_monitor() is None
        assert not any(t.name == "pdp-monitor" and t.is_alive()
                       for t in threading.enumerate())
        # The final beat on stop left a parseable heartbeat behind.
        hb = json.load(open(hb_path, encoding="utf-8"))
        assert hb["run"] == "glob"


class TestWatchdog:
    def test_fires_at_exact_fake_clock_deadline_and_rearms(self,
                                                           tmp_path):
        clk = FakeClock()
        mon = inline_monitor(tmp_path, clk, stall_s=30.0)
        with obs.tracer().span("phase.a", cat="t"):
            clk.sleep(0.5)
        mon.poll_once()  # baseline beat
        clk.sleep(29.99)
        assert mon.poll_once()["stalled"] is False
        assert mon.stalls == []
        clk.sleep(0.01)  # exactly 30.0s of silence
        hb = mon.poll_once()
        assert hb["stalled"] is True
        assert hb["stall"]["deadline_s"] == 30.0
        assert len(mon.stalls) == 1
        events = [e for e in obs.ledger().snapshot()["events"]
                  if e["name"] == "watchdog.stalled"]
        assert len(events) == 1
        assert events[0]["phase"] == "phase.a"
        assert events[0]["flight_record"] == mon.flight_path
        # The episode fires ONCE: more silence, no duplicate event.
        clk.sleep(100.0)
        mon.poll_once()
        assert len(mon.stalls) == 1
        # New span activity re-arms; the next silence fires again.
        with obs.tracer().span("phase.b", cat="t"):
            clk.sleep(0.1)
        assert mon.poll_once()["stalled"] is False
        clk.sleep(30.0)
        mon.poll_once()
        assert len(mon.stalls) == 2
        assert obs.ledger().snapshot()["counters"][
            "watchdog.stalls"] == 2
        mon.stop()

    def test_flight_record_ring_and_thread_stacks(self, tmp_path):
        """The flight record carries exactly the last-N completed
        spans and a stack summary for every live pdp-* worker."""
        from pipelinedp_tpu_torch.ingest.executor import _CaptureThread
        clk = FakeClock()
        mon = inline_monitor(tmp_path, clk, stall_s=10.0)
        tr = obs.tracer()
        n_over = FLIGHT_RING_SPANS + 17
        for i in range(n_over):
            with tr.span(f"s{i}", cat="t"):
                clk.sleep(0.001)
        held = threading.Event()
        entered = threading.Event()

        def body():
            with tr.span("worker.hold", cat="t"):
                entered.set()
                held.wait(30)

        worker = _CaptureThread(body, "wedge")
        worker.start()
        assert entered.wait(10)
        mon.poll_once()
        clk.sleep(10.0)
        mon.poll_once()
        assert len(mon.stalls) == 1
        rec = json.load(open(mon.flight_path, encoding="utf-8"))
        names = [s["name"] for s in rec["recent_spans"]]
        assert len(names) == FLIGHT_RING_SPANS
        assert names == [f"s{i}" for i in
                         range(n_over - FLIGHT_RING_SPANS, n_over)]
        (active,) = rec["active_spans"]
        assert active["name"] == "worker.hold"
        assert active["thread"] == "pdp-ingest-wedge"
        stacks = {v["name"]: v["stack"] for v in rec["threads"].values()}
        assert "pdp-ingest-wedge" in stacks
        assert any("body" in frame for frame in
                   stacks["pdp-ingest-wedge"])
        assert rec["stall"]["phase"] == "worker.hold"
        held.set()
        worker.join(10)
        assert not worker.is_alive()
        mon.stop()

    def test_on_stall_action_runs_and_errors_are_contained(self,
                                                           tmp_path):
        clk = FakeClock()
        seen = []
        mon = inline_monitor(tmp_path, clk, stall_s=5.0,
                             on_stall=seen.append)
        mon.poll_once()
        clk.sleep(5.0)
        mon.poll_once()
        assert len(seen) == 1
        assert seen[0]["flight_record"] == mon.flight_path
        assert "no span opened or closed" in seen[0]["diagnosis"]
        mon.stop()

        def boom(info):
            raise RuntimeError("action failed")

        clk2 = FakeClock()
        mon2 = inline_monitor(tmp_path, clk2, stall_s=5.0,
                              on_stall=boom, run_name="t2")
        mon2.poll_once()
        clk2.sleep(5.0)
        mon2.poll_once()  # must not raise
        assert len(mon2.stalls) == 1
        assert any(e["name"] == "watchdog.action_error"
                   for e in obs.ledger().snapshot()["events"])
        mon2.stop()


class TestParityHeartbeat:
    def test_outputs_bit_identical_heartbeat_on_off(self, tmp_path,
                                                    monkeypatch):
        """PARITY row 30: PIPELINEDP_TPU_HEARTBEAT changes ONLY the
        telemetry — DP outputs are bit-identical with the monitor on
        vs off, and only the 'on' run leaves a heartbeat file."""
        ds, parts = make_ds(seed=9)
        params = count_params(parts)
        hb_path = str(tmp_path / "hb.json")
        results = {}
        for mode in ("off", "on"):
            obs.reset()
            obs_monitor.stop()
            if mode == "on":
                monkeypatch.setenv(obs_monitor.ENV_VAR, hb_path)
            else:
                monkeypatch.delenv(obs_monitor.ENV_VAR, raising=False)
            results[mode] = run_streamed(ds, params, seed=17)
            obs_monitor.stop()
        assert os.path.exists(hb_path)
        assert set(results["off"]) == set(results["on"])
        for k in results["off"]:
            ta, tb = results["off"][k], results["on"][k]
            assert ta._fields == tb._fields
            for f in ta._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(ta, f)),
                    np.asarray(getattr(tb, f)),
                    err_msg=f"partition {k}.{f}")


class TestLedgerAnalytics:
    def _seed_two_runs(self, directory):
        store = obs_store.LedgerStore(directory)
        for total, rate in ((10.0, 100.0), (15.0, 120.0)):
            store.append("run_report", {
                "run_report": {
                    "counters": {"progress.rows_staged": 1000},
                    "spans": {"ingest.pass_a": {"count": 1,
                                                "total_s": total},
                              "walk.top": {"count": 1,
                                           "total_s": 0.5}}}},
                env=ENV_A)
            store.append("dp_rate", {"record": {
                "metric": "dp_rate", "value": rate,
                "unit": "rows/s"}}, env=ENV_A)
        return obs_store.fingerprint_key(ENV_A)

    def test_summarize_entries_trends(self, tmp_path):
        d = str(tmp_path / "led")
        fp = self._seed_two_runs(d)
        summary = obs_store.summarize_entries(
            obs_store.LedgerStore(d).entries())
        agg = summary[fp]
        assert agg["runs"] == 2 and agg["degraded_runs"] == 0
        pa = agg["phases"]["ingest.pass_a"]
        assert pa["reports"] == 2
        assert pa["mean_s"] == pytest.approx(12.5)
        assert pa["latest_s"] == pytest.approx(15.0)
        assert pa["trend"] == pytest.approx(0.5)  # 15 vs prior mean 10
        assert agg["phases"]["walk.top"]["trend"] == pytest.approx(0.0)
        m = agg["metrics"]["dp_rate"]
        assert m["samples"] == 2 and m["best"] == 120.0
        assert m["trend"] == pytest.approx(0.2)

    def test_summarize_cli_smoke(self, tmp_path):
        """The CLI end to end on a synthetic two-run ledger: human
        table by default, machine-readable under --json."""
        d = str(tmp_path / "led")
        fp = self._seed_two_runs(d)
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        proc = subprocess.run(
            [sys.executable, "-m", "pipelinedp_tpu_torch.obs.store",
             "--summarize", "--dir", d],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert f"fingerprint {fp}" in proc.stdout
        assert "ingest.pass_a" in proc.stdout
        assert "+50%" in proc.stdout  # the pass-A cost trend
        assert "dp_rate" in proc.stdout
        proc2 = subprocess.run(
            [sys.executable, "-m", "pipelinedp_tpu_torch.obs.store",
             "--summarize", "--dir", d, "--json"],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc2.returncode == 0, proc2.stderr
        payload = json.loads(proc2.stdout)
        assert payload["entries"] == 4
        assert payload["fingerprints"][fp]["phases"][
            "ingest.pass_a"]["trend"] == pytest.approx(0.5)


class TestSatellites:
    def test_chrome_trace_names_live_pdp_threads(self, tmp_path):
        """A pdp-* worker that completed no span still gets a Perfetto
        thread-name metadata row and an ``otherData.thread_names``
        entry — the tid→name map flight-record stacks key on."""
        from pipelinedp_tpu_torch.ingest.executor import _CaptureThread
        from pipelinedp_tpu_torch.obs import report as obs_report
        held = threading.Event()
        t = _CaptureThread(lambda: held.wait(30), "lurker")
        t.start()
        try:
            path = str(tmp_path / "trace.json")
            obs_report.write_chrome_trace(path, obs.ledger().snapshot())
            payload = json.load(open(path, encoding="utf-8"))
            names = payload["otherData"]["thread_names"]
            assert "pdp-ingest-lurker" in names.values()
            metas = [e for e in payload["traceEvents"]
                     if e["ph"] == "M"]
            assert any(m["args"]["name"] == "pdp-ingest-lurker"
                       for m in metas)
        finally:
            held.set()
            t.join(10)
        assert not t.is_alive()


class TestMonitorClockLint:
    """The monitor uses the injectable clock: no direct call into the
    ``time`` module anywhere in ``obs/monitor.py`` (AST-precise, so a
    ``time.monotonic`` is caught too)."""

    def test_monitor_never_calls_time_module(self):
        """The port's lint (``noperf``'s monitor check) makes the scan: an
        import of ``time``, a ``from time`` import, or any ``time.*`` /
        ``_time.*`` attribute in ``obs/monitor.py`` is a finding."""
        from pipelinedp_tpu_torch import lint
        rel = "pipelinedp_tpu_torch/obs/monitor.py"
        assert lint.check_tree("noperf", root=REPO, paths=[rel]) == []
        for seeded in ("import time\n", "from time import monotonic\n",
                       "import os\nX = _time.monotonic\n"):
            assert lint.lint_source(
                seeded, rel, [lint.rules.get("noperf")]).findings
