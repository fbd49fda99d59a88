"""The port's fault plan, device-health probe, flagged degrade and mesh
supervision on the CPU, against the JAX package where both have the case.

Ports ``tests/test_resilience.py::TestFaultPlan``, ``TestDeviceHealth``,
``TestCollectiveFailureToLoss`` (with torch's gloo error texts) and
``TestNoDirectSleep`` (an AST scan of the port's ``resilience/`` and
``parallel/``), ``tests/test_obs.py::TestResilienceEvents::
test_health_degradation_event``, ``tests/test_monitor.py::
TestProbeWatchdog`` and ``TestHeartbeat::test_wedged_staged_fetch_end_to_end``.
The same ``RetryPolicy`` gives the same backoff schedule in both packages,
and the same ``PIPELINEDP_TPU_FAULTS`` string the same plan. This box has
no card: the probe of the card reports unhealthy within its timeout, and
the cases that need a healthy probe probe the CPU runtime
(``device="cpu"``), which is what a mesh put on the CPU probes.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from pipelinedp_tpu.resilience import faults as jfaults
from pipelinedp_tpu.resilience import health as jhealth
from pipelinedp_tpu.resilience.clock import FakeClock as JFakeClock
from pipelinedp_tpu.resilience.retry import RetryPolicy as JRetryPolicy

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.obs import monitor as obs_monitor
from pipelinedp_tpu_torch.resilience import checkpoint as ckpt_mod
from pipelinedp_tpu_torch.resilience import faults, health
from pipelinedp_tpu_torch.resilience.clock import FakeClock
from pipelinedp_tpu_torch.resilience.faults import FaultPlan, injected_faults
from pipelinedp_tpu_torch.resilience.retry import RetryPolicy

import test_torch_elastic_ranks as eranks
from test_torch_elastic import BoundedPool
from test_torch_mesh import assert_same_release
from test_torch_monitor import (count_params, inline_monitor, make_ds,
                                run_streamed, wait_activity_quiesce)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = dict(max_attempts=3, base_delay_s=2.0, multiplier=2.0,
              max_delay_s=60.0, jitter=0.1, seed=0)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """No ambient fault plan or degrade flag; the flag a test's code
    writes into os.environ is rolled back at teardown."""
    monkeypatch.setenv(faults.ENV_VAR, "")
    monkeypatch.setenv(health.DEGRADED_ENV, "")
    obs.reset()
    yield
    faults.clear()
    obs_monitor.stop()
    obs.reset()


class TestFaultPlan:

    @pytest.mark.parametrize("kw", [
        dict(wedged_init=2, fail_chunks=(3, 5), coordinator_timeouts=1),
        dict(lose_device_chunks=(1, 3), hold_fetch_batches=(2,),
             wedged_hold=True, fail_pass_b_chunks=(4,)),
        dict(fail_sketch_chunks=(0,), fail_sweep_config_chunks=(2, 7),
             fail_serve_requests=(1,))])
    def test_env_round_trip_matches_jax(self, kw):
        plan = FaultPlan(**kw)
        assert faults.plan_from_env(plan.to_env()) == plan
        jplan = jfaults.FaultPlan(**kw)
        assert plan.to_env() == jplan.to_env()
        import dataclasses
        assert (dataclasses.asdict(faults.plan_from_env(jplan.to_env())) ==
                dataclasses.asdict(jfaults.plan_from_env(jplan.to_env())))

    def test_wedged_counts_per_site(self):
        with injected_faults(FaultPlan(wedged_init=2)):
            assert faults.wedged("device.probe")
            assert faults.wedged("device.probe")
            assert not faults.wedged("device.probe")
            assert faults.wedged("mesh.init")  # sites count apart
        assert not faults.wedged("device.probe")  # cleared

    def test_check_chunk_raises_on_planned_chunks_only(self, monkeypatch):
        monkeypatch.setenv(faults.ENV_VAR, "fail_chunks=2")
        faults.check_chunk(0)
        faults.check_chunk(1)
        with pytest.raises(faults.ChunkFailure):
            faults.check_chunk(2)   # the plan in the variable

    def test_coordinator_timeouts_are_bounded(self):
        with injected_faults(FaultPlan(coordinator_timeouts=1)):
            with pytest.raises(faults.CoordinatorTimeout):
                faults.check_coordinator()
            faults.check_coordinator()  # the second attempt goes through

    def test_device_loss_ordinals_are_global(self):
        with injected_faults(FaultPlan(lose_device_chunks=(1, 3))):
            got = []
            for _ in range(5):
                try:
                    faults.check_device_loss()
                    got.append(None)
                except faults.DeviceLost as e:
                    got.append(e.index)
        assert got == [None, 1, None, 3, None]


class TestDeviceHealth:

    def test_wedged_probe_degrades_with_the_jax_backoff(self):
        clock, jclock = FakeClock(), JFakeClock()
        env, jenv = {}, {}
        with injected_faults(FaultPlan(wedged_init=99)):
            report = health.ensure_device_or_degrade(
                policy=RetryPolicy(**POLICY), clock=clock, timeout_s=300.0,
                env=env)
        with jfaults.injected_faults(jfaults.FaultPlan(wedged_init=99)):
            jreport = jhealth.ensure_device_or_degrade(
                policy=JRetryPolicy(**POLICY), clock=jclock,
                timeout_s=300.0, env=jenv)
        assert report.degraded and not report.healthy
        assert report.attempts == jreport.attempts == 3
        assert clock.sleeps == jclock.sleeps == RetryPolicy(**POLICY).delays()
        assert report.backoff_s == jreport.backoff_s
        # The degrade is explicit: the flag later backends read is set, the
        # reason kept. No platform variable: the port steers by the flag.
        assert env == {health.DEGRADED_ENV: "1"}
        assert jenv[jhealth.DEGRADED_ENV] == "1"
        assert "did not return within 300" in report.detail

    def test_recovered_device_lifts_the_degrade(self):
        env = {health.DEGRADED_ENV: "1"}
        report = health.ensure_device_or_degrade(
            policy=RetryPolicy(max_attempts=1), clock=FakeClock(),
            timeout_s=120.0, env=env, device="cpu")
        assert report.healthy and not report.degraded
        assert health.DEGRADED_ENV not in env
        assert any(e["name"] == "health.recovered"
                   for e in obs.ledger().snapshot()["events"])

    def test_transient_wedge_recovers_without_degrading(self):
        policy = RetryPolicy(max_attempts=3, base_delay_s=1.0, seed=0)
        clock, env = FakeClock(), {}
        with injected_faults(FaultPlan(wedged_init=1)):
            report = health.ensure_device_or_degrade(
                policy=policy, clock=clock, timeout_s=120.0, env=env,
                device="cpu")
        assert report.healthy and not report.degraded
        assert report.attempts == 2
        assert clock.sleeps == policy.delays()[:1]
        assert env == {}

    def test_resilient_make_mesh_falls_back_to_a_cpu_mesh(self):
        outs = BoundedPool().run(eranks.resilient_mesh, 2, env={
            faults.ENV_VAR: FaultPlan(wedged_init=99).to_env()})
        delays = RetryPolicy(max_attempts=2, base_delay_s=1.0,
                             seed=0).delays()
        for (degraded, attempts, sleeps, want, size, device, backend,
             total, _) in outs:
            assert degraded and attempts == 2
            assert sleeps == want == delays
            # The degraded mesh is a real, usable CPU mesh.
            assert (size, device, backend, total) == (4, "cpu", "gloo", 4)

    def test_resilient_make_mesh_healthy_and_agreed(self):
        """Healthy: one attempt, every rank. One rank wedged: the ranks
        agree and every one degrades, so they make the same mesh."""
        pool = BoundedPool()
        outs = pool.run(eranks.resilient_mesh, 1)
        assert [o[:2] for o in outs] == [(False, 1)] * 4
        assert {o[4:8] for o in outs} == {(4, "cpu", "gloo", 4)}
        mixed = pool.run(eranks.resilient_mesh, 1, rank_env={
            1: {faults.ENV_VAR: "wedged_init=9"}})
        assert [o[0] for o in mixed] == [True] * 4
        assert "peer rank" in mixed[0][8]
        assert "injected wedge" in mixed[1][8]

    def test_torch_backend_on_a_mesh_degrades_every_rank(self):
        """One rank's wedged probe under ``TorchBackend(health_policy=...,
        mesh=...)`` degrades every rank of the mesh, flagged on each: no
        rank leaves the mesh alone while its peers wait in it. The
        degraded single-device release equals the healthy mesh's."""
        pool = BoundedPool()
        clean = pool.run(eranks.backend_health)
        assert [o[:3] for o in clean] == [(False, False, True)] * 4
        mixed = pool.run(eranks.backend_health, rank_env={
            1: {faults.ENV_VAR: "wedged_init=9"}})
        assert [o[:3] for o in mixed] == [(True, True, False)] * 4
        assert "injected wedge" in mixed[1][3]
        assert all(o[3] == health.PEER_DEGRADED
                   for r, o in enumerate(mixed) if r != 1)
        for o in clean[1:] + mixed:
            assert_same_release(o[4], clean[0][4])

    def test_torch_backend_degrades_flagged(self, monkeypatch):
        monkeypatch.delenv(health.DEGRADED_ENV)
        assert pdt.TorchBackend("cpu", rng_seed=0).degraded is False
        # No policy and no flag: a box without a card raises, as before.
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            pdt.TorchBackend()
        policy = RetryPolicy(max_attempts=2, base_delay_s=1.0, seed=0)
        clock = FakeClock()
        with injected_faults(FaultPlan(wedged_init=99)):
            backend = pdt.TorchBackend(health_policy=policy, clock=clock,
                                       probe_timeout_s=60.0)
        assert backend.degraded is True
        assert backend.health.attempts == 2
        assert backend.mesh is None and backend.device.type == "cpu"
        assert clock.sleeps == policy.delays()
        assert os.environ[health.DEGRADED_ENV] == "1"
        # Every later backend says so, probe or no probe, and runs on the
        # CPU; the record says so too.
        later = pdt.TorchBackend(rng_seed=0)
        assert later.degraded is True and later.device.type == "cpu"
        created = [e for e in obs.ledger().snapshot()["events"]
                   if e["name"] == "backend.created"]
        assert [e["degraded"] for e in created] == [False, True, True]
        # And a degraded backend still releases: the fused path on the CPU.
        ds, parts = make_ds(seed=2, n=2_000)
        acc = pdt.NaiveBudgetAccountant(total_epsilon=1e6, total_delta=1e-6)
        res = pdt.DPEngine(acc, later).aggregate(
            ds, count_params(parts), pdt.DataExtractors())
        acc.compute_budgets()
        assert len(dict(res)) == parts


class TestProbe:

    def test_card_probe_on_a_box_without_one_reports_unhealthy(self):
        ok, detail = health.probe_devices(timeout_s=120.0)
        assert ok is False and detail
        ok, detail = health.probe_devices(timeout_s=0.3)
        assert ok is False

    def test_cpu_probe_is_healthy(self):
        assert health.probe_devices(timeout_s=120.0, device="cpu") == (
            True, "ok")


class TestCollectiveFailureToLoss:
    """Only a beat file that names a dead pid turns a failed collective
    into a lost rank; text alone never shrinks the mesh."""

    CLOSED = RuntimeError(
        "[third_party/gloo/gloo/transport/tcp/pair.cc:553] Connection "
        "closed by peer [127.0.0.1]:31445. This is typically caused by a "
        "remote worker crashing.")
    TIMED_OUT = RuntimeError(
        "[third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:78] Timed "
        "out waiting 5000ms for recv operation to complete")

    class _FakeMesh:
        is_multi_process = True

        def __init__(self, rank=0, n=2):
            self.rank = rank
            self.devices = np.arange(n)
            self.size = n

    def test_unarmed_or_one_rank_returns_none(self, monkeypatch):
        monkeypatch.delenv(health.MESH_DIR_ENV, raising=False)
        assert health.collective_failure_to_loss(
            self.CLOSED, self._FakeMesh()) is None
        monkeypatch.setenv(health.MESH_DIR_ENV, "/nonexistent")
        assert health.collective_failure_to_loss(
            self.CLOSED, self._FakeMesh(n=1)) is None

    def test_non_collective_error_returns_none(self, monkeypatch, tmp_path):
        monkeypatch.setenv(health.MESH_DIR_ENV, str(tmp_path))
        assert health.collective_failure_to_loss(
            RuntimeError("CUDA out of memory"), self._FakeMesh(),
            clock=FakeClock()) is None

    @pytest.mark.parametrize("err", ["CLOSED", "TIMED_OUT"])
    def test_dead_peer_confirms_loss(self, monkeypatch, tmp_path, err):
        monkeypatch.setenv(health.MESH_DIR_ENV, str(tmp_path))
        child = subprocess.Popen([sys.executable, "-c", "pass"])
        child.wait()
        ckpt_mod.atomic_write_json(str(tmp_path / "mesh-1.json"),
                                   {"process_id": 1, "pid": child.pid,
                                    "beat": 7})
        loss = health.collective_failure_to_loss(
            getattr(self, err), self._FakeMesh(), clock=FakeClock())
        assert isinstance(loss, health.MeshParticipantLost)
        assert loss.process_id == 1 and loss.reason == "collective_failure"
        assert loss.beat == 7
        assert "died mid-collective" in str(loss)

    def test_all_peers_alive_reraises(self, monkeypatch, tmp_path):
        monkeypatch.setenv(health.MESH_DIR_ENV, str(tmp_path))
        ckpt_mod.atomic_write_json(str(tmp_path / "mesh-1.json"),
                                   {"process_id": 1, "pid": os.getpid(),
                                    "beat": 7})
        clock = FakeClock()
        assert health.collective_failure_to_loss(
            self.CLOSED, self._FakeMesh(), clock=clock) is None
        # It polled the whole confirmation window before giving up.
        assert clock.monotonic() >= health._COLLECTIVE_LOSS_CONFIRM_S


class TestMeshSupervisor:

    def test_stall_verdict_on_a_fake_clock(self, tmp_path):
        """A live peer whose beat lags is lost at the stall deadline, not
        before; a dead peer at once."""
        clock = FakeClock()
        sup = health.MeshSupervisor(str(tmp_path), 0, 2, stall_s=30.0,
                                    clock=clock)
        ckpt_mod.atomic_write_json(health.member_path(str(tmp_path), 1),
                                   {"process_id": 1, "pid": os.getpid(),
                                    "beat": 0})
        with pytest.raises(health.MeshParticipantLost) as lost:
            sup.gate()
        assert lost.value.reason == "stalled" and lost.value.process_id == 1
        assert 30.0 <= clock.monotonic() < 30.0 + 2 * health._MESH_POLL_S
        child = subprocess.Popen([sys.executable, "-c", "pass"])
        child.wait()
        ckpt_mod.atomic_write_json(health.member_path(str(tmp_path), 1),
                                   {"process_id": 1, "pid": child.pid,
                                    "beat": 1})
        t0 = clock.monotonic()
        with pytest.raises(health.MeshParticipantLost) as dead:
            sup.gate()
        assert dead.value.reason == "process died"
        assert clock.monotonic() == t0
        ev = [e for e in obs.ledger().snapshot()["events"]
              if e["name"] == "mesh.participant_lost"]
        assert [e["reason"] for e in ev] == ["stalled", "process died"]

    def test_a_peer_at_the_beat_passes(self, tmp_path):
        clock = FakeClock()
        sup = health.MeshSupervisor(str(tmp_path), 0, 3, stall_s=5.0,
                                    clock=clock, members=[0, 2])
        ckpt_mod.atomic_write_json(health.member_path(str(tmp_path), 2),
                                   {"process_id": 2, "pid": os.getpid(),
                                    "beat": 1})
        sup.gate()  # rank 1 is not a member: its missing file is not waited on
        assert clock.sleeps == []
        doc = json.load(open(health.member_path(str(tmp_path), 0)))
        assert doc["beat"] == 1 and doc["pid"] == os.getpid()


class TestResilientInit:

    def test_coordinator_timeout_is_retried(self, tmp_path):
        import torch.distributed as dist
        assert not dist.is_initialized()
        clock = FakeClock()
        policy = RetryPolicy(max_attempts=2, base_delay_s=1.0, seed=0)
        with injected_faults(FaultPlan(coordinator_timeouts=1)):
            health.resilient_init_process_group(
                "gloo", 0, 1, store=dist.FileStore(str(tmp_path / "s"), 1),
                policy=policy, clock=clock)
        try:
            assert dist.is_initialized() and dist.get_world_size() == 1
            assert clock.sleeps == policy.delays()
        finally:
            dist.destroy_process_group()
        counters = obs.ledger().snapshot()["counters"]
        assert counters["retry.attempts"] == 1

    def test_rendezvous_that_never_answers_raises(self, tmp_path):
        from pipelinedp_tpu_torch.resilience import RetriesExhausted
        with injected_faults(FaultPlan(coordinator_timeouts=9)):
            with pytest.raises(RetriesExhausted):
                health.resilient_init_process_group(
                    "gloo", 0, 1, store=None, clock=FakeClock())


class TestResilienceEvents:

    def test_health_degradation_event(self):
        env = {}
        with injected_faults(FaultPlan(wedged_init=5)):
            report = health.ensure_device_or_degrade(
                policy=RetryPolicy(max_attempts=2, base_delay_s=1.0, seed=0),
                clock=FakeClock(), env=env)
        assert report.degraded
        snap = obs.ledger().snapshot()
        assert snap["counters"]["health.degradations"] == 1
        ev = next(e for e in snap["events"] if e["name"] == "health.degraded")
        assert ev["target"] == "cpu_platform" and ev["attempts"] == 2
        # The injected wedges themselves are on the record too.
        assert snap["counters"]["faults.injected"] == 2


class TestProbeWatchdog:

    def test_wedged_hold_probe_is_cancellable(self):
        class CancelAfter(FakeClock):
            def sleep(self, seconds):
                super().sleep(seconds)
                if len(self.sleeps) == 4:
                    health.cancel_active_probe()

        clk = CancelAfter()
        with injected_faults(FaultPlan(wedged_init=1, wedged_hold=True)):
            ok, detail = health.probe_devices(timeout_s=300.0, clock=clk)
        assert ok is False
        assert "cancelled by the stall watchdog" in detail
        assert sum(clk.sleeps) == pytest.approx(0.2)  # 4 beats, not 300 s

    def test_probe_stall_cancelled_by_live_monitor(self, tmp_path):
        """The armed monitor's stall action cancels a wedged probe, and the
        health layer degrades with the cancellation as its detail: seconds,
        not the probe's 30 s."""
        mon = obs_monitor.Monitor(
            stall_s=0.2, interval_s=0.05,
            heartbeat_path=str(tmp_path / "hb.json"), run_name="probe",
            on_stall=lambda info: health.cancel_active_probe()).start()
        env = {}
        try:
            with injected_faults(FaultPlan(wedged_init=99,
                                           wedged_hold=True)):
                report = health.ensure_device_or_degrade(
                    policy=RetryPolicy(max_attempts=1, base_delay_s=0.0,
                                       seed=0), timeout_s=30.0, env=env)
        finally:
            mon.stop()
        assert report.degraded
        assert "cancelled by the stall watchdog" in report.detail
        assert mon.stalls, "the watchdog never fired"
        rec = json.load(open(mon.flight_path, encoding="utf-8"))
        assert "health.device_probe" in [a["name"]
                                         for a in rec["active_spans"]]


class TestWedgedFetch:

    def test_wedged_staged_fetch_end_to_end(self, tmp_path, monkeypatch):
        """A seeded fault holds batch 2's staged fetch mid-stream. The
        monitor (on a FakeClock) reports the stalled phase, a
        ``watchdog.stalled`` event and a flight record naming the blocked
        fold worker; released, the run completes with no orphan thread."""
        monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", "997")
        ds, parts = make_ds(seed=5)
        params = count_params(parts)
        clk = FakeClock()
        mon = inline_monitor(tmp_path, clk, stall_s=30.0, run_name="wedged")
        results = {}

        def run():
            results["out"] = run_streamed(ds, params, seed=7)

        with injected_faults(FaultPlan(hold_fetch_batches=(2,))):
            t = threading.Thread(target=run)
            t.start()
            try:
                assert faults.hold_started().wait(60)
                wait_activity_quiesce()
                mon.poll_once()
                clk.sleep(29.99)
                assert mon.poll_once()["stalled"] is False
                clk.sleep(0.01)
                hb = mon.poll_once()
                assert hb["stalled"] is True
                assert hb["phase"] == "ingest.fetch"
                held = [a for a in hb["active_spans"]
                        if a["name"] == "ingest.fetch"]
                assert held and held[0]["thread"] == "pdp-ingest-fold"
                ev = [e for e in obs.ledger().snapshot()["events"]
                      if e["name"] == "watchdog.stalled"]
                assert ev and ev[0]["phase"] == "ingest.fetch"
                rec = json.load(open(mon.flight_path, encoding="utf-8"))
                stacks = {v["name"]: v["stack"]
                          for v in rec["threads"].values()}
                assert any("check_fetch_hold" in frame
                           for frame in stacks["pdp-ingest-fold"])
            finally:
                faults.release_holds()
                t.join(120)
        assert not t.is_alive()
        assert results["out"]
        mon.stop()
        orphans = [th for th in threading.enumerate()
                   if th.name.startswith("pdp-") and th.is_alive()]
        assert orphans == []


class TestNoDirectSleep:
    """No code path of the port's ``resilience/`` or ``parallel/`` calls
    ``time.sleep`` or starts a bare ``threading.Thread``: every wait goes
    through the injectable clock or an event's beats (``clock.py`` is the
    one module allowed to sleep). The port's lint (``nosleep``) makes the
    scan."""

    def test_no_time_sleep_and_no_bare_threads(self):
        from pipelinedp_tpu_torch import lint
        nosleep = lint.rules.get("nosleep")
        assert nosleep._SLEEP_EXEMPT == (
            "pipelinedp_tpu_torch/resilience/clock.py",)
        assert nosleep._THREAD_EXEMPT == ("pipelinedp_tpu_torch/ingest/",)
        paths = []
        for sub in ("resilience", "parallel"):
            d = os.path.join(REPO, "pipelinedp_tpu_torch", sub)
            paths += [f"pipelinedp_tpu_torch/{sub}/{name}"
                      for name in sorted(os.listdir(d))
                      if name.endswith(".py")]
        assert len(paths) > 5
        assert lint.check_tree("nosleep", root=REPO, paths=paths) == []
