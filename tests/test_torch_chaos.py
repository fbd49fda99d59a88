"""The port's seeded chaos campaign (``pipelinedp_tpu_torch/resilience/
chaos.py``) on the CPU, held to the JAX package's
(``pipelinedp_tpu/resilience/chaos.py``).

Ports the 7 tests of ``tests/test_chaos.py`` (the schedule is a pure
function of the seed, every FaultPlan seam is in the rotation, a failure
prints its reproduction command, the CLI seed comes from the environment,
the torn_ledger and wedged_probe episodes, a violation surfaces with its
context) and ``test_metrics.py::TestEndpointLifecycle::
test_chaos_obs_endpoint_episode``, under a fixture that asserts no leaked
``PIPELINEDP_TPU_*`` variable and no orphan ``pdp-*`` thread. Beside them:

* ``schedule_for`` equals the JAX package's for several seeds, and each
  scenario draws its parameters from ``random.Random(episode_seed)`` in
  the JAX order: the same seed installs the same fault plan in both
  packages;
* the port's clean CPU baselines (count_sum, percentile, the megasweep)
  equal the JAX chaos fixtures' bit for bit, and the single-device
  count_sum run the mesh episodes compare against equals the JAX
  package's clean ``make_mesh(2)`` and ``make_mesh(1)`` runs;
* each of the 11 rotation slots of seed 5 runs green on ``device="cpu"``
  (the two mesh slots share one module-scoped 4-rank gloo pool, whose
  rank processes are gone once it closes);
* without a card the campaign's default ``device="cuda"`` raises.
"""

import contextlib
import dataclasses
import os
import random
import threading

import pytest
import torch

from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.resilience import chaos
from pipelinedp_tpu_torch.resilience import faults as tfaults

CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"


@pytest.fixture(autouse=True)
def fresh_state():
    obs.reset()
    env_before = {k: v for k, v in os.environ.items()
                  if k.startswith("PIPELINEDP_TPU_")}
    yield
    obs.reset()
    orphans = [t.name for t in threading.enumerate()
               if t.name.startswith("pdp-") and t.is_alive()]
    assert not orphans, f"orphan threads: {orphans}"
    env_after = {k: v for k, v in os.environ.items()
                 if k.startswith("PIPELINEDP_TPU_")}
    # A leaked PIPELINEDP_TPU_* knob (stream chunk, fault plan, mesh
    # topology, degrade flag) would silently change every later test of
    # the process.
    assert env_after == env_before, (
        f"chaos leaked env: {set(env_after) ^ set(env_before) or env_after}")


@pytest.fixture(scope="module")
def cpu_fixtures():
    """One campaign's fixtures on the CPU for this module's episodes: the
    baselines are computed once, and the two mesh slots share its 4-rank
    pool. Closing it leaves no rank process behind."""
    fx = chaos._Fixtures("cpu")
    yield fx
    fx.close()
    assert chaos._rank_processes() == []


class TestSchedule:

    def test_schedule_is_deterministic_in_the_seed(self):
        a = chaos.schedule_for(7, 40)
        b = chaos.schedule_for(7, 40)
        assert a == b
        c = chaos.schedule_for(8, 40)
        assert a != c
        # Distinct episode seeds: 40 episodes = 40 distinct schedules.
        assert len({e["episode_seed"] for e in a}) == 40

    def test_every_seam_is_covered(self):
        """A default campaign reaches every FaultPlan seam: each scenario
        name appears, and every plan field is one scenario's."""
        sched = chaos.schedule_for(0, chaos.DEFAULT_SCHEDULES)
        ran = {e["scenario"] for e in sched}
        assert ran == set(chaos.SCENARIO_NAMES)
        assert set(chaos.SCENARIO_NAMES) == set(chaos._SCENARIOS)
        assert len(chaos.SCENARIO_NAMES) == 11

    def test_failure_prints_reproducing_seed(self, monkeypatch):
        """A failing episode's record (and the campaign output) carries
        the exact reproduction command, seed and device included. The
        other scenarios are stood in for by ones that pass: the test is of
        the harness's reporting (each scenario runs for real below)."""

        def boom(rng, fx, tmp):
            raise chaos.ChaosViolation("synthetic failure")

        for name in chaos.SCENARIO_NAMES:
            monkeypatch.setitem(chaos._SCENARIOS, name,
                                lambda rng, fx, tmp: None)
        monkeypatch.setitem(chaos._SCENARIOS, "torn_ledger", boom)
        monkeypatch.setattr(chaos, "_EXPECT_INJECTED", set())
        lines = []
        # Episode 7 of the rotation is torn_ledger.
        summary = chaos.run_campaign(123, 8, out=lines.append,
                                     device="cpu")
        assert summary["passed"] == 7
        (failure,) = summary["failures"]
        assert failure["scenario"] == "torn_ledger"
        assert "PIPELINEDP_TPU_CHAOS_SEED=123" in failure["repro"]
        assert "--only-episode 7" in failure["repro"]
        assert "--device cpu" in failure["repro"]
        assert "pipelinedp_tpu_torch.resilience.chaos" in failure["repro"]
        assert any("PIPELINEDP_TPU_CHAOS_SEED=123" in line
                   for line in lines)
        assert "--device" not in chaos.repro_command(1, 2, 3, "cuda")

    def test_cli_seed_defaults_from_env(self, monkeypatch, capsys):
        monkeypatch.setenv(chaos.CHAOS_SEED_ENV, "99")
        # --only-episode 7 is torn_ledger: cheap, no device work.
        rc = chaos.main(["--only-episode", "7", "--device", "cpu"])
        assert rc == 0
        assert "torn_ledger" in capsys.readouterr().out


class TestEpisodes:
    """Single-episode smoke of the cheap scenarios, in-process."""

    def test_torn_ledger_episode(self):
        # Rotation slot 7 = torn_ledger.
        spec = chaos.run_episode(5, 7, device="cpu")
        assert spec["scenario"] == "torn_ledger"

    def test_wedged_probe_episode(self, monkeypatch):
        # Rotation slot 4 = wedged_probe (FakeClock, zero wall time, no
        # probe subprocess under the injected wedge).
        import subprocess

        def no_probe(*args, **kwargs):
            raise AssertionError("the wedged probe spawned a subprocess")

        monkeypatch.setattr(subprocess, "Popen", no_probe)
        spec = chaos.run_episode(5, 4, device="cpu")
        assert spec["scenario"] == "wedged_probe"
        snap = obs.ledger().snapshot()
        assert snap["counters"].get("faults.injected", 0) >= 1

    def test_violation_surfaces_with_context(self, monkeypatch):
        def boom(rng, fx, tmp):
            raise chaos.ChaosViolation("invariant X broke")

        monkeypatch.setitem(chaos._SCENARIOS, "wedged_probe", boom)
        with pytest.raises(chaos.ChaosViolation, match="invariant X"):
            chaos.run_episode(5, 4, device="cpu")


class TestEndpointLifecycle:

    def test_chaos_obs_endpoint_episode(self):
        """The seeded chaos episode of the introspection endpoint runs
        green in-process (episode 9 of any campaign seed is
        obs_endpoint)."""
        spec = chaos.run_episode(5, 9, device="cpu")
        assert spec["scenario"] == "obs_endpoint"


# ---------------------------------------------------------------------
# Cross-package: the schedule, the draws and the baselines
# ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 123, 2**31 - 1])
def test_schedule_matches_the_jax_package(seed):
    from pipelinedp_tpu.resilience import chaos as jchaos
    assert chaos.schedule_for(seed, 40) == jchaos.schedule_for(seed, 40)
    assert chaos.SCENARIO_NAMES == jchaos.SCENARIO_NAMES
    assert chaos.DEFAULT_SCHEDULES == jchaos.DEFAULT_SCHEDULES
    assert chaos.CHAOS_SEED_ENV == jchaos.CHAOS_SEED_ENV
    assert chaos._EXPECT_INJECTED == jchaos._EXPECT_INJECTED


class _Planned(Exception):
    """Stops a scenario at the moment it installs its fault plan."""

    def __init__(self, plan):
        super().__init__("planned")
        self.plan = plan


class _NoWorkFixtures:
    """Stands in for both packages' fixtures: every dataset, parameter
    set and baseline is None, so a scenario reaches its fault plan
    without device work."""

    device = "cpu"
    record = {}

    def __getattr__(self, name):
        if name == "stream_ds":
            return lambda *a: (None, 12)
        if name == "recovered":
            return contextlib.nullcontext
        return lambda *a, **k: None


def _planned(scenario, rng, tmp):
    try:
        scenario(rng, _NoWorkFixtures(), tmp)
    except _Planned as stop:
        return dataclasses.asdict(stop.plan), rng.getstate()
    raise AssertionError("the scenario installed no fault plan")


@pytest.mark.parametrize("name", [n for n in chaos.SCENARIO_NAMES
                                  if n != "torn_ledger"])
def test_scenario_draws_match_the_jax_package(name, monkeypatch, tmp_path):
    """Each scenario draws its parameters from
    ``random.Random(episode_seed)`` in the JAX package's order: for
    several seeds both packages install the same fault plan (kill index,
    loss set, hold index, wedge) and leave their generators in the same
    state. (torn_ledger draws its cut from the ledger file's length and
    installs no plan.) A mesh scenario of the port hands its plan to its
    ranks; it is read where the port builds it."""
    from pipelinedp_tpu.resilience import chaos as jchaos
    from pipelinedp_tpu.resilience import faults as jfaults

    def stop(plan):
        raise _Planned(plan)

    monkeypatch.setattr(jfaults, "install", stop)
    monkeypatch.setattr(tfaults, "install", stop)
    monkeypatch.setattr(
        chaos, "_mesh_episode",
        lambda fx, losses, tmp, label, hier: stop(
            tfaults.FaultPlan(lose_device_chunks=losses)))
    slot = chaos.SCENARIO_NAMES.index(name)
    for seed in (0, 5, 77):
        spec = chaos.schedule_for(seed, slot + 1)[slot]
        want = _planned(jchaos._SCENARIOS[name],
                        random.Random(spec["episode_seed"]), str(tmp_path))
        got = _planned(chaos._SCENARIOS[name],
                       random.Random(spec["episode_seed"]), str(tmp_path))
        assert got == want, (seed, name)


@pytest.mark.parametrize("case", ["count_sum", "percentile", "sweep",
                                  "count_sum_mesh2", "count_sum_mesh1"])
def test_clean_baselines_match_the_jax_package(case, monkeypatch):
    """The oracles the episodes compare against: the port's clean CPU
    runs equal the JAX chaos fixtures' bit for bit. The mesh cases hold
    the port's single-device count_sum run (what device_loss and
    topo_kill compare their survivors with) to the JAX package's clean
    run on ``make_mesh(2)`` and ``make_mesh(1)``, the shapes those
    episodes shrink to."""
    import numpy as np
    from pipelinedp_tpu.resilience import chaos as jchaos
    monkeypatch.setenv(CHUNK_ENV, chaos.STREAM_CHUNK_ROWS)
    tfx = chaos._Fixtures("cpu")
    jfx = jchaos._Fixtures()
    if case == "sweep":
        got, want = tfx.sweep_baseline(), jfx.sweep_baseline()
        assert len(got) == len(want) == 12
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for field in a:
                if field == "metric_type":  # each package's own enum
                    assert a[field].value == b[field].value
                    continue
                np.testing.assert_array_equal(np.asarray(a[field]),
                                              np.asarray(b[field]),
                                              err_msg=field)
        return
    workload = case.split("_mesh")[0]
    n_dev = int(case[-1]) if "_mesh" in case else 0
    want = jfx.baseline(workload, n_dev)
    got = tfx.baseline(workload)
    assert len(got) > 0
    chaos.assert_bit_identical(got, want, case)


# ---------------------------------------------------------------------
# Every rotation slot on the CPU
# ---------------------------------------------------------------------


@pytest.mark.parametrize("slot", range(len(chaos.SCENARIO_NAMES)),
                         ids=list(chaos.SCENARIO_NAMES))
def test_rotation_slot_runs_green_on_the_cpu(slot, cpu_fixtures,
                                             monkeypatch):
    """Rotation slot ``slot`` of seed 5 on ``device="cpu"``: its recovery
    invariants hold (bit-identical release, drained threads, exactly-once
    leases, fsck, the elastic shrink on the shared 4-rank pool), and its
    record carries its wall and the launches of its recovered run (none
    on the CPU: the CPU path never counts a kernel launch)."""
    monkeypatch.setenv(CHUNK_ENV, chaos.STREAM_CHUNK_ROWS)
    rec = chaos.run_episode(5, slot, cpu_fixtures)
    assert rec["scenario"] == chaos.SCENARIO_NAMES[slot]
    assert rec["wall_s"] >= 0.0
    assert not any(rec["launches"].values())
    if rec["scenario"] in ("device_loss", "topo_kill"):
        survivors = rec["launches_per_rank"]
        assert len(survivors) in (1, 2)
        assert all(not any(c.values()) for c in survivors.values())


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the card is there: the default device runs")
def test_default_device_raises_without_a_card():
    """No fallback hides the device: the campaign's default
    ``device="cuda"`` raises on a host without one, before any episode,
    and never runs on the CPU by itself."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos.run_campaign(0, 11, out=lambda line: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos.run_episode(0, 7)
