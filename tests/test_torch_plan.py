"""The port's plan plane (``pipelinedp_tpu_torch/plan``) on the CPU.

The cases of ``tests/test_plan.py`` that need no mesh, no serve and no
``bench.py``: the knob registry's precedence and cold start, the plan
file (atomic writes, fingerprint keying, stale plans, bucketed lookups),
poisoned histories, the cost model, the ``q_chunk`` pin, planner on/off
bit parity, the store's run windows, and the source scan that keeps every
read of a registered knob's variable inside ``plan/knobs.py``.

The port's registry is the JAX package's without ``kernel_backend`` and
``segsum_wide_d_block``; the cross-package cases hold the rest of it, its
resolution under the same environment and plan file, and the autotune
candidates to the JAX package's.
"""

import ast
import json
import os

import numpy as np
import pytest

from pipelinedp_tpu import obs as jobs
from pipelinedp_tpu import plan as jplan

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch import plan as plan_pkg
from pipelinedp_tpu_torch import streaming
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.obs import store as obs_store
from pipelinedp_tpu_torch.ops import quantile_tree
from pipelinedp_tpu_torch.plan import knobs as plan_knobs
from pipelinedp_tpu_torch.plan import model as plan_model
from pipelinedp_tpu_torch.plan import planner as plan_planner

PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pipelinedp_tpu_torch")
BIG_EPS = 1e12
#: The knobs the port leaves out of the JAX package's registry.
NOT_PORTED = ("kernel_backend", "segsum_wide_d_block")
JAX_ONLY = NOT_PORTED

#: Today's hardcoded defaults, restated literally: the cold-start
#: criterion is byte identity against these values, so the test must not
#: derive them from the registry it checks.
HARDCODED_DEFAULTS = {
    "subhist_byte_cap": 600 << 20,
    "stream_chunk_rows": 1 << 26,
    "stream_cache_bytes": 4 << 30,
    "ingest_executor": True,
    "q_chunk": 0,
    "sweep_config_batch": 0,
    "vector_accumulator": "f32",
    "serve_fusion": False,
    "serve_fuse_window_ms": 8,
    "serve_fuse_batch": 8,
    "serve_fuse_rows_floor": 8192,
    "sketch_width": 1 << 16,
    "sketch_depth": 2,
    "sketch_candidate_cap": 4096,
    "sketch_backend": "matmul",
    "mesh_topology": "flat",
    "select_units_cap": int(np.iinfo(np.int32).max),
    "tree_rows_cap": int(np.iinfo(np.int32).max),
}


@pytest.fixture(autouse=True)
def fresh_plan_state(monkeypatch):
    """No ambient plan file or knob variable, fresh applied state and a
    fresh ledger in both packages."""
    for spec in plan_knobs.REGISTRY:
        if spec.env_var:
            monkeypatch.delenv(spec.env_var, raising=False)
    for var in (plan_planner.ENV_DIR, "PIPELINEDP_TPU_KERNEL_BACKEND",
                "PIPELINEDP_TPU_SEGSUM_WIDE_D_BLOCK",
                "PIPELINEDP_TPU_MESH_TOPOLOGY",
                "PIPELINEDP_TPU_SERVE_FUSION",
                "PIPELINEDP_TPU_SERVE_FUSE_WINDOW_MS",
                "PIPELINEDP_TPU_SERVE_FUSE_BATCH",
                "PIPELINEDP_TPU_SERVE_FUSE_ROWS_FLOOR",
                "PIPELINEDP_TPU_COMPILE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    jobs.reset()
    plan_pkg.set_default_dir(None)
    yield
    obs.reset()
    jobs.reset()
    plan_pkg.set_default_dir(None)


def _events(name):
    return [e for e in obs.ledger().snapshot()["events"]
            if e["name"] == name]


def _write_plan_file(directory, knobs, fingerprint=None, model=None,
                     planner=plan_planner):
    plan = {"schema_version": planner.PLAN_SCHEMA,
            "fingerprint": (planner.fingerprint()
                            if fingerprint is None else fingerprint),
            "device_kind": "cpu", "created_by": "test", "trials": 1,
            "knobs": {"default": dict(knobs)},
            "model": (model or plan_model.CostModel()).to_dict()}
    planner.write_plan(plan, str(directory))
    return plan


def _span():
    return quantile_tree.tree_constants()[3]


class TestKnobRegistry:
    """Resolution precedence and the cold-start contract."""

    def test_cold_start_is_byte_identical_to_defaults(self):
        resolved = plan_knobs.resolve_all(None)
        assert {k: v for k, (v, _) in resolved.items()} == (
            HARDCODED_DEFAULTS)
        assert {s for _, (_, s) in resolved.items()} == {"default"}
        assert plan_knobs.defaults() == HARDCODED_DEFAULTS

    def test_env_outranks_plan_and_default(self, monkeypatch):
        monkeypatch.setenv("PIPELINEDP_TPU_SUBHIST_CAP", "1048576")
        v, s = plan_knobs.resolve_value(
            plan_knobs.BY_NAME["subhist_byte_cap"],
            {"subhist_byte_cap": 2048})
        assert (v, s) == (1 << 20, "env")

    def test_seam_outranks_plan(self, monkeypatch):
        monkeypatch.setattr(te, "_SUBHIST_BYTE_CAP", 4096)
        v, s = plan_knobs.resolve_value(
            plan_knobs.BY_NAME["subhist_byte_cap"],
            {"subhist_byte_cap": 2048})
        assert (v, s) == (4096, "seam")

    def test_plan_outranks_default_for_dp_safe(self):
        v, s = plan_knobs.resolve_value(
            plan_knobs.BY_NAME["stream_cache_bytes"],
            {"stream_cache_bytes": 0})
        assert (v, s) == (0, "plan")

    def test_dp_unsafe_knob_never_applied_from_plan(self):
        v, s = plan_knobs.resolve_value(
            plan_knobs.BY_NAME["stream_chunk_rows"],
            {"stream_chunk_rows": 1234})
        assert (v, s) == (1 << 26, "default")
        ev = _events("plan.skipped_dp_unsafe")
        assert ev and ev[-1]["knob"] == "stream_chunk_rows"
        for guard in ("select_units_cap", "tree_rows_cap"):
            v, s = plan_knobs.resolve_value(plan_knobs.BY_NAME[guard],
                                            {guard: 7})
            assert (v, s) == (HARDCODED_DEFAULTS[guard], "default")

    def test_seam_override_restores(self):
        before = streaming._Q_CHUNK
        with plan_pkg.seam_override("q_chunk", 3):
            assert streaming._Q_CHUNK == 3
            assert plan_knobs.resolve_value(
                plan_knobs.BY_NAME["q_chunk"], None) == (3, "seam")
        assert streaming._Q_CHUNK == before

    def test_bool_parsing(self, monkeypatch):
        monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "off")
        v, s = plan_knobs.resolve_value(
            plan_knobs.BY_NAME["ingest_executor"], None)
        assert (v, s) == (False, "env")


class TestPlanFile:
    """Atomic persistence, fingerprint keying, stale rejection."""

    def test_round_trip_and_resolution(self, tmp_path, monkeypatch):
        d = tmp_path / "plan"
        monkeypatch.setenv(plan_planner.ENV_DIR, str(d))
        _write_plan_file(d, {"subhist_byte_cap": 12345678,
                             "ingest_executor": 0})
        resolved = plan_pkg.resolve(emit=True)
        assert resolved.values["subhist_byte_cap"] == 12345678
        assert resolved.sources["subhist_byte_cap"] == "plan"
        assert resolved.values["ingest_executor"] is False
        assert resolved.plan_source == "autotuned"
        assert resolved.plan_hash
        applied = {e["knob"]: e for e in _events("plan.applied")}
        assert applied["subhist_byte_cap"]["source"] == "plan"
        assert applied["subhist_byte_cap"]["value"] == 12345678
        assert applied["stream_chunk_rows"]["source"] == "default"
        report = obs.build_run_report()
        assert report["schema_version"] == 6
        assert report["plan"]["knobs"]["subhist_byte_cap"] == {
            "value": 12345678, "source": "plan"}
        assert report["plan"]["plan_hash"] == resolved.plan_hash

    def test_stale_fingerprint_ignored_with_event(self, tmp_path,
                                                  monkeypatch):
        d = tmp_path / "plan"
        monkeypatch.setenv(plan_planner.ENV_DIR, str(d))
        _write_plan_file(d, {"subhist_byte_cap": 999},
                         fingerprint="deadbeefdeadbeef")
        resolved = plan_pkg.resolve()
        assert resolved.values == HARDCODED_DEFAULTS
        assert resolved.plan_hash is None
        ev = _events("plan.stale")
        assert ev and ev[-1]["plan_fingerprint"] == "deadbeefdeadbeef"

    def test_stale_event_emitted_once_per_observation(self, tmp_path,
                                                      monkeypatch):
        d = tmp_path / "plan"
        monkeypatch.setenv(plan_planner.ENV_DIR, str(d))
        _write_plan_file(d, {"subhist_byte_cap": 999},
                         fingerprint="deadbeefdeadbeef")
        for _ in range(4):
            plan_pkg.resolve(emit=False)
            plan_pkg.knob_value("subhist_byte_cap")
        assert len(_events("plan.stale")) == 1
        _write_plan_file(d, {"subhist_byte_cap": 998},
                         fingerprint="feedfacefeedface")
        plan_pkg.resolve(emit=False)
        assert len(_events("plan.stale")) == 2

    def test_single_batch_request_resolves_plan(self, tmp_path,
                                                monkeypatch):
        d = tmp_path / "plan"
        monkeypatch.setenv(plan_planner.ENV_DIR, str(d))
        _write_plan_file(d, {"stream_cache_bytes": 0})
        ds = _dataset(n=2_000, parts=4)
        acc = pdt.NaiveBudgetAccountant(total_epsilon=BIG_EPS,
                                        total_delta=1e-2)
        engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=7))
        params = pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT],
            noise_kind=pdt.NoiseKind.LAPLACE,
            max_partitions_contributed=2,
            max_contributions_per_partition=3)
        res = engine.aggregate(ds, params, pdt.DataExtractors())
        acc.compute_budgets()
        dict(res)
        assert "stream_batches" not in res.timings
        applied = [e for e in _events("plan.applied")
                   if e["source"] == "plan"]
        assert applied, "single-batch request resolved no plan"
        assert plan_planner.last_resolved_shape() == {
            "rows": 2_000, "partitions": 4, "quantiles": 0}

    def test_disabled_dir_loads_nothing(self, monkeypatch):
        monkeypatch.setenv(plan_planner.ENV_DIR, "0")
        assert plan_planner.plan_dir() is None
        assert plan_planner.load_plan() is None

    def test_atomic_replace_no_torn_read(self, tmp_path, monkeypatch):
        d = tmp_path / "plan"
        monkeypatch.setenv(plan_planner.ENV_DIR, str(d))
        _write_plan_file(d, {"subhist_byte_cap": 1})
        _write_plan_file(d, {"subhist_byte_cap": 2})
        plan = plan_planner.load_plan()
        assert plan["knobs"]["default"]["subhist_byte_cap"] == 2
        assert os.listdir(d) == [plan_planner.PLAN_FILENAME]

    def test_corrupt_plan_file_resolves_defaults(self, tmp_path,
                                                 monkeypatch):
        d = tmp_path / "plan"
        d.mkdir()
        (d / plan_planner.PLAN_FILENAME).write_text("{torn", "utf-8")
        monkeypatch.setenv(plan_planner.ENV_DIR, str(d))
        resolved = plan_pkg.resolve()
        assert resolved.values == HARDCODED_DEFAULTS
        assert resolved.plan_source == "default"

    def test_plan_hash_keys_on_knobs_only(self):
        base = {"schema_version": plan_planner.PLAN_SCHEMA,
                "fingerprint": "f" * 16, "device_kind": "cpu",
                "created_by": "test", "ts": 1.0, "trials": 5,
                "knobs": {"default": {"q_chunk": 2}},
                "model": plan_model.CostModel().to_dict()}
        rewrite = dict(base, ts=999.0, trials=7,
                       model={"schema": 1, "tables": {"x": [1, 2]}})
        assert plan_planner.plan_hash(base) == (
            plan_planner.plan_hash(rewrite))
        moved = dict(base, knobs={"default": {"q_chunk": 4}})
        assert plan_planner.plan_hash(moved) != (
            plan_planner.plan_hash(base))
        assert plan_planner.plan_hash(base) == jplan.planner.plan_hash(base)

    def test_mid_request_knob_read_uses_resolved_shape_bucket(
            self, tmp_path, monkeypatch):
        d = tmp_path / "plan"
        monkeypatch.setenv(plan_planner.ENV_DIR, str(d))
        bucket = plan_model.bucket_key(1_000, 10, 3)
        plan = {"schema_version": plan_planner.PLAN_SCHEMA,
                "fingerprint": plan_planner.fingerprint(),
                "device_kind": "cpu", "created_by": "test",
                "trials": 1,
                "knobs": {bucket: {"subhist_byte_cap": 111 << 20},
                          "default": {"subhist_byte_cap": 222 << 20}},
                "model": plan_model.CostModel().to_dict()}
        plan_planner.write_plan(plan, str(d))
        resolved = plan_pkg.resolve(
            shape={"rows": 1_000, "partitions": 10, "quantiles": 3})
        assert resolved.values["subhist_byte_cap"] == 111 << 20
        assert plan_pkg.knob_value("subhist_byte_cap") == 111 << 20
        assert te._subhist_byte_cap() == 111 << 20
        plan_planner.reset()
        assert plan_pkg.knob_value("subhist_byte_cap") == 222 << 20


class TestPoisonedHistory:
    """Cold start and bad ledgers leave the defaults in force."""

    FP = "aaaaaaaaaaaaaaaa"

    def _entry(self, name, payload, degraded=False, fp=None):
        return {"schema_version": 4, "name": name, "degraded": degraded,
                "fingerprint": fp or self.FP, "ts": 0.0,
                "payload": payload}

    def _trial(self, total_s, degraded=False, fp=None, rows=1000):
        return self._entry("autotune.trial", {"trial": {
            "knobs": {"subhist_byte_cap": 1}, "total_s": total_s,
            "shape": {"rows": rows, "partitions": 8, "quantiles": 3},
            "device_kind": "cpu",
            "phases": {"pass_a": total_s}}}, degraded, fp)

    def test_empty_ledger_fits_empty_model(self):
        model = plan_model.fit([], fingerprint=self.FP)
        assert model.samples == 0
        assert model.predict_seconds("cpu", "pass_a", 1000) is None
        assert plan_model.choose_best_trial([], self.FP) is None

    def test_degraded_only_entries_are_ignored(self):
        entries = [self._trial(1.0, degraded=True) for _ in range(4)]
        model = plan_model.fit(entries, fingerprint=self.FP)
        assert model.samples == 0
        assert plan_model.choose_best_trial(entries, self.FP) is None

    def test_mixed_fingerprints_do_not_cross_pollute(self):
        entries = [self._trial(1.0, fp="bbbbbbbbbbbbbbbb"),
                   self._trial(2.0)]
        model = plan_model.fit(entries, fingerprint=self.FP)
        assert model.samples == 1
        best = plan_model.choose_best_trial(entries, self.FP)
        assert best[plan_model.bucket_key(1000, 8, 3)]["total_s"] == 2.0

    def test_poisoned_history_resolves_hardcoded_defaults(self):
        resolved = plan_pkg.resolve()
        assert resolved.values == HARDCODED_DEFAULTS
        assert set(resolved.sources.values()) == {"default"}


class TestCostModel:
    """Fit, predict and serialize, and the static roofline fallback."""

    def test_run_report_fits_request_shape_and_hbm_peak(self):
        rr = {"schema_version": 4,
              "env": {"device_kind": "NVIDIA H100 80GB HBM3"},
              "counters": {"ingest.rows_ingested": 4096},
              "spans": {"ingest.pass_a": {"total_s": 2.0},
                        "ingest.pass_b_sweep": {"total_s": 1.0}},
              "plan": {"shape": {"rows": 4096, "partitions": 32,
                                 "quantiles": 3}},
              "device_costs": {"programs": {
                  "k1": {"phase": "pass_a",
                         "memory": {"peak_bytes": 5_000_000}},
                  "k2": {"phase": "pass_b",
                         "memory": {"peak_bytes": 9_000_000}},
                  "k3": {"phase": "pass_b",
                         "memory": {"peak_bytes": 7_000_000}}}}}
        entry = {"schema_version": 4, "name": "run_report",
                 "degraded": False, "fingerprint": "f", "ts": 0.0,
                 "payload": {"run_report": rr}}
        model = plan_model.fit([entry], fingerprint="f")
        dk = "NVIDIA H100 80GB HBM3"
        bucket = plan_model.bucket_key(4096, 32, 3)
        assert (dk, "pass_a", bucket) in model.cells
        assert model.predict_seconds(
            dk, "pass_a", 4096, 32, 3) == pytest.approx(2.0)
        assert model.predict_hbm_peak(dk, "pass_b", 4096, 32, 3) == (
            9_000_000)

    def test_least_squares_prediction(self):
        entries = []
        for rows, secs in ((1000, 1.0), (2000, 2.0), (4000, 4.0)):
            entries.append({
                "schema_version": 4, "name": "autotune.trial",
                "degraded": False, "fingerprint": "f", "ts": 0.0,
                "payload": {"trial": {
                    "knobs": {"q_chunk": 0}, "total_s": secs,
                    "shape": {"rows": rows, "partitions": 8,
                              "quantiles": 3},
                    "device_kind": "cpu",
                    "phases": {"pass_a": secs}}}})
        model = plan_model.fit(entries, fingerprint="f")
        pred = model.predict_seconds("cpu", "pass_a", 8000, 8, 3)
        assert pred == pytest.approx(8.0, rel=0.3)
        again = plan_model.CostModel.from_dict(model.to_dict())
        assert again.predict_seconds("cpu", "pass_a", 8000, 8, 3) == (
            pytest.approx(pred))

    def test_roofline_fallback_uses_static_peaks(self):
        model = plan_model.CostModel()
        model.bytes_per_unit[("cpu", "pass_a")] = 16.0
        floor = model.roofline_floor("cpu", "pass_a", 1_000_000)
        assert floor == pytest.approx(16.0 * 1_000_000 / 5e10)
        assert model.predict_seconds("cpu", "pass_a",
                                     1_000_000) == pytest.approx(floor)
        # The H100 row: the data sheet's 3.35 TB/s.
        model.bytes_per_unit[("NVIDIA H100 80GB HBM3", "pass_a")] = 16.0
        assert model.roofline_floor(
            "NVIDIA H100 80GB HBM3", "pass_a", 1_000_000) == (
            pytest.approx(16.0 * 1_000_000 / 3.35e12))
        assert model.roofline_floor("quantum9", "pass_a", 10) is None


class TestQChunkPin:
    """The planner's q_chunk knob constrains the pass-B tiling."""

    def test_pin_constrains_tiling(self):
        span = _span()
        plan = streaming.plan_pass_b_sweeps(1 << 10, 4, span,
                                            600 << 20, q_chunk=1)
        assert plan.q_chunk == 1
        assert all(qn == 1 for _, qn, _ in plan.tiles)
        free = streaming.plan_pass_b_sweeps(1 << 10, 4, span, 600 << 20)
        assert free.n_tiles == 1 and free.q_chunk == 4

    def test_infeasible_pin_falls_back_to_search(self):
        span = _span()
        unit = span * 4
        pinned = streaming.plan_pass_b_sweeps(8, 4, span, 2 * unit,
                                              q_chunk=3)
        free = streaming.plan_pass_b_sweeps(8, 4, span, 2 * unit)
        assert pinned == free
        assert _events("plan.q_chunk_infeasible")


def _pct_params():
    return pdt.AggregateParams(
        metrics=[pdt.Metrics.PERCENTILE(p) for p in (25, 50, 75, 95)] +
        [pdt.Metrics.COUNT],
        noise_kind=pdt.NoiseKind.LAPLACE,
        max_partitions_contributed=5,
        max_contributions_per_partition=50,
        min_value=0.0, max_value=20.0)


def _dataset(seed=88, n=6_000, parts=5):
    rng = np.random.default_rng(seed)
    return pdt.ArrayDataset(privacy_ids=rng.integers(0, 1_500, n),
                            partition_keys=rng.integers(0, parts, n),
                            values=rng.uniform(0.0, 20.0, n))


def _run_streamed(ds, params, monkeypatch, chunk=997):
    monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", str(chunk))
    ds.invalidate_cache()
    acc = pdt.NaiveBudgetAccountant(total_epsilon=BIG_EPS,
                                    total_delta=1e-2)
    engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=7))
    res = engine.aggregate(ds, params, pdt.DataExtractors())
    acc.compute_budgets()
    got = dict(res)
    assert res.timings["stream_batches"] > 1
    return got, res.timings


class TestParityPlannerOnOff:
    """PARITY row 32: a plan file moving every dp-safe knob the stream
    reads releases the same bits as the no-plan defaults."""

    def test_planner_on_off_outputs_bit_identical(self, tmp_path,
                                                  monkeypatch):
        span = _span()
        ds, params = _dataset(), _pct_params()
        off, t_off = _run_streamed(ds, params, monkeypatch)
        d = tmp_path / "plan"
        monkeypatch.setenv(plan_planner.ENV_DIR, str(d))
        _write_plan_file(d, {"subhist_byte_cap": 5 * span * 4,
                             "q_chunk": 1,
                             "ingest_executor": 0,
                             "stream_cache_bytes": 0})
        on, t_on = _run_streamed(ds, params, monkeypatch)
        assert set(on) == set(off)
        applied = {e["knob"]: e["source"]
                   for e in _events("plan.applied")}
        for knob in ("subhist_byte_cap", "q_chunk", "ingest_executor",
                     "stream_cache_bytes"):
            assert applied[knob] == "plan"
        assert t_on["stream_executor"] == "serial"
        assert t_on["stream_pass_b"] == "reship"
        assert t_on["stream_pass_b_tiles"] > t_off["stream_pass_b_tiles"]
        for pk in off:
            for f in off[pk]._fields:
                assert (np.float64(getattr(on[pk], f)).tobytes() ==
                        np.float64(getattr(off[pk], f)).tobytes()), (
                    f"planner on/off diverged at {pk}.{f}")


class TestSinceRunId:
    """Run-windowed ledger reads."""

    def _store(self, tmp_path):
        s = obs_store.LedgerStore(str(tmp_path / "ledger"))
        env = {"device_kind": "cpu"}
        s.append("m", {"record": {"value": 1}}, env=env, run_id="r1")
        s.append("m", {"record": {"value": 2}}, env=env, run_id="r2")
        s.append("m", {"record": {"value": 3}}, env=env, run_id="r2")
        return s

    def test_window_module_helper(self, tmp_path):
        s = self._store(tmp_path)
        entries = s.entries()
        win = obs_store.entries_since_run_id(entries, "r2")
        assert [e["payload"]["record"]["value"] for e in win] == [2, 3]
        assert obs_store.entries_since_run_id(entries, "nope") == []

    def test_read_from_is_incremental(self, tmp_path):
        s = self._store(tmp_path)
        first, offset = s.read_from(0)
        assert len(first) == 3
        env = {"device_kind": "cpu"}
        s.append("m", {"record": {"value": 4}}, env=env, run_id="r3")
        tail, end = s.read_from(offset)
        assert [e["payload"]["record"]["value"] for e in tail] == [4]
        assert end > offset
        assert s.read_from(end)[0] == []

    def test_cli_since_run_id(self, tmp_path, capsys):
        s = self._store(tmp_path)
        rc = obs_store.main(["--summarize", "--dir", s.directory,
                             "--since-run-id", "r2", "--json"])
        assert rc == 0
        out = json.loads(capsys.readouterr().out)
        assert out["entries"] == 2


def _literal_assignments(tree):
    """{name: string} of the module-level ``NAME = "literal"``s."""
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1 and
                isinstance(node.targets[0], ast.Name) and
                isinstance(node.value, ast.Constant) and
                isinstance(node.value.value, str)):
            out[node.targets[0].id] = node.value.value
    return out


class TestNoDirectKnobReads:
    """No module of the port reads a registered knob's environment
    variable outside ``plan/knobs.py``: no string literal naming one
    appears anywhere else (a read needs the name), and no environment
    read elsewhere resolves to one. The module constants the registry
    names as seams exist and hold the registered defaults."""

    def test_knob_reads_only_under_plan(self):
        env_vars = {s.env_var for s in plan_knobs.REGISTRY if s.env_var}
        found = []
        for root, _, files in os.walk(PORT_DIR):
            for name in files:
                path = os.path.join(root, name)
                rel = os.path.relpath(path, PORT_DIR)
                if (not name.endswith(".py") or
                        rel == os.path.join("plan", "knobs.py")):
                    continue
                with open(path, encoding="utf-8") as f:
                    tree = ast.parse(f.read())
                names = _literal_assignments(tree)
                for node in ast.walk(tree):
                    if (isinstance(node, ast.Constant) and
                            node.value in env_vars):
                        found.append(f"{rel}:{node.lineno} literal "
                                     f"{node.value}")
                    if not isinstance(node, (ast.Call, ast.Subscript)):
                        continue
                    src = ast.unparse(node)
                    if "environ" not in src and "getenv" not in src:
                        continue
                    args = (node.args if isinstance(node, ast.Call)
                            else [node.slice])
                    for a in args[:1]:
                        if (isinstance(a, ast.Name) and
                                names.get(a.id) in env_vars):
                            found.append(f"{rel}:{node.lineno} reads "
                                         f"{names[a.id]}")
        assert found == []

    def test_registry_seams_exist_with_their_defaults(self):
        import importlib
        seams = {}
        for spec in plan_knobs.REGISTRY:
            if spec.seam is None:
                continue
            mod = importlib.import_module(spec.seam[0])
            seams[spec.name] = getattr(mod, spec.seam[1])
            assert seams[spec.name] == spec.default, spec.name
        assert set(seams) == {"subhist_byte_cap", "q_chunk",
                              "sweep_config_batch", "vector_accumulator",
                              "mesh_topology", "select_units_cap",
                              "tree_rows_cap"}


# ---------------------------------------------------------------------------
# Cross-package: the same environment and plan file, both registries
# ---------------------------------------------------------------------------


class TestCrossPackageKnobs:
    """The port's registry is the JAX package's, less the two knobs the
    port leaves out, and resolves the same under the same environment
    and plan file."""

    def test_registry_matches_the_jax_package(self):
        jspecs = {s.name: s for s in jplan.knobs.REGISTRY}
        tspecs = {s.name: s for s in plan_knobs.REGISTRY}
        assert set(jspecs) - set(tspecs) == set(JAX_ONLY)
        assert set(tspecs) <= set(jspecs)
        for name, t in tspecs.items():
            j = jspecs[name]
            assert (t.unit, t.default, t.env_var, t.dp_safe, t.kind,
                    t.choices) == (j.unit, j.default, j.env_var,
                                   j.dp_safe, j.kind, j.choices), name

    ENVS = [
        {},
        {"PIPELINEDP_TPU_SUBHIST_CAP": "1048576",
         "PIPELINEDP_TPU_INGEST_EXECUTOR": "off"},
        {"PIPELINEDP_TPU_STREAM_CACHE": "0",
         "PIPELINEDP_TPU_SKETCH_BACKEND": "XLA",
         "PIPELINEDP_TPU_VECTOR_ACCUMULATOR": "fx"},
        {"PIPELINEDP_TPU_SKETCH_BACKEND": "pallas",
         "PIPELINEDP_TPU_VECTOR_ACCUMULATOR": "bogus",
         "PIPELINEDP_TPU_SWEEP_CONFIG_BATCH": "3"},
    ]
    PLANS = [
        None,
        {"stream_cache_bytes": 0, "ingest_executor": 0, "q_chunk": 2},
        {"subhist_byte_cap": 1 << 20, "sketch_backend": "xla",
         "stream_chunk_rows": 1234, "kernel_backend": "pallas",
         "segsum_wide_d_block": 128, "sweep_config_batch": 64,
         "mesh_topology": "hier", "serve_fusion": True},
    ]

    @pytest.mark.parametrize("env", range(len(ENVS)))
    @pytest.mark.parametrize("plan", range(len(PLANS)))
    def test_same_resolution(self, env, plan, tmp_path, monkeypatch):
        for k, v in self.ENVS[env].items():
            monkeypatch.setenv(k, v)
        knobs = self.PLANS[plan]
        got = {}
        for name, pkg, o in (("jax", jplan, jobs),
                             ("port", plan_pkg, obs)):
            d = tmp_path / name
            monkeypatch.setenv(pkg.planner.ENV_DIR, str(d))
            if knobs is not None:
                _write_plan_file(d, knobs, planner=pkg.planner)
            r = pkg.resolve(shape={"rows": 1000, "partitions": 8,
                                   "quantiles": 1})
            skipped = sorted(e["knob"] for e in
                             o.ledger().snapshot()["events"]
                             if e["name"] == "plan.skipped_dp_unsafe")
            got[name] = ({k: (r.values[k], r.sources[k])
                          for k in r.values if k not in JAX_ONLY},
                         r.plan_source, skipped)
        assert got["port"] == got["jax"]

    def test_autotune_candidates_match(self):
        jc = [{k: v for k, v in c.items() if k not in JAX_ONLY}
              for c in jplan.autotune_candidates()]
        # The JAX package's deviations of the knobs the port does not
        # register are the default vector again once they are dropped.
        base = jc[0]
        jc = [jc[0]] + [c for c in jc[1:] if c != base]
        tc = plan_pkg.autotune_candidates()
        assert tc == jc
        assert tc[-1] == dict(base, sketch_backend="xla")
