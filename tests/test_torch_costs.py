"""The port's device cost observatory (``pipelinedp_tpu_torch/obs/costs``)
on the CPU.

The cases of ``tests/test_costs.py`` that need no mesh, no serve, no
``jnp`` and no ``bench.py``, adapted where the port has no compiler to
ask: the peak table (the H100's data-sheet row) and the roofline math; the
``instrumented`` seam, which with ``PIPELINEDP_TPU_COSTS`` unset calls the
function with no CUDA event and no table entry, and with it set records
one entry per (function, shapes and dtypes) and counts the calls; the
hand kernels' launches with their analytic bytes and integer operations;
torch-operator phases marked ``cost.unavailable``; the kernel builds'
``compile.program`` spans; device-memory sampling; the store's
mixed-schema reads; the Chrome-trace counter tracks; a traced streamed
run's ``device_costs`` section; and the scan that keeps CUDA-event timing
and memory probes under ``obs/``.
"""

import csv
import io
import json
import os

import numpy as np
import pytest
import torch

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.obs import costs
from pipelinedp_tpu_torch.obs import report as obs_report
from pipelinedp_tpu_torch.obs import store as obs_store
from pipelinedp_tpu_torch.obs.costs import instrumented
from pipelinedp_tpu_torch.obs.tracer import RunLedger
from pipelinedp_tpu_torch.ops.kernels import (segkeyed, segsum, segtotal,
                                              hist)
from pipelinedp_tpu_torch.resilience.clock import FakeClock

PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pipelinedp_tpu_torch")
H100 = "NVIDIA H100 80GB HBM3"
ENV_A = {"torch_version": "2.x", "platform": "cpu", "device_kind": "cpu",
         "device_count": 1, "process_count": 1, "git_sha": "aaa"}


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    """Capture off, a fresh ledger and cost table, an isolated store."""
    monkeypatch.delenv(costs.ENV_VAR, raising=False)
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    monkeypatch.setenv(obs_store.ENV_VAR, str(tmp_path / "ledger"))
    monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", "997")
    obs.reset()
    yield
    obs.reset()


class TestRoofline:
    """The static peak table and the verdict math."""

    def test_device_peaks_matching(self):
        row = costs.device_peaks(H100)
        assert row["kind"] == "h100_sxm" and row["proxy"] is False
        assert (row["flops_per_s"], row["hbm_bytes_per_s"]) == (67e12,
                                                                3.35e12)
        assert "data sheet" in row["source"]
        assert costs.device_peaks("NVIDIA H100 PCIe")["kind"] == "h100_sxm"
        cpu = costs.device_peaks("cpu")
        assert cpu["kind"] == "cpu_proxy" and cpu["proxy"] is True
        # No TPU row came across: a TPU's kind finds no ceiling here.
        assert costs.device_peaks("TPU v5 lite") is None
        assert costs.device_peaks("NVIDIA A100") is None
        assert costs.device_peaks(None) is None

    def test_verdict_flips_exactly_at_the_ridge(self):
        peaks = {"flops_per_s": 100.0, "hbm_bytes_per_s": 10.0}
        at = costs.roofline_verdict(1000.0, 100.0, peaks)
        assert at["verdict"] == "compute_bound"
        assert at["intensity"] == 10.0 and at["ridge"] == 10.0
        under = costs.roofline_verdict(999.0, 100.0, peaks)
        assert under["verdict"] == "bandwidth_bound"

    def test_unknown_when_analysis_or_peaks_missing(self):
        peaks = {"flops_per_s": 100.0, "hbm_bytes_per_s": 10.0}
        assert costs.roofline_verdict(None, 8.0, peaks)[
            "verdict"] == "unknown"
        assert costs.roofline_verdict(8.0, None, peaks)[
            "verdict"] == "unknown"
        assert costs.roofline_verdict(8.0, 0.0, peaks)[
            "verdict"] == "unknown"
        no_peaks = costs.roofline_verdict(8.0, 2.0, None)
        assert no_peaks["verdict"] == "unknown"
        assert no_peaks["ridge"] is None
        assert no_peaks["intensity"] == 4.0

    def test_segment_sums_classify_bandwidth_bound_on_the_h100(self):
        """K1's and K2's counts on the H100 row: at most one int32 add
        per four bytes read, far below the 20 op/byte ridge, so the bound
        is the bytes and ``bound_ms`` is bytes over 3.35 TB/s. The counts
        are the data's: zero lanes cost their read and no add, and ``pk``
        is read only in the 32-byte sectors of rows with a nonzero
        lane."""
        peaks = costs.device_peaks(H100)
        n, C, P = 100_000, 5, 1 << 16
        cols = torch.zeros(n, C, dtype=torch.int32)
        cols[: n // 2] = 1
        cols[n // 2:, 0] = 1
        pk = torch.zeros(n, dtype=torch.int32)
        w = segsum.work(cols, pk, P)
        assert w.ops == n // 2 * C + n // 2 and w.chain == 0
        assert w.bytes == 4 * n * C + 4 * n + 4 * P * C
        sparse = cols.clone()
        sparse[:, :] = 0
        sparse[::8, 0] = 1  # one row in every sector of 8 keys
        assert segsum.work(sparse, pk, P).bytes == w.bytes
        sparse[::16, 0] = 0  # every other sector holds no nonzero row
        assert segsum.work(sparse, pk, P).bytes == (
            4 * n * C + 4 * n // 2 + 4 * P * C)
        got = costs.roofline_verdict(w.ops, w.bytes, peaks)
        assert got["verdict"] == "bandwidth_bound"
        assert got["ridge"] == pytest.approx(20.0, rel=1e-3)
        b = costs.kernel_bound(w, peaks)
        assert b["bound_by"] == "bytes"
        assert b["bound_ms"] == pytest.approx(1e3 * w.bytes / 3.35e12)

    def test_kernel_bound_takes_the_longest_add_chain(self):
        """A chain of dependent adds (K4's segment, K5's key) bounds the
        time at ``ADD_CHAIN_CYCLES`` cycles per add at the top SM clock
        when it outlasts the bytes."""
        peaks = costs.device_peaks(H100)
        w = costs.Work(ops=1 << 20, bytes=9 << 20, chain=1 << 20)
        b = costs.kernel_bound(w, peaks)
        assert b["bound_by"] == "operations"
        assert b["bound_ms"] == pytest.approx(
            1e3 * (1 << 20) * costs.ADD_CHAIN_CYCLES / 1.98e9)
        assert costs.kernel_bound(w._replace(chain=1), peaks)[
            "bound_by"] == "bytes"


class TestSignature:
    """The key one program's entry is recorded under."""

    def test_signature_label_shapes(self):
        x = torch.zeros(3, 4, dtype=torch.int32)
        label = costs.signature_label((x, [x, 5], "f"), {"k": 2.5})
        assert label == "int32[3, 4], (int32[3, 4], 5), 'f', k=2.5"
        long = costs.signature_label(tuple(range(400)), {})
        assert len(long) == 512 and long.endswith("...")


class TestInstrumented:
    """The seam itself: off = the plain call; on = one entry per
    signature, the calls counted."""

    def test_off_records_nothing_and_makes_no_event(self, monkeypatch):
        calls = {"n": 0}

        def no_events(*a, **k):
            raise AssertionError("a CUDA event with costs off")

        monkeypatch.setattr(torch.cuda, "Event", no_events)
        monkeypatch.setattr(torch.cuda, "synchronize", no_events)

        @instrumented(phase="t")
        def f(x, k):
            calls["n"] += 1
            return x * k

        assert float(f(torch.tensor(3.0), k=2)) == 6.0
        x = torch.arange(6, dtype=torch.int32)
        got = segsum.segment_sum_lanes(x.view(3, 2).contiguous(),
                                       torch.zeros(3, dtype=torch.int32), 1)
        assert got.tolist() == [[6, 9]]
        assert costs.TABLE.snapshot()["programs"] == {}
        assert calls["n"] == 1
        assert "cost.programs_captured" not in (
            obs.ledger().snapshot()["counters"])

    def test_on_records_once_per_signature(self, monkeypatch):
        monkeypatch.setenv(costs.ENV_VAR, "1")
        monkeypatch.setenv(obs.ENV_VAR, "1")

        @instrumented(phase="walk")
        def g(x, k):
            return x * k

        r1 = g(torch.arange(8, dtype=torch.float32), k=3)
        r2 = g(torch.arange(8, dtype=torch.float32), k=3)
        assert torch.equal(r1, r2)
        snap = costs.TABLE.snapshot()
        assert len(snap["programs"]) == 1
        (entry,) = snap["programs"].values()
        assert entry["program"] == "g" and entry["phase"] == "walk"
        assert entry["signature"] == "float32[8], k=3"
        assert entry["calls"] == 2 and entry["ms"] >= 0.0
        assert entry["timer"] == "host_clock"
        assert entry["flops"] is None and entry["verdict"] == "unknown"
        assert entry["unavailable"] == ["flops/bytes: torch operators"]
        assert snap["device_kind"] == "cpu" and snap["platform"] == "cpu"
        counters = obs.ledger().snapshot()["counters"]
        assert counters["cost.programs_captured"] == 1
        assert counters["cost.unavailable"] == 1
        g(torch.arange(8, dtype=torch.float32), k=4)
        g(torch.arange(9, dtype=torch.float32), k=3)
        assert len(costs.TABLE.snapshot()["programs"]) == 3

    def test_phase_aggregates_roll_up(self, monkeypatch):
        monkeypatch.setenv(costs.ENV_VAR, "1")

        @instrumented(phase="pass_a")
        def h(cols, pk):
            return segsum.segment_sum_lanes(cols, pk, 4)

        cols = torch.ones(64, 3, dtype=torch.int32)
        pk = (torch.arange(64) % 4).to(torch.int32)
        assert h(cols, pk).tolist() == [[16, 16, 16]] * 4
        snap = costs.TABLE.snapshot()
        assert snap["peaks"]["kind"] == "cpu_proxy"
        assert set(snap["phases"]) == {"pass_a"}
        ph_a = snap["phases"]["pass_a"]
        # The kernel launch is a program of its own, booked under the
        # phase it launched in, with its counts and a verdict; the phase
        # of torch operators around it has neither.
        assert ph_a["programs"] == 2 and ph_a["analyzed"] == 1
        assert ph_a["flops"] == 64 * 3
        assert ph_a["bytes_accessed"] == 4 * (64 * 3 + 64 + 4 * 3)
        assert ph_a["verdict"] == "bandwidth_bound"
        assert ph_a["ms"] >= 0.0 and ph_a["kernel_ms"] >= 0.0
        [kernel] = [e for e in snap["programs"].values() if e["kernel"]]
        assert kernel["phase"] == "pass_a"
        # Outside every instrumented call the launch is booked under the
        # neutral kernel phase.
        segsum.segment_sum_lanes(cols, pk, 4)
        assert costs.TABLE.snapshot()["phases"]["kernel"]["programs"] == 1

    @pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5"])
    def test_each_kernel_launch_is_a_program(self, kernel, monkeypatch):
        """Every hand kernel's wrapper records its launch with its
        module's ``work`` of these inputs, the counts ``chip_smoke.py``
        bounds it with; its counts and bound sum over its calls."""
        monkeypatch.setenv(costs.ENV_VAR, "1")
        n = 96
        pk = (torch.arange(n) % 5).to(torch.int32)
        if kernel in ("K1", "K2"):
            fn = (segsum.segment_sum_lanes if kernel == "K1"
                  else segsum.segment_sum_wide)
            args = (torch.ones(n, 4, dtype=torch.int32), pk, 5)
            w = segsum.work(*args)
            fn(*args)
            name = fn.__name__
            want = (n * 4, 4 * (n * 4 + n + 5 * 4), 0)
        elif kernel == "K3":
            starts = torch.zeros(2, 3, 1, dtype=torch.int32)
            offs = torch.tensor([0, 3], dtype=torch.int32)
            fn = hist.subtree_counts_multi
            args = (pk, pk, torch.ones(n, dtype=bool), starts, offs, 3, 8)
            w = hist.work(*args)
            fn(*args)
            name = "subtree_counts_multi"
            # Tile 0 takes keys 0-2 (20 + 19 + 19 rows), tile 1 keys 3-4
            # (19 + 19), every leaf inside the span.
            want = (96, 9 * n + 4 * (starts.numel() + 2) +
                    4 * 2 * 3 * 1 * 8, 0)
        elif kernel == "K4":
            new_seg = torch.zeros(n, dtype=bool)
            new_seg[::7] = True
            fn = segtotal.segment_totals
            args = (torch.ones(n), new_seg)
            w = segtotal.work(*args)
            fn(*args)
            name = "segment_totals"
            want = (n, 9 * n, 7)
        else:
            layout = segkeyed.key_layout(pk, 5)
            fn = segkeyed.segmented_sums
            args = (torch.ones(n, 2), layout)
            w = segkeyed.work(*args)
            fn(*args)
            name = "segmented_sums"
            want = (n * 2, 4 * n * 2 + 8 * 6 + 4 * 5 + 4 * 5 * 2, 20)
        assert tuple(w) == want
        (entry,) = costs.TABLE.snapshot()["programs"].values()
        assert (entry["program"], entry["phase"], entry["kernel"]) == (
            name, costs.KERNEL_PHASE, True)
        assert (entry["flops"], entry["bytes_accessed"]) == want[:2]
        assert entry["unavailable"] is None and entry["calls"] == 1
        assert entry["verdict"] in ("compute_bound", "bandwidth_bound")
        bound = costs.kernel_bound(w, costs.device_peaks("cpu"))["bound_ms"]
        assert entry["bound_ms"] == pytest.approx(bound) and bound > 0.0
        fn(*args)
        (entry,) = costs.TABLE.snapshot()["programs"].values()
        assert entry["calls"] == 2
        assert (entry["flops"], entry["bytes_accessed"]) == (
            2 * want[0], 2 * want[1])
        assert entry["bound_ms"] == pytest.approx(2 * bound)

    def test_wrapper_passes_attributes_through(self):
        @instrumented(phase="t")
        def f(x):
            """Doc."""
            return x + 1

        assert f.__name__ == "f" and f.__doc__ == "Doc."
        assert f.__wrapped__(1) == 2
        bare = instrumented(lambda x: x)
        assert bare(3) == 3

    def test_exceptions_propagate_and_depth_resets(self, monkeypatch):
        monkeypatch.setenv(costs.ENV_VAR, "1")

        @instrumented(phase="t")
        def boom(x):
            raise ValueError("boom")

        with pytest.raises(ValueError):
            boom(torch.zeros(1))
        assert getattr(costs._STATE, "phase", None) is None

    def test_build_span_records_hit_and_miss(self, monkeypatch):
        monkeypatch.setenv(obs.ENV_VAR, "1")
        with costs.build_span("libx", cached=False):
            pass
        with costs.build_span("liby", cached=True):
            pass
        builds = costs.TABLE.snapshot()["builds"]
        assert builds["libx"]["compile_cache"] == "miss"
        assert builds["liby"]["compile_cache"] == "hit"
        spans = [s for s in obs.ledger().snapshot()["spans"]
                 if s.name == "compile.program"]
        assert {s.args["program"] for s in spans} == {"libx", "liby"}
        counters = obs.ledger().snapshot()["counters"]
        assert counters["compile.cache_misses"] == 1
        assert counters["compile.cache_hits"] == 1
        obs.reset()
        assert set(costs.TABLE.snapshot()["builds"]) >= {"libx", "liby"}


class TestHbmSampling:
    """The monitor-beat hook: live device bytes into gauges and series."""

    def test_off_is_noop(self):
        assert costs.sample_live_bytes() is None
        assert costs.hbm_snapshot() is None

    def test_no_card_is_noop(self, monkeypatch):
        monkeypatch.setenv(costs.ENV_VAR, "1")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert costs.sample_live_bytes() is None
        assert costs.hbm_snapshot() is None

    def test_on_fills_gauges_watermark_and_series(self, monkeypatch):
        monkeypatch.setenv(costs.ENV_VAR, "1")
        live = {"n": 4096}
        monkeypatch.setattr(costs, "_live_device_bytes", lambda: live["n"])
        assert costs.sample_live_bytes() == 4096
        snap = costs.hbm_snapshot()
        assert snap == {"live_bytes": 4096, "watermark": 4096}
        led = obs.ledger().snapshot()
        assert led["counters"]["hbm.live_bytes"] == 4096
        assert led["counters"]["hbm.watermark"] == 4096
        assert "hbm.live_bytes" not in led["series"]
        monkeypatch.setenv(obs.ENV_VAR, "1")
        live["n"] = 1024
        costs.sample_live_bytes()
        led = obs.ledger().snapshot()
        assert led["series"]["hbm.live_bytes"], "no series sample"
        assert costs.hbm_snapshot() == {"live_bytes": 1024,
                                        "watermark": 4096}

    def test_reset_clears_table_and_watermark(self, monkeypatch):
        monkeypatch.setenv(costs.ENV_VAR, "1")
        monkeypatch.setattr(costs, "_live_device_bytes", lambda: 8)
        costs.sample_live_bytes()
        assert costs.hbm_snapshot() is not None
        obs.reset()
        assert costs.hbm_snapshot() is None
        assert costs.TABLE.snapshot()["programs"] == {}


def _mixed_schema_store(tmp_path, fp_env=ENV_A):
    """A ledger holding one v1, one v2 and one current entry for the same
    fingerprint — what a long-lived install accretes across upgrades."""
    s = obs_store.LedgerStore(str(tmp_path / "mixed"))
    fp = obs_store.fingerprint_key(fp_env)
    v1 = {"schema_version": 1, "name": "run_report", "fingerprint": fp,
          "payload": {"run_report": {
              "schema_version": 1,
              "spans": {"pass_a": {"count": 1, "total_s": 1.0}}}}}
    v2 = {"schema_version": 2, "name": "run_report", "fingerprint": fp,
          "payload": {"run_report": {
              "schema_version": 2,
              "privacy": {"enabled": False},
              "spans": {"pass_a": {"count": 1, "total_s": 0.9}}}}}
    with open(s.path, "w", encoding="utf-8") as f:
        f.write(json.dumps(v1) + "\n")
        f.write(json.dumps(v2) + "\n")
    s.append("run_report", {"run_report": {
        "schema_version": 3,
        "spans": {"pass_a": {"count": 1, "total_s": 0.8}},
        "device_costs": {
            "platform": "gpu", "device_kind": H100,
            "peaks": {"kind": "h100_sxm", "flops_per_s": 67e12,
                      "hbm_bytes_per_s": 3.35e12, "proxy": False},
            "programs": {"segment_sum_lanes#0001": {
                "program": "segment_sum_lanes", "phase": "engine",
                "compile_s": 0.25, "compile_cache": "miss",
                "flops": 1e6, "bytes_accessed": 1e7,
                "intensity": 0.1, "verdict": "bandwidth_bound",
                "memory": {"peak_bytes": 4096}, "calls": 3, "ms": 1.5}},
            "phases": {"engine": {"programs": 1, "calls": 3,
                                  "compile_s": 0.25, "flops": 1e6,
                                  "bytes_accessed": 1e7, "analyzed": 1,
                                  "verdict": "bandwidth_bound",
                                  "intensity": 0.1, "ridge": 20.0}}}}},
        env=fp_env)
    return s, fp


class TestSchemaToleranceV1V2V3:
    """A mixed-schema ledger round-trips through ``last_known_good`` and
    ``--summarize`` (text, ``--json`` and ``--csv``)."""

    def test_entries_and_last_known_good(self, tmp_path):
        s, fp = _mixed_schema_store(tmp_path)
        entries = s.entries()
        assert [e["schema_version"] for e in entries] == [1, 2, 6]
        lkg = s.last_known_good("run_report", fp)
        assert lkg["schema_version"] == 6

    def test_summarize_mixes_all_schemas(self, tmp_path):
        s, fp = _mixed_schema_store(tmp_path)
        summary = obs_store.summarize_entries(s.entries())
        agg = summary[fp]
        assert agg["runs"] == 3
        assert agg["phases"]["pass_a"]["reports"] == 3
        prog = agg["programs"]["segment_sum_lanes"]
        assert prog["samples"] == 1
        assert prog["compile_s_latest"] == 0.25
        assert prog["compile_cache"] == "miss"
        assert prog["verdict"] == "bandwidth_bound"
        assert prog["hbm_peak_bytes"] == 4096
        assert (prog["ms"], prog["calls"]) == (1.5, 3)

    def test_summarize_cli_text_json_csv(self, tmp_path, capsys):
        s, fp = _mixed_schema_store(tmp_path)
        base = ["--summarize", "--dir", os.path.dirname(s.path)]
        assert obs_store.main(base) == 0
        text = capsys.readouterr().out
        assert "segment_sum_lanes" in text
        assert "bandwidth_bound" in text
        assert obs_store.main(base + ["--json"]) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["fingerprints"][fp]["programs"][
            "segment_sum_lanes"]["flops"] == 1e6
        assert obs_store.main(base + ["--csv"]) == 0
        rows = list(csv.DictReader(io.StringIO(capsys.readouterr().out)))
        assert {r["kind"] for r in rows} == {"phase", "program"}
        prog_row = next(r for r in rows if r["kind"] == "program")
        assert prog_row["name"] == "segment_sum_lanes"
        assert prog_row["verdict"] == "bandwidth_bound"
        assert float(prog_row["flops"]) == 1e6

    def test_program_rows_key_per_signature(self):
        p1 = {"program": "k", "signature": "int32[16, 3], 16"}
        p2 = {"program": "k", "signature": "int32[32, 3], 32"}
        k1, k2 = (obs_store._program_row_key(p1),
                  obs_store._program_row_key(p2))
        assert k1 != k2
        assert k1.startswith("k@") and k2.startswith("k@")
        assert obs_store._program_row_key(p1) == k1
        assert obs_store._program_row_key({"program": "k"}) == "k"

    def test_json_and_csv_are_mutually_exclusive(self, tmp_path):
        with pytest.raises(SystemExit):
            obs_store.main(["--summarize", "--dir", str(tmp_path),
                            "--json", "--csv"])


class TestChromeCounterTracks:
    """Sampled series export as ``ph: "C"`` counter events."""

    def test_counter_track_export(self):
        clock = FakeClock(100.0)
        led = RunLedger(clock=clock)
        led.sample("hbm.live_bytes", 1000.0)
        clock.sleep(1.0)
        led.sample("hbm.live_bytes", 3000.0)
        events = obs_report.chrome_trace_events(led.snapshot())
        cs = [e for e in events if e["ph"] == "C"]
        assert [e["args"]["value"] for e in cs] == [1000.0, 3000.0]
        assert cs[0]["name"] == "hbm.live_bytes"
        assert cs[1]["ts"] - cs[0]["ts"] == pytest.approx(1e6)

    def test_progress_counter_differentiates_to_rate(self):
        clock = FakeClock(10.0)
        led = RunLedger(clock=clock)
        led.sample("progress.rows_staged", 0.0)
        clock.sleep(1.0)
        led.sample("progress.rows_staged", 997.0)
        clock.sleep(2.0)
        led.sample("progress.rows_staged", 997.0 + 4000.0)
        events = obs_report.chrome_trace_events(led.snapshot())
        cs = [e for e in events if e["ph"] == "C"]
        assert all(e["name"] == "rows/s" for e in cs)
        assert [e["args"]["value"] for e in cs] == [997.0, 2000.0]

    def test_traced_inc_feeds_the_series(self, monkeypatch):
        monkeypatch.setenv(obs.ENV_VAR, "1")
        obs.inc("progress.rows_staged", 997)
        obs.inc("progress.rows_staged", 997)
        snap = obs.ledger().snapshot()
        assert [v for _, v in snap["series"][
            "progress.rows_staged"]] == [997.0, 1994.0]


def run_streamed(seed=31):
    rng = np.random.default_rng(seed)
    n, users, parts = 9_000, 2_000, 12
    ds = pdt.ArrayDataset(privacy_ids=rng.integers(0, users, n),
                          partition_keys=rng.integers(0, parts, n),
                          values=rng.uniform(0.0, 10.0, n))
    params = pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM,
                 pdt.Metrics.PERCENTILE(50)],
        max_partitions_contributed=parts,
        max_contributions_per_partition=50,
        min_value=0.0, max_value=10.0)
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1e12, total_delta=1e-2)
    engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=17))
    res = engine.aggregate(ds, params, pdt.DataExtractors())
    acc.compute_budgets()
    return dict(res)


class TestAcceptanceEndToEnd:
    """A traced streamed run with ``PIPELINEDP_TPU_COSTS=1``: the run
    report's ``device_costs`` section has the streamed phases and the
    kernels inside them, each kernel with counts and a verdict, and a
    phase's verdict is ``unknown`` only where none of its programs has
    counts (witnessed by ``cost.unavailable``)."""

    def test_traced_streamed_run_lands_device_costs(self, monkeypatch):
        monkeypatch.setenv(costs.ENV_VAR, "1")
        monkeypatch.setenv(obs.ENV_VAR, "1")
        run_streamed()
        report = obs.build_run_report()
        assert report["schema_version"] == 6
        dc = report["device_costs"]
        assert dc["device_kind"] == "cpu"
        events = obs.ledger().snapshot()["events"]
        unavailable = {e["program"] for e in events
                       if e["name"] == "cost.unavailable"}
        for entry in dc["programs"].values():
            assert (entry["flops"] is None) == (
                entry["program"] in unavailable)
            assert entry["kernel"] == (entry["flops"] is not None)
        for name, ph in dc["phases"].items():
            if ph["verdict"] == "unknown":
                assert ph["analyzed"] == 0 and unavailable, name
        assert {"pass_a", "pass_b", "walk",
                "select"} <= set(dc["phases"])
        # Each kernel is booked under the streamed phase it launched in:
        # K1 in pass A's reductions, K3 in pass B's histogram.
        kernels = {(e["program"], e["phase"])
                   for e in dc["programs"].values() if e["kernel"]}
        assert {("segment_sum_lanes", "pass_a"),
                ("subtree_counts_multi", "pass_b")} <= kernels


class TestNoDirectMeasurementCalls:
    """CUDA-event timing and device-memory probes
    (``elapsed_time``, ``max_memory_allocated``,
    ``reset_peak_memory_stats``, ``memory_allocated``) appear only under
    ``obs/``, so every measurement lands in the versioned report."""

    BANNED = {"elapsed_time", "max_memory_allocated",
              "reset_peak_memory_stats", "memory_allocated"}

    def test_measurement_calls_only_under_obs(self):
        """The port's lint (``nocost``) makes the scan."""
        from pipelinedp_tpu_torch import lint
        nocost = lint.rules.get("nocost")
        assert set(nocost._BANNED) == self.BANNED
        assert nocost.blessed == ("pipelinedp_tpu_torch/obs/",)
        result = lint.run(root=os.path.dirname(PORT_DIR),
                          rule_ids=["nocost"])
        assert result.files_scanned > 50
        assert [f.format() for f in result.findings] == []
        assert result.suppressed == []


class TestPeakMemoryOnTheCard:
    """On the card the allocator's peak counter belongs to the process:
    the table reads it and never resets it, so a caller reading
    ``max_memory_allocated`` across a run keeps its reading. A phase
    that passes the process's earlier peak records that new peak; one
    that stays under it records none. The card's calls are stood in for
    on the CPU."""

    def test_peak_is_read_and_never_reset(self, monkeypatch):
        monkeypatch.setenv(costs.ENV_VAR, "1")
        monkeypatch.setattr(costs.TABLE, "_device_kind",
                            costs.TABLE._device_kind)
        monkeypatch.setattr(costs.TABLE, "_platform", costs.TABLE._platform)
        peak = {"bytes": 1000}

        class Event:
            def __init__(self, enable_timing=False):
                pass

            def record(self):
                pass

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return 2.5

        def no_reset(*args, **kwargs):
            raise AssertionError("the process's peak counter was reset")

        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", no_reset)
        monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                            lambda dev=None: peak["bytes"])
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev=None: H100)
        card = torch.device("cuda")
        with costs._measure("rises", "engine", "s", card):
            peak["bytes"] = 5000
        with costs._measure("stays_under", "engine", "s", card):
            pass
        with costs._measure("rises", "engine", "s", card):
            peak["bytes"] = 7000
        progs = {e["program"]: e
                 for e in costs.TABLE.snapshot()["programs"].values()}
        assert progs["rises"]["memory"] == {"peak_bytes": 7000}
        assert progs["rises"]["calls"] == 2 and progs["rises"]["ms"] == 5.0
        assert progs["rises"]["timer"] == "cuda_event"
        assert progs["stays_under"]["memory"] is None
        assert peak["bytes"] == 7000
