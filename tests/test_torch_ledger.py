"""The port's privacy audit record and durable run-ledger store
(``pipelinedp_tpu_torch/obs/audit.py``, ``store.py``) on the CPU: the
cases of ``tests/test_ledger.py`` that need no ``bench.py``. Append and
read semantics (round trip, v1 tolerance, torn tails, concurrent appends,
``last_known_good`` never degraded), the store directory's resolution,
the per-directory report cursor, and the ``privacy`` section after a real
run on ``TorchBackend("cpu")``. A shared ledger directory keeps the two
packages' runs apart: their fingerprints differ, so ``last_known_good``
never hands one package's run to the other.
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
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.obs import store as obs_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV_A = {"torch_version": "2.x", "platform": "cpu", "device_kind": "cpu",
         "device_count": 1, "process_count": 1, "git_sha": "aaa"}


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    """Fresh obs ledger/audit registry and an isolated store dir; the
    engine's traced appends (and bench's default) land in tmp."""
    monkeypatch.setenv(obs_store.ENV_VAR, str(tmp_path / "ledger"))
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", "997")
    obs.reset()
    yield
    obs.reset()


class TestStoreCore:
    """Append/read semantics of the JSONL store."""

    def test_append_read_round_trip_and_fingerprint(self, tmp_path):
        s = obs_store.LedgerStore(str(tmp_path / "s"))
        fp = obs_store.fingerprint_key(ENV_A)
        entry = s.append("m1", {"record": {"value": 100}}, env=ENV_A)
        assert entry["fingerprint"] == fp
        assert entry["schema_version"] == obs.SCHEMA_VERSION == 6
        got = s.entries()
        assert len(got) == 1
        assert got[0]["payload"]["record"]["value"] == 100
        # The key ignores volatile fields: flags and degraded must not
        # split baselines across runs of the same build.
        noisy = dict(ENV_A, degraded=True,
                     flags={"PIPELINEDP_TPU_TRACE": "1"})
        assert obs_store.fingerprint_key(noisy) == fp
        # ...but a code change (incl. -dirty) re-keys.
        assert obs_store.fingerprint_key(
            dict(ENV_A, git_sha="aaa-dirty")) != fp

    def test_v1_entry_tolerance(self, tmp_path):
        """A pre-privacy-section (schema v1) line — and one with no
        schema field at all — reads back with v1 defaults and still
        serves as a baseline."""
        s = obs_store.LedgerStore(str(tmp_path / "s"))
        fp = obs_store.fingerprint_key(ENV_A)
        with open(s.path, "w", encoding="utf-8") as f:
            f.write(json.dumps({"schema_version": 1, "name": "old",
                                "fingerprint": fp,
                                "payload": {"record": {"value": 7}}}) +
                    "\n")
            f.write(json.dumps({"name": "older", "fingerprint": fp,
                                "payload": {}}) + "\n")
        s.append("new", {"record": {"value": 9}}, env=ENV_A)
        entries = s.entries()
        assert [e["schema_version"] for e in entries] == [1, 1, 6]
        assert all(e["degraded"] is False for e in entries)
        lkg = s.last_known_good("old", fp)
        assert lkg is not None and (
            lkg["payload"]["record"]["value"] == 7)

    def test_truncated_trailing_line_recovery(self, tmp_path):
        """A crash mid-write leaves a torn tail: reads leave it
        UNCONSUMED (it may be an entry still being written — consuming
        it would split the entry across two incremental reads and drop
        it), the cursor stops before it, and the next append repairs
        it into a counted skip."""
        s = obs_store.LedgerStore(str(tmp_path / "s"))
        for v in (1, 2):
            s.append("m", {"record": {"value": v}}, env=ENV_A)
        clean_end = os.path.getsize(s.path)
        with open(s.path, "ab") as f:
            f.write(b'{"schema_version": 2, "name": "m", "payl')
        got, end = s.read_from(0)
        assert len(got) == 2
        assert s.skipped_lines == 0  # tail not consumed, not "corrupt"
        assert end == clean_end      # cursor stops BEFORE the tail
        s.append("m", {"record": {"value": 3}}, env=ENV_A)
        entries, end2 = s.read_from(end)
        assert [e["payload"]["record"]["value"] for e in entries] == [3]
        assert s.skipped_lines == 1  # repaired torn line now skips
        assert end2 == os.path.getsize(s.path)

    def test_concurrent_appends_lose_nothing(self, tmp_path):
        """>= 3 threads appending concurrently: every record lands,
        every line parses."""
        s = obs_store.LedgerStore(str(tmp_path / "s"))
        n_threads, per_thread = 4, 40
        errors = []

        def writer(i):
            try:
                for j in range(per_thread):
                    s.append(f"t{i}", {"record": {"j": j}}, env=ENV_A)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        entries = s.entries()
        assert s.skipped_lines == 0
        assert len(entries) == n_threads * per_thread
        for i in range(n_threads):
            js = sorted(e["payload"]["record"]["j"] for e in entries
                        if e["name"] == f"t{i}")
            assert js == list(range(per_thread))

    def test_last_known_good_never_degraded(self, tmp_path):
        """The wedged-run-masquerade guard: a degraded capture is never
        a baseline, even when it is the newest entry."""
        s = obs_store.LedgerStore(str(tmp_path / "s"))
        fp = obs_store.fingerprint_key(ENV_A)
        s.append("m", {"record": {"value": 100}}, env=ENV_A)
        s.append("m", {"record": {"value": 5}}, env=ENV_A,
                 degraded=True)
        assert s.latest("m", fp)["degraded"] is True
        lkg = s.last_known_good("m", fp)
        assert lkg["payload"]["record"]["value"] == 100
        assert s.last_known_good_map(fp)["m"] is not None
        # All-degraded history: no baseline at all, rather than a bad one.
        s2 = obs_store.LedgerStore(str(tmp_path / "s2"))
        s2.append("m", {"record": {"value": 5}}, env=ENV_A,
                  degraded=True)
        assert s2.last_known_good("m", fp) is None


class TestLedgerDirResolution:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv(obs_store.ENV_VAR, str(tmp_path / "explicit"))
        monkeypatch.setenv("PIPELINEDP_TPU_COMPILE_CACHE",
                           str(tmp_path / "cc"))
        assert obs_store.ledger_dir() == str(tmp_path / "explicit")

    def test_compile_cache_sibling_default(self, monkeypatch, tmp_path):
        monkeypatch.delenv(obs_store.ENV_VAR, raising=False)
        monkeypatch.setenv("PIPELINEDP_TPU_COMPILE_CACHE",
                           str(tmp_path / "cc"))
        assert obs_store.ledger_dir() == str(tmp_path / "pdp_run_ledger")

    def test_unset_returns_callers_default(self, monkeypatch):
        monkeypatch.delenv(obs_store.ENV_VAR, raising=False)
        monkeypatch.delenv("PIPELINEDP_TPU_COMPILE_CACHE", raising=False)
        assert obs_store.ledger_dir() is None
        assert obs_store.ledger_dir(default="/x") == "/x"


class TestReportCursorPerDirectory:
    """Regression for the resident multi-tenant service: the per-
    request delta cursor behind ``maybe_append_run_report`` must key
    by resolved directory — a process-wide cursor lets tenant A's
    append swallow the audit records tenant B's ledger never saw."""

    @staticmethod
    def _accountant_ids(entry):
        priv = entry["payload"]["run_report"]["privacy"]
        return [a["books"]["request_id"] for a in priv["accountants"]]

    def _push(self, request_id):
        from pipelinedp_tpu_torch.obs import audit as obs_audit
        with obs_audit.books_context("t", request_id):
            obs_audit.record_accountant({
                "accountant": "NaiveBudgetAccountant",
                "total_epsilon": 1.0, "total_delta": 0.0,
                "finalized": True, "mechanisms": []})

    def test_interleaved_directories_each_get_complete_deltas(
            self, monkeypatch, tmp_path):
        monkeypatch.delenv(obs_store.ENV_VAR, raising=False)
        obs.reset()
        dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
        self._push("r1")
        assert obs_store.maybe_append_run_report(
            "serve.request", directory=dir_a) is not None
        self._push("r2")
        # Directory B starts its own cursor: its first entry carries
        # BOTH records — r1 was never persisted to B's books.
        entry_b = obs_store.maybe_append_run_report(
            "serve.request", directory=dir_b)
        assert self._accountant_ids(entry_b) == ["r1", "r2"]
        # Directory A's next entry carries ONLY the new record.
        entry_a = obs_store.maybe_append_run_report(
            "serve.request", directory=dir_a)
        assert self._accountant_ids(entry_a) == ["r2"]
        # On-disk stores agree entry for entry.
        a_entries = obs_store.LedgerStore(dir_a).entries()
        assert [self._accountant_ids(e) for e in a_entries] == [
            ["r1"], ["r2"]]

    def test_directory_param_overrides_env(self, monkeypatch, tmp_path):
        monkeypatch.setenv(obs_store.ENV_VAR, str(tmp_path / "env_dir"))
        obs.reset()
        self._push("r1")
        pinned = str(tmp_path / "pinned")
        entry = obs_store.maybe_append_run_report("serve.request",
                                                  directory=pinned)
        assert entry is not None
        assert obs_store.LedgerStore(pinned).entries()
        assert not os.path.exists(
            os.path.join(str(tmp_path / "env_dir"),
                         obs_store.LEDGER_FILENAME))


def run_engine(seed=0, eps=1.0, n=6_000, parts=10):
    rng = np.random.default_rng(5)
    ds = pdt.ArrayDataset(privacy_ids=rng.integers(0, 1_500, n),
                          partition_keys=rng.integers(0, parts, n),
                          values=rng.uniform(0.0, 10.0, n))
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed))
    params = pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM, pdt.Metrics.MEAN],
        noise_kind=pdt.NoiseKind.LAPLACE,
        max_partitions_contributed=4, max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0)
    res = engine.aggregate(ds, params, pdt.DataExtractors())
    acc.compute_budgets()
    return dict(res), engine


class TestAuditSection:
    """Schema-v2 ``privacy`` section contents after a real run."""

    def test_every_mechanism_carries_eps_delta_and_stddev(self):
        run_engine()
        priv = obs.build_run_report()["privacy"]
        assert priv["accountants"], "compute_budgets did not record"
        acct = priv["accountants"][0]
        assert acct["accountant"] == "NaiveBudgetAccountant"
        assert acct["total_epsilon"] == 1.0 and acct["finalized"]
        by_metric = {m["metric"]: m for m in acct["mechanisms"]}
        assert {"mean", "partition_selection"} <= set(by_metric)
        mean = by_metric["mean"]
        assert mean["mechanism_type"] == "Laplace"
        assert mean["eps"] > 0 and mean["delta"] == 0.0
        assert mean["internal_splits"] == 2
        # Laplace unit-sensitivity calibration of the eps/k sub-split.
        assert mean["noise_standard_deviation"] == pytest.approx(
            np.sqrt(2.0) * 2 / mean["eps"])
        sel = by_metric["partition_selection"]
        assert sel["mechanism_type"] == "Generic"
        assert sel["eps"] > 0 and sel["delta"] > 0
        assert sel["noise_standard_deviation"] is None

    def test_pld_accountant_publishes_granted_stddev(self):
        acc = pdt.PLDBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        spec = acc.request_budget(
            pdt.aggregate_params.MechanismType.GAUSSIAN, metric="count")
        acc.compute_budgets()
        priv = obs.build_run_report()["privacy"]
        rec = priv["accountants"][-1]
        m = rec["mechanisms"][0]
        assert m["metric"] == "count"
        # The audit carries the PLD-granted stddev verbatim.
        assert m["noise_standard_deviation"] == pytest.approx(
            spec.noise_standard_deviation)

    def test_selection_counts_and_expected_errors(self):
        out, _ = run_engine(eps=1e6)
        priv = obs.build_run_report()["privacy"]
        sel = priv["partition_selection"]
        assert sel["strategies"] == ["Truncated Geometric"]
        assert sel["partitions_pre"] == 10
        assert sel["partitions_post"] == len(out)
        errs = {e["metric"]: e for e in priv["expected_errors"]}
        assert {"count", "mean", "sum"} <= set(errs)
        count = errs["count"]
        assert count["noise_stddev"] > 0
        assert count["aggregate_scale"] > 0
        assert count["expected_relative_error"] == pytest.approx(
            count["noise_stddev"] / count["aggregate_scale"])

    def test_structured_stages_keep_string_view(self):
        _, engine = run_engine()
        text = engine.explain_computations_report()[0]
        structured = engine.explain_computations_structured()[0]
        assert structured["method"] == "aggregate"
        assert structured["stages"], "no stages recorded"
        for stage in structured["stages"]:
            # The string view renders the same evaluated text with its
            # 1-based stage number.
            assert f" {stage['stage']}. {stage['text']}" in text

    def test_traced_run_appends_versioned_report(self, monkeypatch,
                                                 tmp_path):
        monkeypatch.setenv(obs.ENV_VAR, "1")
        run_engine()
        s = obs_store.LedgerStore(obs_store.ledger_dir())
        entries = [e for e in s.entries()
                   if e["name"] == "engine.aggregate"]
        assert entries, "traced engine run did not append to the store"
        report = entries[-1]["payload"]["run_report"]
        assert report["schema_version"] == 6
        mechs = report["privacy"]["accountants"][0]["mechanisms"]
        assert all("eps" in m and "delta" in m and
                   "noise_standard_deviation" in m for m in mechs)

    def test_traced_appends_are_per_request_deltas(self, monkeypatch):
        """Entry k carries ONLY request k's audit records — a traced
        process running N aggregations must not grow the ledger
        quadratically by re-appending requests 1..k-1 each time."""
        monkeypatch.setenv(obs.ENV_VAR, "1")
        run_engine(seed=0)
        run_engine(seed=1)
        s = obs_store.LedgerStore(obs_store.ledger_dir())
        entries = [e for e in s.entries()
                   if e["name"] == "engine.aggregate"]
        assert len(entries) == 2
        for e in entries:
            priv = e["payload"]["run_report"]["privacy"]
            assert len(priv["accountants"]) == 1
        # Cumulative views (counters) stay whole; record lists do not.
        ev0 = entries[0]["payload"]["run_report"]["events"]
        ev1 = entries[1]["payload"]["run_report"]["events"]
        assert not (ev0 and ev0[0] in ev1)

    def test_untraced_run_appends_nothing(self):
        run_engine()
        s = obs_store.LedgerStore(obs_store.ledger_dir())
        assert s.entries() == []


class TestSharedLedgerAcrossPackages:
    """One ``PIPELINEDP_TPU_LEDGER_DIR`` shared by both packages: each
    traced run appends under its own package's fingerprint, and
    ``last_known_good`` answers each package with its own run only."""

    def test_last_known_good_keeps_packages_apart(self, monkeypatch,
                                                  tmp_path):
        monkeypatch.setenv(obs.ENV_VAR, "1")
        jobs.reset()
        rng = np.random.default_rng(5)
        cols = (rng.integers(0, 1_500, 6_000), rng.integers(0, 10, 6_000),
                rng.uniform(0.0, 10.0, 6_000))
        params = pdp.AggregateParams(
            metrics=[pdp.Metrics.COUNT], noise_kind=pdp.NoiseKind.LAPLACE,
            max_partitions_contributed=4, max_contributions_per_partition=2)
        acc = pdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        res = pdp.DPEngine(acc, JaxBackend(rng_seed=0)).aggregate(
            pdp.ArrayDataset(*cols), params, pdp.DataExtractors())
        acc.compute_budgets()
        dict(res)
        jobs.reset()
        run_engine()
        s = obs_store.LedgerStore(obs_store.ledger_dir())
        entries = [e for e in s.entries()
                   if e["name"] == "engine.aggregate"]
        assert len(entries) == 2
        jfp = jobs.store.fingerprint_key(jobs.environment_fingerprint())
        tfp = obs_store.fingerprint_key(obs.environment_fingerprint())
        assert jfp != tfp
        assert {e["fingerprint"] for e in entries} == {jfp, tfp}
        mine = s.last_known_good("engine.aggregate", tfp)
        env = mine["payload"]["run_report"]["env"]
        assert "torch_version" in env and "jax_version" not in env
        theirs = s.last_known_good("engine.aggregate", jfp)
        assert "jax_version" in theirs["payload"]["run_report"]["env"]


class TestNoAdHocArtifactWrites:
    """``json.dump`` file writes stay under ``obs/`` and ``plan/`` (the
    planner's atomically replaced plan file is the second durable
    artifact): run artifacts flow through the versioned report, store
    and plan."""

    def test_json_dump_only_under_obs(self):
        import ast
        port = os.path.join(REPO, "pipelinedp_tpu_torch")
        found = []
        for root, _, files in os.walk(port):
            for name in files:
                path = os.path.join(root, name)
                rel = os.path.relpath(path, port)
                if not name.endswith(".py") or rel.split(os.sep)[0] in (
                        "obs", "plan"):
                    continue
                with open(path, encoding="utf-8") as f:
                    tree = ast.parse(f.read())
                for node in ast.walk(tree):
                    if (isinstance(node, ast.Call) and
                            isinstance(node.func, ast.Attribute) and
                            node.func.attr == "dump" and
                            isinstance(node.func.value, ast.Name) and
                            node.func.value.id == "json"):
                        found.append(f"{rel}:{node.lineno}")
        assert found == []


class TestFsck:
    """``python -m pipelinedp_tpu_torch.obs.store --fsck``: crash-consistency
    over the ledger tree. The tear test is exhaustive — a writer killed
    at EVERY byte boundary of the ledger file leaves a store fsck
    either repairs or reports, never one that loses a committed entry
    or splits one across reads."""

    def _seed_store(self, d):
        s = obs_store.LedgerStore(str(d))
        s.append("run.report", {"phase_s": {"a": 1.0}}, env={"k": "v"})
        s.append("bench.record", {"metric": "m", "value": 2.0},
                 env={"k": "v"})
        with open(s.path, "rb") as f:
            return s, f.read()

    def test_tear_at_every_byte_boundary(self, tmp_path):
        _, data = self._seed_store(tmp_path / "seed")
        full_lines = data.count(b"\n")
        for cut in range(len(data) + 1):
            d = tmp_path / f"torn-{cut}"
            os.makedirs(str(d))
            with open(str(d / "run_ledger.jsonl"), "wb") as f:
                f.write(data[:cut])
            summary = obs_store.fsck(str(d))
            assert summary["clean"], (cut, summary)
            # Entries fully written before the kill are all readable.
            committed = data[:cut].count(b"\n")
            store = obs_store.LedgerStore(str(d))
            entries = store.entries()
            assert len(entries) >= committed, (cut, len(entries))
            assert len(entries) <= full_lines
            # Idempotent: a second fsck finds nothing left to repair.
            again = obs_store.fsck(str(d))
            assert again["repaired"] == [], (cut, again)
            assert again["clean"]

    def test_torn_tail_repaired_and_appendable(self, tmp_path):
        s, data = self._seed_store(tmp_path)
        with open(s.path, "wb") as f:
            f.write(data[:-3])  # kill mid-final-line
        summary = obs_store.fsck(str(tmp_path))
        assert summary["clean"]
        assert any("torn" in r["action"] for r in summary["repaired"])
        # The store accepts appends and reads normally afterwards.
        s2 = obs_store.LedgerStore(str(tmp_path))
        s2.append("run.report", {"phase_s": {"b": 2.0}}, env={})
        entries = s2.entries()
        assert [e["name"] for e in entries][-1] == "run.report"
        assert s2.skipped_lines == 1  # the torn line, counted not lost

    def test_corrupt_budget_doc_reported_never_rewritten(self, tmp_path):
        # A real tenant budget ledger, as the resident service writes it.
        from pipelinedp_tpu_torch.serve.budget_ledger import (
            TenantBudgetLedger)
        led = TenantBudgetLedger(str(tmp_path / "budgets"))
        led.open_tenant("acme", 4.0, 1e-6)
        path = led.path_for("acme")
        with open(path, "rb") as f:
            doc = f.read()
        torn = doc[:len(doc) // 2]
        with open(path, "wb") as f:
            f.write(torn)
        summary = obs_store.fsck(str(tmp_path))
        assert not summary["clean"]
        assert any("corrupt document" in rec["problem"]
                   for rec in summary["damaged"])
        # Byte-for-byte intact: budget repair is an operator decision.
        with open(path, "rb") as f:
            assert f.read() == torn
        # CLI: rc 2 on damage, and the JSON shape carries the report.
        rc = obs_store.main(["--fsck", "--dir", str(tmp_path), "--json"])
        assert rc == 2

    def test_orphan_tmp_removed(self, tmp_path):
        self._seed_store(tmp_path)
        tmp = tmp_path / "budget-acme.json.tmp"
        tmp.write_text("{half")
        summary = obs_store.fsck(str(tmp_path))
        assert summary["clean"]
        assert any("temp" in r["action"] for r in summary["repaired"])
        assert not tmp.exists()
        # --no-repair mode reports and changes nothing.
        tmp.write_text("{half")
        summary = obs_store.fsck(str(tmp_path), repair=False)
        assert tmp.exists()
        assert any("temp" in r["problem"] for r in summary["tolerated"])

    def test_cli_clean_rc0(self, tmp_path, capsys):
        self._seed_store(tmp_path)
        rc = obs_store.main(["--fsck", "--dir", str(tmp_path)])
        assert rc == 0
        assert "clean" in capsys.readouterr().out
