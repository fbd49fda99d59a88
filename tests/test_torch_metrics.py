"""The port's request trace context, metric registry and introspection
endpoint (``pipelinedp_tpu_torch/obs/trace_context.py``, ``metrics.py``,
``http.py``) on the CPU: the cases of ``tests/test_metrics.py`` that need
no serve and no chaos harness. Context isolation and propagation across
threads, span parentage, histogram exactness and the Prometheus
exposition, the endpoint's lifecycle and routes, and the store's
``--trace-id`` view of an aggregation run under a bound context. Serve's
metric families stay registered; their producer is the resident service
(ROADMAP step 6).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.obs import http as obs_http
from pipelinedp_tpu_torch.obs import metrics as obs_metrics
from pipelinedp_tpu_torch.obs import monitor as obs_monitor
from pipelinedp_tpu_torch.obs import store as obs_store
from pipelinedp_tpu_torch.obs import trace_context


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    """Fresh obs state, an isolated ledger dir, the endpoint and the
    heartbeat off unless a test arms them, and no orphan endpoint
    thread afterwards."""
    monkeypatch.setenv("PIPELINEDP_TPU_LEDGER_DIR",
                       str(tmp_path / "obs_ledger"))
    monkeypatch.delenv(obs_http.ENV_VAR, raising=False)
    monkeypatch.delenv(obs_monitor.ENV_VAR, raising=False)
    monkeypatch.delenv("PIPELINEDP_TPU_TRACE", raising=False)
    obs.reset()
    yield
    obs_monitor.stop()
    obs.reset()
    orphans = [t.name for t in threading.enumerate()
               if t.name == "pdp-obs-http" and t.is_alive()]
    assert not orphans, f"orphan threads: {orphans}"


def http_get(url):
    """(status, parsed-or-text body) without raising on 4xx/5xx."""
    try:
        with urllib.request.urlopen(url) as resp:
            body = resp.read().decode("utf-8")
            code = resp.status
    except urllib.error.HTTPError as e:
        body = e.read().decode("utf-8")
        code = e.code
    try:
        return code, json.loads(body)
    except ValueError:
        return code, body


class TestTraceContext:

    def test_concurrent_binds_are_isolated(self):
        """contextvars isolation under a deliberate interleave: every
        thread binds its own context, meets the others at a barrier
        INSIDE the bind, and still reads back only its own ids."""
        n = 8
        barrier = threading.Barrier(n)
        seen = {}

        def work(i):
            with trace_context.bind(tenant=f"t{i}",
                                    request_id=f"r{i}") as ctx:
                barrier.wait(timeout=10)
                cur = trace_context.current()
                attrs = {}
                trace_context.stamp_event_attrs(attrs)
                seen[i] = (cur.trace_id == ctx.trace_id,
                           cur.tenant, attrs["tenant"])

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(seen) == n
        for i, (same, tenant, stamped) in seen.items():
            assert same, f"thread {i} read another thread's context"
            assert tenant == stamped == f"t{i}"
        assert trace_context.current() is None  # nothing leaked out

    def test_restore_none_is_passthrough(self):
        with trace_context.bind(tenant="t") as outer:
            with trace_context.restore(None):
                assert trace_context.current() is outer

    def test_capture_restore_crosses_threads(self):
        """The serve handoff pattern: capture on the submitter thread,
        restore on a worker — trace_id survives, and the worker's exit
        leaves the worker thread context-free."""
        out = {}
        with trace_context.bind(tenant="t", request_id="r") as ctx:
            captured = trace_context.current()

        def worker():
            assert trace_context.current() is None
            with trace_context.restore(captured):
                out["tid"] = trace_context.current().trace_id
            out["after"] = trace_context.current()

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert out["tid"] == ctx.trace_id
        assert out["after"] is None

    def test_nested_spans_record_true_parentage(self, monkeypatch):
        """With tracing on, a span opened inside another span's body
        records the enclosing span's id as ``parent_span`` — and both
        carry the bound trace_id."""
        monkeypatch.setenv("PIPELINEDP_TPU_TRACE", "1")
        obs.reset()
        tr = obs.run_tracer()
        with trace_context.bind(tenant="t", request_id="r") as ctx:
            with tr.span("outer", cat="test"):
                with tr.span("inner", cat="test"):
                    pass
        spans = {s.name: s for s in obs.ledger().snapshot()["spans"]}
        outer, inner = spans["outer"], spans["inner"]
        assert outer.args["trace_id"] == ctx.trace_id
        assert inner.args["trace_id"] == ctx.trace_id
        assert inner.args["parent_span"] == outer.args["span_id"]

    def test_spans_unstamped_without_context(self, monkeypatch):
        monkeypatch.setenv("PIPELINEDP_TPU_TRACE", "1")
        obs.reset()
        with obs.run_tracer().span("lonely", cat="test"):
            pass
        (span,) = obs.ledger().snapshot()["spans"]
        assert "trace_id" not in span.args


# ---------------------------------------------------------------------
# histogram exactness + exposition format
# ---------------------------------------------------------------------


class TestHistogram:

    def test_bucket_boundary_inclusive_le(self):
        """Prometheus ``le`` is inclusive: a value EQUAL to a bound
        lands in that bound's bucket; epsilon past it spills to the
        next. This is the boundary-exactness contract."""
        h = obs_metrics.Histogram("t", buckets=(0.1, 1.0, 10.0))
        h.observe(0.1)        # == bound -> le=0.1
        h.observe(0.1000001)  # just past -> le=1.0
        h.observe(1.0)        # == bound -> le=1.0
        h.observe(10.0)       # == last bound -> le=10.0
        h.observe(11.0)       # overflow -> +Inf only
        snap = h.snapshot()
        cum = dict(snap["buckets"])
        assert cum[0.1] == 1
        assert cum[1.0] == 3
        assert cum[10.0] == 4
        assert snap["count"] == 5
        assert snap["sum"] == pytest.approx(22.2000001)

    def test_quantiles_without_sample_retention(self):
        """p50/p99 interpolate inside the owning bucket — and the
        overflow bucket reports the last bound (an honest floor), so
        a wild outlier can never invent a tail value."""
        h = obs_metrics.Histogram("t", buckets=(1.0, 2.0, 4.0))
        for _ in range(100):
            h.observe(1.5)
        assert 1.0 <= h.quantile(0.5) <= 2.0
        h2 = obs_metrics.Histogram("t2", buckets=(1.0, 2.0))
        h2.observe(1e9)
        assert h2.quantile(0.99) == 2.0

    def test_rejects_unsorted_buckets(self):
        with pytest.raises(ValueError):
            obs_metrics.Histogram("bad", buckets=(2.0, 1.0))

    def test_exposition_naming_and_escaping(self):
        obs_metrics.set_gauge("tenant.epsilon_remaining", 4.5,
                              tenant='acme "prod"\nteam')
        obs_metrics.observe("serve.request_seconds", 0.02)
        text = obs_metrics.render_prometheus(
            counters={"serve.requests_served": 3})
        # dots -> underscores, pdp_ prefix, counters get _total.
        assert "pdp_serve_requests_served_total 3" in text
        assert ('pdp_tenant_epsilon_remaining{tenant='
                '"acme \\"prod\\"\\nteam"} 4.5') in text
        # histogram: cumulative buckets, +Inf, sum/count triplet.
        assert 'pdp_serve_request_seconds_bucket{le="+Inf"} 1' in text
        assert "pdp_serve_request_seconds_count 1" in text
        # integral floats print without a trailing .0
        assert 'le="1"' in text and 'le="1.0"' not in text


# ---------------------------------------------------------------------
# the wire surface
# ---------------------------------------------------------------------


class TestEndpointLifecycle:

    def test_off_by_default_zero_threads(self):
        before = sum(1 for t in threading.enumerate() if t.is_alive())
        assert obs_http.endpoint_port() is None
        assert obs_http.maybe_start() is None
        after = sum(1 for t in threading.enumerate() if t.is_alive())
        assert after == before
        assert not any(t.name == "pdp-obs-http"
                       for t in threading.enumerate())

    def test_bad_port_is_off_not_a_crash(self, monkeypatch):
        monkeypatch.setenv(obs_http.ENV_VAR, "not-a-port")
        assert obs_http.endpoint_port() is None
        assert obs_http.maybe_start() is None
        monkeypatch.setenv(obs_http.ENV_VAR, "70000")
        assert obs_http.endpoint_port() is None
        events = [e for e in obs.ledger().snapshot()["events"]
                  if e["name"] == "obs.http_bad_port"]
        assert {e["value"] for e in events} == {"not-a-port", "70000"}

    def test_live_scrape_round_trip(self):
        """A LIVE scrape loop against a running endpoint: gauges and
        histogram observations made between scrapes are visible in the
        next exposition — no restart, no cached render."""
        server = obs_http.IntrospectionServer(0).start()
        try:
            url = f"{server.url}/metrics"
            for i in range(1, 4):
                obs_metrics.set_gauge("tenant.epsilon_remaining",
                                      10.0 - i, tenant="t")
                obs_metrics.observe("serve.request_seconds",
                                    0.01 * i)
                code, text = http_get(url)
                assert code == 200
                assert (f'pdp_tenant_epsilon_remaining{{tenant="t"}} '
                        f"{obs_metrics._fmt(10.0 - i)}") in text
                assert f"pdp_serve_request_seconds_count {i}" in text
            code, doc = http_get(f"{server.url}/healthz")
            assert code == 200 and doc["status"] == "ok"
            code, doc = http_get(f"{server.url}/trace/nope")
            assert code == 404 and "unknown trace_id" in doc["error"]
            code, doc = http_get(f"{server.url}/heartbeat")
            assert code == 200
            code, doc = http_get(f"{server.url}/no-such-route")
            assert code == 404
        finally:
            server.stop()
        assert not any(t.name == "pdp-obs-http"
                       for t in threading.enumerate() if t.is_alive())

    def test_healthz_degraded_is_503(self, monkeypatch):
        server = obs_http.IntrospectionServer(0).start()
        try:
            monkeypatch.setenv("PIPELINEDP_TPU_DEGRADED", "elastic")
            code, doc = http_get(f"{server.url}/healthz")
            assert code == 503 and doc["degraded"] is True
        finally:
            server.stop()

    def test_stop_is_idempotent(self):
        server = obs_http.IntrospectionServer(0).start()
        server.stop()
        server.stop()


class TestTraceIdCli:

    def test_unknown_trace_id_cli_is_rc3(self, tmp_path):
        store = obs_store.LedgerStore(str(tmp_path / "led"))
        store.append("x", {"serve": {"ok": True}}, env={})
        rc = obs_store.main(["--summarize", "--dir",
                             str(tmp_path / "led"),
                             "--trace-id", "feedfacefeedface"])
        assert rc == 3

    def test_engine_run_under_a_bound_context_rebuilds_its_tree(
            self, monkeypatch, tmp_path):
        """A traced aggregation run under a bound request context lands
        its context-stamped spans in the run report's ``trace_spans``
        and the durable store, and ``--trace-id`` rebuilds the tree from
        the store."""
        monkeypatch.setenv("PIPELINEDP_TPU_TRACE", "1")
        obs.reset()
        rng = np.random.default_rng(0)
        ds = pdt.ArrayDataset(privacy_ids=rng.integers(0, 800, 3_000),
                              partition_keys=rng.integers(0, 8, 3_000),
                              values=rng.uniform(0.0, 10.0, 3_000))
        params = pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
            max_partitions_contributed=8,
            max_contributions_per_partition=20,
            min_value=0.0, max_value=10.0)
        with trace_context.bind(tenant="t", request_id="r") as ctx:
            with obs.run_tracer().span("request", cat="test"):
                acc = pdt.NaiveBudgetAccountant(total_epsilon=1e6,
                                                total_delta=1e-3)
                res = pdt.DPEngine(acc, pdt.TorchBackend(
                    "cpu", rng_seed=7)).aggregate(ds, params,
                                                  pdt.DataExtractors())
                acc.compute_budgets()
                assert dict(res)
        report = obs.build_run_report()
        names = {s["name"] for s in report["trace_spans"]
                 if s["args"]["trace_id"] == ctx.trace_id}
        assert {"request", "engine.encode", "engine.device",
                "engine.release"} <= names
        store_dir = str(tmp_path / "obs_ledger")
        assert obs_store.main(["--summarize", "--dir", store_dir,
                               "--trace-id", ctx.trace_id]) == 0
