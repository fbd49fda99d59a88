"""The port's request trace context, metric registry and introspection
endpoint (``pipelinedp_tpu_torch/obs/trace_context.py``, ``metrics.py``,
``http.py``) on the CPU: the cases of ``tests/test_metrics.py`` that need
no serve and no chaos harness. Context isolation and propagation across
threads, span parentage, histogram exactness and the Prometheus
exposition, the endpoint's lifecycle and routes, and the store's
``--trace-id`` view of an aggregation run under a bound context; and the
resident service's cases (``Service(device="cpu")``): a killed request
leaves the endpoint answering and no listener behind, a fused batch
comes back as one causal tree per request, context stamping leaves the
release bit-identical, and the per-tenant gauges and heartbeat section
under load. The chaos episode waits for ``chaos.py`` (ROADMAP step 7b).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs, serve
from pipelinedp_tpu_torch.obs import http as obs_http
from pipelinedp_tpu_torch.obs import metrics as obs_metrics
from pipelinedp_tpu_torch.obs import monitor as obs_monitor
from pipelinedp_tpu_torch.obs import report as obs_report
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
               if (t.name.startswith("pdp-serve")
                   or t.name == "pdp-obs-http") and t.is_alive()]
    assert not orphans, f"orphan threads: {orphans}"


def make_ds(seed=0, n=3_000, users=800, parts=8):
    rng = np.random.default_rng(seed)
    return pdt.ArrayDataset(privacy_ids=rng.integers(0, users, n),
                            partition_keys=rng.integers(0, parts, n),
                            values=rng.uniform(0.0, 10.0, n))


def count_params(parts=8):
    return pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
        max_partitions_contributed=parts,
        max_contributions_per_partition=20,
        min_value=0.0, max_value=10.0)


def request(tenant, ds, eps=1.0, delta=1e-8, seed=7, rid=None):
    return serve.ServeRequest(tenant=tenant, params=count_params(),
                              dataset=ds, epsilon=eps, delta=delta,
                              rng_seed=seed, request_id=rid)


def Service(*args, **kwargs):
    """``serve.Service`` on the CPU (its default device is the card)."""
    kwargs.setdefault("device", "cpu")
    return serve.Service(*args, **kwargs)


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

    def test_serve_kill_leaves_no_orphan_listener(self, monkeypatch,
                                                  tmp_path):
        """A ServeKill mid-request does not wedge the wire surface:
        the endpoint still answers afterwards, and ``close()`` joins
        the accept loop."""
        from pipelinedp_tpu_torch.resilience import (FaultPlan,
                                                     injected_faults)
        from pipelinedp_tpu_torch.resilience import faults
        monkeypatch.setenv(obs_http.ENV_VAR, "0")
        ds = make_ds()
        with injected_faults(FaultPlan(fail_serve_requests=(0,))):
            with Service(str(tmp_path / "svc"),
                         tenants={"t": (10.0, 1e-6)}) as svc:
                assert svc._http is not None
                base = svc._http.url
                with pytest.raises(faults.ServeKill):
                    svc.submit(request("t", ds, rid="req-0"))
                code, _ = http_get(f"{base}/healthz")
                assert code == 200
                ds.invalidate_cache()
                out = svc.submit(request("t", ds, rid="req-1"))
                assert out.ok, out
        assert not any(t.name == "pdp-obs-http"
                       for t in threading.enumerate() if t.is_alive())


class TestServeTraceAcceptance:

    def _walk(self, roots):
        names = []

        def rec(nodes):
            for node in nodes:
                names.append(node["name"])
                rec(node["children"])

        rec(roots)
        return names

    def test_fused_batch_reconstructs_per_request_trees(
            self, monkeypatch, tmp_path):
        """One fused batch of two tenants' requests comes back as two
        complete per-request causal trees (admission -> execution ->
        books commit) via the live ``/trace/<id>`` endpoint AND the
        durable ``store --summarize --trace-id`` twin, with flow events
        in the Chrome export and per-member links on the fused-dispatch
        span."""
        monkeypatch.setenv("PIPELINEDP_TPU_TRACE", "1")
        monkeypatch.setenv(obs_http.ENV_VAR, "0")
        obs.reset()
        ds = make_ds()
        outs = {}
        with Service(str(tmp_path / "svc"),
                     tenants={"tA": (10.0, 1e-6), "tB": (10.0, 1e-6)},
                     fusion=True, fuse_window_ms=500,
                     fuse_max_batch=4) as svc:
            base = svc._http.url

            def run(tenant):
                outs[tenant] = svc.submit(request(tenant, ds))

            threads = [threading.Thread(target=run, args=(t,))
                       for t in ("tA", "tB")]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert all(o.ok for o in outs.values()), outs
            trace_ids = {t: o.trace_id for t, o in outs.items()}
            assert len(set(trace_ids.values())) == 2

            # (a) live endpoint: a complete tree per request.
            for tenant, tid in trace_ids.items():
                code, tree = http_get(f"{base}/trace/{tid}")
                assert code == 200
                assert tree["tenant"] == tenant
                names = self._walk(tree["roots"])
                for want in ("serve.admit", "serve.request",
                             "serve.commit"):
                    assert want in names, (tenant, names)

            # (b) the fused dispatch span links every member's trace.
            snap = obs.ledger().snapshot()
            fused = [s for s in snap["spans"]
                     if s.name == "serve.fused_dispatch"]
            assert fused, "burst did not fuse"
            members = fused[0].args["members"].split(",")
            assert set(trace_ids.values()) <= set(members)

            # (c) Chrome export: flow events connect each arc.
            events = obs_report.chrome_trace_events(snap)
            flows = [e for e in events if e.get("cat") == "flow"]
            assert {e["ph"] for e in flows} == {"s", "f"}
            assert len({e["id"] for e in flows}) >= 2

        # (d) durable twin, after close: the obs-store run reports
        # carry the span deltas; the CLI reconstructs both chains.
        store_dir = str(tmp_path / "obs_ledger")
        for tenant, tid in trace_ids.items():
            rc = obs_store.main(["--summarize", "--dir", store_dir,
                                 "--trace-id", tid, "--json"])
            assert rc == 0
        rc = obs_store.main(["--summarize", "--dir", store_dir,
                             "--trace-id", trace_ids["tA"]])
        assert rc == 0

    def test_trace_context_on_off_bit_identical(self, monkeypatch,
                                                tmp_path):
        """PARITY row 42: context stamping changes only the record —
        the same seeded request through a traced+scraped service and a
        dark one releases bit-identical partitions."""
        results = {}
        for mode in ("off", "on"):
            obs.reset()
            if mode == "on":
                monkeypatch.setenv("PIPELINEDP_TPU_TRACE", "1")
                monkeypatch.setenv(obs_http.ENV_VAR, "0")
            else:
                monkeypatch.delenv("PIPELINEDP_TPU_TRACE",
                                   raising=False)
                monkeypatch.delenv(obs_http.ENV_VAR, raising=False)
            ds = make_ds(seed=3)
            with Service(str(tmp_path / f"svc-{mode}"),
                         tenants={"t": (10.0, 1e-6)}) as svc:
                out = svc.submit(request("t", ds, seed=11))
                assert out.ok, out
                # The context itself is always-on (books entries carry
                # the id either way); only SPAN recording is gated.
                assert out.trace_id
                results[mode] = dict(out.results)
        assert set(results["off"]) == set(results["on"])
        for k in results["off"]:
            assert tuple(results["off"][k]) == tuple(results["on"][k])

    def test_metrics_and_heartbeat_tenants_under_load(
            self, monkeypatch, tmp_path):
        """/metrics serves per-tenant budget gauges + the request
        latency histogram under a multi-tenant workload, and the
        heartbeat document grows the ``tenants`` section fed by the
        durable budget ledger."""
        monkeypatch.setenv(obs_http.ENV_VAR, "0")
        ds = make_ds()
        with Service(str(tmp_path / "svc"),
                     tenants={"tA": (10.0, 1e-6),
                              "tB": (4.0, 1e-6)}) as svc:
            for tenant in ("tA", "tB"):
                ds.invalidate_cache()
                assert svc.submit(request(tenant, ds)).ok
            code, text = http_get(f"{svc._http.url}/metrics")
            assert code == 200
            assert 'pdp_tenant_epsilon_remaining{tenant="tA"} 9' in text
            assert 'pdp_tenant_epsilon_remaining{tenant="tB"} 3' in text
            assert 'pdp_tenant_reserves_in_flight{tenant="tA"} 0' in text
            assert "pdp_serve_request_seconds_bucket" in text
            assert "pdp_serve_queue_depth" in text
            assert "pdp_tenant_epsilon_burn_per_s" in text
            code, hb = http_get(f"{svc._http.url}/heartbeat")
            assert code == 200
            tenants = hb["tenants"]
            assert tenants["tA"]["epsilon_remaining"] == pytest.approx(
                9.0)
            assert tenants["tB"]["epsilon_remaining"] == pytest.approx(
                3.0)
            assert tenants["tA"]["reserves_in_flight"] == 0


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
