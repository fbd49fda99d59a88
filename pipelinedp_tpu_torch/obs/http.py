"""Read-only introspection endpoint: the repo's first wire surface.

A resident multi-tenant DP service needs to answer "what is this
process doing, and is it healthy?" WITHOUT a debugger attached — and
the answer must come from the observability plane the process already
maintains, not a parallel bookkeeping path. This module is a thin
stdlib ``http.server`` veneer over exactly those existing registries:

* ``GET /metrics``   — Prometheus text exposition (format 0.0.4):
  run-ledger counters as ``_total`` counters, the metrics registry's
  per-tenant budget gauges and phase latency histograms
  (``obs.metrics.render_prometheus``);
* ``GET /healthz``   — 200 ``ok`` / 503 ``degraded``: the degraded
  env marker plus the serve-health and mesh push registries;
* ``GET /heartbeat`` — the live monitor's last heartbeat document
  verbatim (or a thin fallback from the push registries when the
  monitor thread is off);
* ``GET /trace/<id>`` — one request's causal span tree from the live
  ledger (``obs.report.build_trace_tree``); the durable twin is
  ``python -m pipelinedp_tpu_torch.obs.store --summarize --trace-id``.

Gating: ``PIPELINEDP_TPU_METRICS_PORT`` unset or empty means OFF —
no thread, no socket, zero overhead (``maybe_start`` returns None
without importing the server machinery). ``"0"`` binds an ephemeral
port (tests read :attr:`IntrospectionServer.port` afterwards); any
other value is the port. A bind failure (port taken) records an
``obs.http_bind_failed`` event and reports None — an introspection
endpoint must never take the service down.

Read-only by construction: only ``GET`` is implemented, every answer
is a snapshot render, and nothing here mutates a registry. The raw
``http.server``/``socketserver`` import is confined to THIS module by
the ``socket-confinement`` lint rule — every other module speaks to
the wire through :func:`maybe_start`.

Threading: the accept loop runs on one ``pdp-obs-http``
:class:`~pipelinedp_tpu_torch.ingest.executor._CaptureThread` (imported
lazily at start, like the monitor); per-connection handler threads are
daemon and connection-scoped. ``stop()`` shuts the loop down and joins
it — the serve lifecycle (``Service.close``) and the chaos campaign's
orphan-drain check both rely on a clean join.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

ENV_VAR = "PIPELINEDP_TPU_METRICS_PORT"

#: Loopback only: this is an introspection surface for the operator on
#: the host, not a public listener — binding wide would make every
#: tenant's budget arithmetic readable off-box.
DEFAULT_HOST = "127.0.0.1"


def endpoint_port() -> Optional[int]:
    """The configured port, or None when the endpoint is off (unset,
    empty, or unparseable — a typo'd port must not crash startup)."""
    raw = os.environ.get(ENV_VAR, "")
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        from pipelinedp_tpu_torch import obs
        obs.event("obs.http_bad_port", value=raw)
        return None
    if port < 0 or port > 65535:
        from pipelinedp_tpu_torch import obs
        obs.event("obs.http_bad_port", value=raw)
        return None
    return port


def _healthz_payload() -> Tuple[int, Dict[str, Any]]:
    """(status_code, document) for ``/healthz``: 503 whenever the
    process is degraded — the env marker the resilience layer sets
    (string literal: this module must not import resilience) or a
    degraded serve-health push."""
    from pipelinedp_tpu_torch.obs import monitor
    serve = monitor.serve_health_snapshot()
    mesh = monitor.mesh_snapshot()
    degraded = bool(os.environ.get("PIPELINEDP_TPU_DEGRADED"))
    if isinstance(serve, dict) and serve.get("degraded"):
        degraded = True
    doc: Dict[str, Any] = {
        "status": "degraded" if degraded else "ok",
        "degraded": degraded,
    }
    if serve is not None:
        doc["serve"] = serve
    if mesh is not None:
        doc["mesh"] = mesh
    return (503 if degraded else 200), doc


def _heartbeat_payload() -> Tuple[int, Dict[str, Any]]:
    """(status_code, document) for ``/heartbeat``: the monitor's last
    heartbeat verbatim when the monitor runs; otherwise a thin
    fallback assembled from the live push registries so the endpoint
    stays useful with ``PIPELINEDP_TPU_HEARTBEAT`` off."""
    from pipelinedp_tpu_torch.obs import monitor
    hb = monitor.heartbeat_payload()
    if hb is not None:
        return 200, hb
    fallback: Dict[str, Any] = {"monitor": "off"}
    for key, snap in (("serve", monitor.serve_health_snapshot()),
                      ("fusion", monitor.fusion_snapshot()),
                      ("mesh", monitor.mesh_snapshot()),
                      ("tenants", monitor.tenants_snapshot()),
                      ("requests", monitor.live_requests() or None)):
        if snap is not None:
            fallback[key] = snap
    return 200, fallback


def _trace_payload(trace_id: str) -> Tuple[int, Dict[str, Any]]:
    """(status_code, document) for ``/trace/<id>``: the causal span
    tree over the LIVE ledger snapshot (404 when the id matches
    nothing — including when tracing was simply off)."""
    from pipelinedp_tpu_torch import obs
    from pipelinedp_tpu_torch.obs.report import build_trace_tree
    snapshot = obs.ledger().snapshot()
    spans = [s.to_dict() for s in snapshot.get("spans", [])
             if s.args.get("trace_id") == trace_id]
    tree = build_trace_tree(trace_id, spans,
                            snapshot.get("events", []))
    if not tree["span_count"] and not tree["event_count"]:
        return 404, {"error": f"unknown trace_id {trace_id!r} "
                     "(was PIPELINEDP_TPU_TRACE set?)"}
    return 200, tree


class IntrospectionServer:
    """One read-only HTTP listener over the observability plane.

    ``start()`` binds and spawns the ``pdp-obs-http`` accept thread
    (raising ``OSError`` if the port is taken — :func:`maybe_start`
    is the never-raises wrapper); ``stop()`` shuts the loop down,
    closes the socket, and joins the thread. Idempotent both ways.
    """

    def __init__(self, port: int, host: str = DEFAULT_HOST):
        self._requested = (host, int(port))
        self._server: Any = None
        self._thread: Any = None
        self._lock = threading.Lock()

    @property
    def port(self) -> Optional[int]:
        """The BOUND port (resolves ``port=0`` to the ephemeral one)."""
        if self._server is None:
            return None
        return int(self._server.server_address[1])

    @property
    def url(self) -> Optional[str]:
        if self._server is None:
            return None
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "IntrospectionServer":
        with self._lock:
            if self._server is not None:
                return self
            # Lazy stdlib import: a process that never turns the
            # endpoint on never touches the socket machinery at all.
            from http.server import (BaseHTTPRequestHandler,
                                     ThreadingHTTPServer)

            class _Handler(BaseHTTPRequestHandler):
                # Read-only surface: GET only, and never log to
                # stderr (a scrape loop would spam every poll).
                def log_message(self, fmt, *args):  # noqa: D102
                    pass

                def _send(self, code: int, body: bytes,
                          content_type: str) -> None:
                    self.send_response(code)
                    self.send_header("Content-Type", content_type)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def _send_json(self, code: int,
                               doc: Dict[str, Any]) -> None:
                    body = json.dumps(doc, default=repr).encode("utf-8")
                    self._send(code, body, "application/json")

                def do_GET(self):  # noqa: N802 (stdlib handler name)
                    try:
                        self._route()
                    except BrokenPipeError:
                        pass  # scraper hung up mid-response
                    except Exception as exc:
                        from pipelinedp_tpu_torch import obs
                        obs.event("obs.http_handler_error",
                                  path=self.path, error=repr(exc))
                        try:
                            self._send_json(500, {"error": repr(exc)})
                        except Exception:
                            pass

                def _route(self):
                    from pipelinedp_tpu_torch import obs
                    path = self.path.split("?", 1)[0]
                    obs.inc("obs.http_requests")
                    if path in ("/", ""):
                        self._send_json(200, {"endpoints": [
                            "/metrics", "/healthz", "/heartbeat",
                            "/trace/<trace_id>"]})
                    elif path == "/metrics":
                        from pipelinedp_tpu_torch.obs import metrics
                        body = metrics.render_prometheus()
                        self._send(200, body.encode("utf-8"),
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif path == "/healthz":
                        self._send_json(*_healthz_payload())
                    elif path == "/heartbeat":
                        self._send_json(*_heartbeat_payload())
                    elif path.startswith("/trace/"):
                        self._send_json(
                            *_trace_payload(path[len("/trace/"):]))
                    else:
                        self._send_json(404,
                                        {"error": f"no route {path}"})

            server = ThreadingHTTPServer(self._requested, _Handler)
            server.daemon_threads = True
            # Like the monitor: _CaptureThread lives in the ingest
            # executor; import it lazily so obs stays import-light.
            from pipelinedp_tpu_torch.ingest.executor import _CaptureThread
            thread = _CaptureThread(server.serve_forever,
                                    name="pdp-obs-http")
            self._server = server
            self._thread = thread
            thread.start()
            from pipelinedp_tpu_torch import obs
            obs.event("obs.http_started", host=self._requested[0],
                      port=self.port)
            return self

    def stop(self) -> None:
        with self._lock:
            server, thread = self._server, self._thread
            self._server = self._thread = None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        if thread is not None:
            thread.join(timeout=10.0)
        from pipelinedp_tpu_torch import obs
        obs.event("obs.http_stopped")


def maybe_start(port: Optional[int] = None
                ) -> Optional[IntrospectionServer]:
    """Start an endpoint if configured; never raises. ``port=None``
    reads ``PIPELINEDP_TPU_METRICS_PORT`` (off when unset/empty); a
    bind failure records ``obs.http_bind_failed`` and returns None —
    callers (``serve.Service``, ``bench.py``) continue without the
    endpoint either way."""
    if port is None:
        port = endpoint_port()
    if port is None:
        return None
    server = IntrospectionServer(port)
    try:
        return server.start()
    except OSError as exc:
        from pipelinedp_tpu_torch import obs
        obs.event("obs.http_bind_failed", port=port, error=repr(exc))
        return None
