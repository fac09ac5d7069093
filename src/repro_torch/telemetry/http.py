"""The live fleet-health plane: a minimal stdlib HTTP server.

Counterpart of ``repro.telemetry.http``, copied (standard library only).

The elastic runtime's coordinator already knows everything an operator asks
a fleet: the Prometheus exposition of every stream ever recorded anywhere
in the run (workers drain into the coordinator hub), the membership state
(epoch, dead/suspended workers, heartbeat ages) and the stitched recent
trace.  :class:`FleetServer` exposes exactly that over HTTP, pull-style —
the shape Prometheus/infra tooling expects — with zero new dependencies:

  ``/metrics``      text/plain Prometheus exposition (the hub's
                    ``prometheus_text``);
  ``/healthz``      JSON membership snapshot — epoch, live/dead/suspended
                    workers, heartbeat ages, current round; HTTP 200 while
                    the fleet is whole, 503 when any worker is dead or
                    suspended (so a load-balancer health check DTRT);
  ``/trace``        JSON ``{"traceEvents": [...]}`` of the recent stitched
                    spans (loadable in Perfetto as-is);
  ``/diagnostics``  JSON ``DiagnosticsMonitor.diagnose()`` report.

Routes are plain zero-argument callables returning fresh snapshots; the
server runs them on its own daemon threads, so producers hand in callbacks
that take whatever lock guards their state.  Unset routes 404; a callback
raising yields 500 with the error text rather than killing the server.
"""
from __future__ import annotations

import http.server
import json
import threading
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["FleetServer"]

Route = Callable[[], Any]


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "repro-fleet/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # keep stdout clean for the CLIs
        pass

    def do_GET(self):  # noqa: N802 (stdlib handler contract)
        path = self.path.split("?", 1)[0]
        if path != "/" and path.endswith("/"):
            path = path.rstrip("/")
        fn = self.server.routes.get(path)  # type: ignore[attr-defined]
        if fn is None:
            self._reply(404, "text/plain",
                        "not found; routes: "
                        + ", ".join(sorted(self.server.routes)))  # type: ignore[attr-defined]
            return
        try:
            status, ctype, body = fn()
        except Exception as exc:  # a broken probe must not kill the server
            self._reply(500, "text/plain", f"probe error: {exc!r}")
            return
        self._reply(status, ctype, body)

    def _reply(self, status: int, ctype: str, body) -> None:
        data = body if isinstance(body, bytes) else str(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    routes: Dict[str, Callable[[], Tuple[int, str, Any]]]


class FleetServer:
    """Serve fleet health over HTTP from producer callbacks.

    All callbacks are optional; omitted ones 404.  ``port=0`` binds an
    ephemeral port (read :attr:`port` / :attr:`url` after :meth:`start`).

    metrics:      () -> Prometheus exposition text.
    health:       () -> JSON-able dict; key ``"ok"`` (default True) decides
                  between HTTP 200 and 503.
    trace:        () -> list of Chrome trace events (recent stitched spans).
    diagnostics:  () -> JSON-able diagnose() report.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 metrics: Optional[Route] = None,
                 health: Optional[Route] = None,
                 trace: Optional[Route] = None,
                 diagnostics: Optional[Route] = None):
        self._host = host
        self._want_port = int(port)
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self._routes: Dict[str, Callable[[], Tuple[int, str, Any]]] = {}
        if metrics is not None:
            self._routes["/metrics"] = lambda: (
                200, "text/plain; version=0.0.4", metrics())
        if health is not None:
            def _health():
                snap = dict(health())
                ok = bool(snap.get("ok", True))
                return (200 if ok else 503, "application/json",
                        json.dumps(snap))
            self._routes["/healthz"] = _health
        if trace is not None:
            self._routes["/trace"] = lambda: (
                200, "application/json",
                json.dumps({"traceEvents": list(trace()),
                            "displayTimeUnit": "ms"}))
        if diagnostics is not None:
            self._routes["/diagnostics"] = lambda: (
                200, "application/json", json.dumps(diagnostics()))

    def start(self) -> "FleetServer":
        server = _Server((self._host, self._want_port), _Handler)
        server.routes = self._routes
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.1},
            name="fleet-http", daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("FleetServer not started")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
