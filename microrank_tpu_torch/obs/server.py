"""Optional HTTP metrics endpoint (``cli run --metrics-port N``),
counterpart of ``microrank_tpu/obs/server.py``.

A stdlib ``ThreadingHTTPServer`` on a daemon thread: no new dependency,
nothing listening unless asked. Routes:

* ``/metrics``      — Prometheus text exposition (scrape target);
* ``/metrics.json`` — the JSON snapshot form;
* ``/healthz``      — liveness probe;
* ``/explainz``     — the rank-provenance store (``explain.store``):
  ``{"windows": [...], "latest": bundle}``, or with ``?window=<start>``
  that window's bundle (404 naming the windows held when none is);
* ``/profilez``     — the JAX package's on-demand device profile
  session, not ported: it answers 501 with a JSON body naming the
  ROADMAP.md item that brings it, so a client learns the route exists
  and why it cannot answer.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import MetricsRegistry, get_registry

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Routes of the JAX package's server this package does not serve yet.
NOT_PORTED = {
    "/profilez": (
        "on-demand device profile sessions (the JAX package's "
        "jax.profiler capture) are not ported: ROADMAP.md 'Port queue' "
        "item 11"
    ),
}


def _explainz(query: str):
    """(status, body) of ``GET /explainz`` (JAX's ``_explainz``)."""
    from urllib.parse import parse_qs

    from ..explain.store import get_explain_store

    store = get_explain_store()
    window = parse_qs(query).get("window", [None])[0]
    if window is None:
        return 200, json.dumps({"windows": store.windows(), "latest": store.latest()}).encode()
    bundle = store.get(window)
    if bundle is None:
        return 404, json.dumps({"error": f"no explain bundle for window {window!r}",
                                "windows": store.windows()}).encode()
    return 200, json.dumps(bundle).encode()


def _make_handler(registry: MetricsRegistry):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            route, _, query = self.path.partition("?")
            status = 200
            if route == "/metrics":
                body = registry.to_prometheus().encode()
                ctype = PROM_CONTENT_TYPE
            elif route == "/metrics.json":
                body = json.dumps(registry.to_json()).encode()
                ctype = "application/json"
            elif route == "/healthz":
                body = b"ok\n"
                ctype = "text/plain"
            elif route == "/explainz":
                status, body = _explainz(query)
                ctype = "application/json"
            elif route in NOT_PORTED:
                status = 501
                body = json.dumps(
                    {"error": "not implemented", "route": route,
                     "reason": NOT_PORTED[route]}
                ).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # scrapes are not log events
            pass

    return Handler


class MetricsServer:
    """Owns the listening socket and the serving thread; ``close()`` to
    stop."""

    def __init__(self, port: int, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1"):
        if registry is None:
            from .metrics import ensure_catalog

            ensure_catalog()  # scrapes see the full catalog from poll 1
            registry = get_registry()
        self.httpd = ThreadingHTTPServer((host, int(port)), _make_handler(registry))
        self.port = self.httpd.server_address[1]  # resolved (port 0 = any)
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            name="mr-metrics",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5.0)


def start_metrics_server(
    port: int, registry: Optional[MetricsRegistry] = None
) -> MetricsServer:
    """Start serving the registry on 127.0.0.1:``port`` (0 picks a free
    port)."""
    return MetricsServer(port, registry)
