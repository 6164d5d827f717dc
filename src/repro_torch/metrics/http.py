"""Stdlib HTTP listener exposing a :class:`MetricsPlane` for scraping
(counterpart of ``repro/metrics/http.py``).

Prometheus text at ``/metrics``, the JSON snapshot at ``/metrics.json`` and
a trivial ``/healthz`` — the same surface the fleet daemon serves, here as a
sidecar thread inside ``launch.serve`` / ``launch.train`` so a single
training or serving process is scrapeable with nothing but ``--metrics-port``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import urlparse

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    plane: Any = None

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        self.shutdown()
        self.server_close()


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt: str, *args: Any) -> None:  # quiet by default
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        path = urlparse(self.path).path
        plane = self.server.plane
        try:
            if path == "/metrics":
                self._send(200, plane.render().encode(), PROM_CONTENT_TYPE)
            elif path == "/metrics.json":
                body = json.dumps(plane.snapshot(), default=repr).encode()
                self._send(200, body, "application/json")
            elif path == "/healthz":
                self._send(200, b'{"ok": true}', "application/json")
            else:
                self._send(404, b'{"error": "not found"}', "application/json")
        except Exception as exc:
            self._send(500, json.dumps({"error": repr(exc)}).encode(),
                       "application/json")


def serve_metrics(plane: Any, port: int = 0,
                  host: str = "127.0.0.1") -> MetricsHTTPServer:
    """Start a daemon-thread scrape endpoint; ``port=0`` picks a free port."""
    server = MetricsHTTPServer((host, port), _Handler)
    server.plane = plane
    threading.Thread(target=server.serve_forever,
                     name="repro-metrics-http", daemon=True).start()
    return server
