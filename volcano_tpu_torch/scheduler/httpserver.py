"""Served observability endpoints: /metrics and /healthz.

The reference serves Prometheus metrics on ``:8080/metrics`` through the
default mux (cmd/scheduler/app/server.go:97-100) and a healthz probe on
``127.0.0.1:11251`` via apis/helpers.go:164 StartHealthz. Here one
ThreadingHTTPServer per address serves:

- ``/metrics``  — ``volcano_tpu_torch.scheduler.metrics.render()`` (the 9 series
  with the reference's exact names, metrics.py);
- ``/healthz``  — 200 ``ok`` while the supplied ``healthy()`` callable holds
  (mirrors the max-frame-grace healthz check semantics: report unhealthy when
  the scheduler loop stops making progress).
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

from volcano_tpu_torch.scheduler import metrics

logger = logging.getLogger(__name__)


def _parse_address(address: str, default_host: str = "") -> Tuple[str, int]:
    """':8080' -> (default_host, 8080); '127.0.0.1:11251' -> pair."""
    host, _, port = address.rpartition(":")
    return host or default_host, int(port)


class ObservabilityServer:
    """Serves /metrics and /healthz on one address; port 0 picks a free
    port (exposed as ``.port`` after start)."""

    def __init__(self, address: str = ":0",
                 healthy: Optional[Callable[[], bool]] = None):
        self._address = _parse_address(address)
        self._healthy = healthy or (lambda: True)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    def start(self) -> "ObservabilityServer":
        healthy = self._healthy

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] == "/metrics":
                    body = metrics.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4")
                elif self.path.split("?", 1)[0] == "/healthz":
                    ok = False
                    try:
                        ok = bool(healthy())
                    except Exception:
                        logger.exception("healthz check failed")
                    body = b"ok" if ok else b"unhealthy"
                    self.send_response(200 if ok else 500)
                    self.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                logger.debug("http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer(self._address, Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
