"""Scrape endpoints: a stdlib ``http.server`` on a background thread.

Counterpart of ``flashmoe_tpu/telemetry_plane/server.py``.  Three
read-only endpoints over the live process, with no thread unless armed:

* ``GET /metrics``: the Prometheus text exposition of a
  :class:`~flashmoe_tpu_torch.utils.telemetry.Metrics` registry, served
  as :data:`~flashmoe_tpu_torch.utils.telemetry.PROM_CONTENT_TYPE`;
* ``GET /healthz``: liveness and the job's health narrative as JSON (SLO
  episode state, last checkpoint step, serving queue and occupancy:
  whatever the arming caller's ``health_fn`` gives);
* ``GET /vars``: a JSON snapshot of the resolved plan and the active
  config knobs (``vars_fn``).

Armed by ``--telemetry-port`` on ``python -m flashmoe_tpu_torch.serving``
and ``python -m flashmoe_tpu_torch.runtime.train_cli``, or by the
``telemetry_port=`` argument of ``ServingEngine``, ``train``,
``resilient_train`` and ``supervise``.  Port 0 binds an ephemeral port;
the bound one is on ``server.port`` and in the
``telemetry.server_start`` decision.  :func:`host_shard_path` names one
JSONL shard per host.
"""

from __future__ import annotations

import http.server
import json
import os
import socket
import threading

from flashmoe_tpu_torch.utils.telemetry import (
    PROM_CONTENT_TYPE, metrics as _global_metrics,
)


def host_shard_path(obs_dir: str, host: str | None = None) -> str:
    """The per-host telemetry shard file: ``telemetry.<host>.jsonl``
    under ``obs_dir``.  Host id: explicit arg, else ``FLASHMOE_HOST_ID``
    (the mocked-multislice drills set one per simulated host), else the
    machine hostname."""
    host = (host or os.environ.get("FLASHMOE_HOST_ID")
            or socket.gethostname() or "host0")
    safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in host)
    return os.path.join(obs_dir, f"telemetry.{safe}.jsonl")


class TelemetryServer:
    """Background scrape server.  ``metrics_fn`` resolves the
    :class:`Metrics` registry per request (a zero-arg callable, so a
    sweep can rotate per-point streams under one server); ``health_fn``
    / ``vars_fn`` return JSON-serializable dicts (both optional —
    ``/healthz`` always answers with at least ``{"ok": true}``)."""

    def __init__(self, port: int, *, metrics_fn=None, health_fn=None,
                 vars_fn=None, host: str = "127.0.0.1",
                 metrics_obj=None):
        if metrics_fn is None:
            obj = metrics_obj if metrics_obj is not None \
                else _global_metrics
            metrics_fn = lambda: obj  # noqa: E731 — default resolver
        self._metrics_fn = metrics_fn
        self._health_fn = health_fn
        self._vars_fn = vars_fn
        self._host = host
        self._want_port = int(port)
        self.port: int | None = None
        self._httpd = None
        self._thread = None

    # ---- lifecycle ---------------------------------------------------

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D102 — quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        text = outer._metrics_fn().prometheus_text()
                        self._send(200, text.encode(),
                                   PROM_CONTENT_TYPE)
                    elif path == "/healthz":
                        doc = {"ok": True}
                        if outer._health_fn is not None:
                            doc.update(outer._health_fn() or {})
                        self._send(200, json.dumps(doc).encode(),
                                   "application/json")
                    elif path == "/vars":
                        doc = (outer._vars_fn() or {}
                               if outer._vars_fn is not None else {})
                        self._send(200, json.dumps(doc).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # noqa: BLE001 — a scrape must
                    # never kill the job it observes
                    self._send(500, f"{type(e).__name__}: {e}\n"
                               .encode(), "text/plain")

        self._httpd = http.server.ThreadingHTTPServer(
            (self._host, self._want_port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="flashmoe-telemetry", daemon=True)
        self._thread.start()
        self._metrics_fn().decision("telemetry.server_start",
                                    port=self.port, host=self._host)
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._metrics_fn().decision("telemetry.server_stop",
                                    port=self.port)
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def maybe_server(port: int | None, **kw) -> TelemetryServer | None:
    """``None``/falsy-but-not-0 port = live plane off = no thread, no
    behavior change; a port (0 = ephemeral) arms a started server."""
    if port is None:
        return None
    return TelemetryServer(int(port), **kw).start()


def scrape(url: str, timeout_s: float = 5.0) -> tuple[str, str]:
    """GET one endpoint; returns (body, content_type).  Stdlib only."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return (r.read().decode(), r.headers.get("Content-Type", ""))
