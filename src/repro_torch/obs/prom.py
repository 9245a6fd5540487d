"""Prometheus text-format exposition of the live STATS payload.

A port of ``src/repro/obs/prom.py``, with the same metric names (the
``repro_*`` names are the contract with existing scrapers):

* :func:`render_prometheus` turns one STATS payload (the dict
  :meth:`repro_torch.cluster.runtime.ClusterRuntime._stats_payload`
  pushes to ``top`` clients) into Prometheus text exposition format
  0.0.4: ``repro_grads_applied_total``, staleness quantile gauges,
  fleet gauges and, given the telemetry counter dict, one
  ``repro_<name>_total`` counter per bus counter
  (``repro_wire_tx_bytes_total``, ...);

* :class:`PromServer` serves ``GET /metrics`` from a provider callable
  that returns the newest payload (nothing yet: 503, so Prometheus
  records the target down instead of parsing garbage).  It is mounted
  by the training leader (``--prom-port N``: the runtime's live payload
  and counters) and by ``python -m repro_torch top --prom-port N`` (the
  last STATS push received, so a box that reaches the leader's wire
  port can re-export it without touching the run).

The endpoint is read-only and takes no lock of the training loop beyond
what the STATS payload takes.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# STATS payload key -> (metric name, TYPE, HELP).  Only keys present
# (and numeric) in the payload are emitted, so older/newer payloads
# render cleanly.
_PAYLOAD_METRICS = [
    ("t", "repro_uptime_seconds", "gauge",
     "Wall-clock seconds since the run's clock started"),
    ("version", "repro_params_version", "gauge",
     "Current published params version"),
    ("applied", "repro_grads_applied_total", "counter",
     "Gradients applied to the master params"),
    ("dropped", "repro_grads_dropped_total", "counter",
     "Gradients dropped (stale beyond tolerance)"),
    ("buffered", "repro_grads_buffered", "gauge",
     "Gradients held in the staging buffer"),
    ("pending_round", "repro_grads_pending_round", "gauge",
     "Gradients of the current unfinished sync round"),
    ("updates", "repro_updates_total",
     "counter", "Optimizer updates (flushes) performed"),
    ("optimizer_steps", "repro_optimizer_steps_total", "counter",
     "Fused flush+optimizer steps applied on the params slab"),
    ("queue_depth", "repro_queue_depth", "gauge",
     "Gradients waiting in the transport channel"),
    ("live_workers", "repro_live_workers", "gauge",
     "Workers currently registered with the server"),
    ("num_workers", "repro_seed_workers", "gauge",
     "Seed fleet size (cluster_workers)"),
    ("fleet_size", "repro_fleet_size", "gauge",
     "Current fleet size (seed + elastic admissions)"),
    ("max_workers", "repro_max_workers", "gauge",
     "Elastic admission ceiling"),
    ("serve_clients", "repro_serve_clients", "gauge",
     "Connected read-only serve subscribers"),
]


def _sanitize(name: str) -> str:
    """Telemetry counter name -> metric-name fragment (dots and every
    other non-alphanumeric become underscores)."""
    return "".join(c if c.isalnum() else "_" for c in name)


def render_prometheus(doc: Optional[Dict[str, Any]],
                      counters: Optional[Dict[str, int]] = None) -> str:
    """One STATS payload (+ optional telemetry counter snapshot) as
    Prometheus text exposition format."""
    lines = []
    doc = doc or {}
    emitted = set()
    for key, metric, mtype, hlp in _PAYLOAD_METRICS:
        v = doc.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        emitted.add(metric)
        lines.append(f"# HELP {metric} {hlp}")
        lines.append(f"# TYPE {metric} {mtype}")
        lines.append(f"{metric} {v}")
    st = doc.get("staleness")
    if isinstance(st, dict):
        rows = [(q, st.get(p)) for q, p in (("0.5", "p50"),
                                            ("0.99", "p99"))
                if isinstance(st.get(p), (int, float))]
        if rows:
            lines.append("# HELP repro_staleness_versions Gradient "
                         "staleness in params versions")
            lines.append("# TYPE repro_staleness_versions gauge")
            for q, v in rows:
                lines.append('repro_staleness_versions{quantile="'
                             f'{q}"}} {v}')
    if isinstance(doc.get("mode"), str):
        labels = [f'mode="{doc["mode"]}"']
        if isinstance(doc.get("optimizer"), str):
            labels.append(f'optimizer="{doc["optimizer"]}"')
        lines.append("# HELP repro_run_info Run mode/optimizer as labels")
        lines.append("# TYPE repro_run_info gauge")
        lines.append(f'repro_run_info{{{",".join(labels)}}} 1')
    for name in sorted(counters or {}):
        v = counters[name]
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        metric = f"repro_{_sanitize(name)}_total"
        if metric in emitted:
            # already rendered from the STATS payload (e.g.
            # optimizer_steps): a second series with the same name
            # would be an invalid exposition
            continue
        lines.append(f"# HELP {metric} Telemetry counter {name}")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {v}")
    return "\n".join(lines) + "\n"


class PromServer:
    """A `/metrics` endpoint over a payload provider.

    ``provider()`` is called per scrape and must return
    ``(stats_payload, counters)`` — either may be None.  Runs its own
    daemon threads (stdlib ThreadingHTTPServer); :meth:`close` is
    idempotent.  ``port=0`` picks an ephemeral port; the resolved one
    is on :attr:`port` after construction.
    """

    def __init__(self, provider: Callable[[], tuple], port: int,
                 host: str = "0.0.0.0"):
        self._provider = provider
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):              # noqa: N802 (stdlib casing)
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    doc, counters = outer._provider()
                except Exception:          # a dying run must not 500-loop
                    doc, counters = None, None
                if doc is None and not counters:
                    self.send_response(503)
                    self.send_header("Retry-After", "1")
                    self.end_headers()
                    return
                body = render_prometheus(doc, counters).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", _CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):      # scrapes are not log lines
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="prom-server",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
