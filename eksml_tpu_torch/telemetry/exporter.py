"""Dependency-free OpenMetrics HTTP exporter with ``/healthz`` and
``/debugz`` (the port of ``eksml_tpu/telemetry/exporter.py``).

It serves the process-local
:class:`~eksml_tpu_torch.telemetry.registry.MetricRegistry`:

- ``GET /metrics`` — OpenMetrics text (``# TYPE``/``# HELP`` per
  family, counters with the ``_total`` suffix, cumulative histogram
  buckets with the ``+Inf`` bound, a closing ``# EOF``); the serving
  front-end answers its own ``/metrics`` with :func:`render_openmetrics`.
- ``GET /healthz`` — JSON liveness with the process uptime plus what the
  installed ``health_fn`` reports (the fit loop's last step).  With
  ``stale_after_sec > 0`` it answers 503 "stale" once the reported
  ``seconds_since_last_step`` exceeds the bound, so a livenessProbe
  restarts a wedged pod.
- ``GET /debugz/profile?steps=N`` — asks the fit loop for a bounded
  ``torch.profiler`` capture through the installed
  :class:`~eksml_tpu_torch.telemetry.tracing.ProfileTrigger`: 200 when
  accepted, 429 with the reason when the cooldown, the budget or a
  pending capture refuses it, 503 without a trigger.
- ``GET /debugz/stacks`` — all-thread stack dump (text/plain).

A failed bind logs a warning (an error when a liveness bound is set)
and leaves the exporter disabled: observability never takes down
training.  ``port=0`` binds an ephemeral port, published as
:attr:`TelemetryExporter.port` and, written write-then-rename, in
``port_file``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs

from eksml_tpu_torch.telemetry.registry import (COUNTER, GAUGE, HISTOGRAM,
                                                MetricRegistry,
                                                default_registry)

log = logging.getLogger(__name__)

CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(labels, extra: Optional[Dict[str, str]] = None) -> str:
    pairs = list(labels) + sorted((extra or {}).items())
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + body + "}"


def render_openmetrics(registry: Optional[MetricRegistry] = None) -> str:
    """The registry as an OpenMetrics text exposition (ends ``# EOF``)."""
    registry = registry or default_registry()
    out = []
    for fam in registry.collect():
        out.append(f"# TYPE {fam.name} {fam.kind}")
        if fam.help:
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        for key in sorted(fam.series):
            s = fam.series[key]
            if fam.kind == COUNTER:
                out.append(f"{fam.name}_total{_labels_str(key)} "
                           f"{_fmt(s.value)}")
            elif fam.kind == GAUGE:
                out.append(f"{fam.name}{_labels_str(key)} "
                           f"{_fmt(s.value)}")
            elif fam.kind == HISTOGRAM:
                cum, total_sum, count = s.snapshot()
                bounds = [_fmt(b) for b in s.buckets] + ["+Inf"]
                for bound, c in zip(bounds, cum):
                    ls = _labels_str(key, {"le": bound})
                    out.append(f"{fam.name}_bucket{ls} {c}")
                out.append(f"{fam.name}_count{_labels_str(key)} {count}")
                out.append(f"{fam.name}_sum{_labels_str(key)} "
                           f"{_fmt(total_sum)}")
    out.append("# EOF")
    return "\n".join(out) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # set by the exporter on the handler class it instantiates
    exporter: "TelemetryExporter"

    def _send_json(self, code: int, payload: Dict) -> None:
        body = (json.dumps(payload) + "\n").encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            try:
                body = render_openmetrics(
                    self.exporter.registry).encode("utf-8")
            except Exception:  # noqa: BLE001 — scrape must not 500 the pod
                log.exception("metric exposition failed")
                self.send_error(500)
                return
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/healthz":
            payload = {"status": "ok",
                       "uptime_sec": round(
                           time.monotonic()
                           - self.exporter.started_monotonic, 1)}
            fn = self.exporter.health_fn
            if fn is not None:
                try:
                    payload.update(fn())
                except Exception:  # noqa: BLE001 — health stays up
                    payload["health_fn_error"] = True
            # liveness semantics: past the staleness bound the probe
            # must see a FAILURE code — a wedged step loop behind an
            # eternally-200 healthz is exactly the silent hang the
            # bound exists to catch
            code = 200
            bound = self.exporter.stale_after_sec
            since = payload.get("seconds_since_last_step")
            if (bound and bound > 0 and isinstance(since, (int, float))
                    and since > bound):
                payload["status"] = "stale"
                payload["stale_after_sec"] = bound
                code = 503
            self._send_json(code, payload)
        elif path == "/debugz/profile":
            trigger = self.exporter.profile_trigger
            if trigger is None:
                self._send_json(503, {
                    "status": "unavailable",
                    "detail": "no profile trigger installed (is a "
                              "fit loop running?)"})
                return
            params = parse_qs(query)
            steps = (params.get("steps", [None])[0])
            ok, detail = trigger.request(steps=steps, reason="debugz")
            payload = {"status": "accepted" if ok else "rejected",
                       "detail": detail}
            payload.update(trigger.status())
            self._send_json(200 if ok else 429, payload)
        elif path == "/debugz/stacks":
            from eksml_tpu_torch.telemetry.tracing import \
                format_thread_stacks

            try:
                body = format_thread_stacks().encode("utf-8")
            except Exception:  # noqa: BLE001 — debug must not 500
                log.exception("stack dump failed")
                self.send_error(500)
                return
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)

    def log_message(self, fmt, *args):  # scrapes are not pod-log news
        log.debug("telemetry http: " + fmt, *args)


class TelemetryExporter:
    """Threaded exporter bound to ``addr:port`` (0 = ephemeral)."""

    def __init__(self, port: int = 9090, addr: str = "0.0.0.0",
                 registry: Optional[MetricRegistry] = None,
                 health_fn: Optional[Callable[[], Dict]] = None,
                 port_file: Optional[str] = None,
                 profile_trigger=None,
                 stale_after_sec: float = 0.0):
        self.registry = registry or default_registry()
        self.health_fn = health_fn
        # ProfileTrigger (telemetry/tracing.py) serving /debugz/profile;
        # None = the endpoint answers 503 "unavailable"
        self.profile_trigger = profile_trigger
        # /healthz returns 503 once health_fn's seconds_since_last_step
        # exceeds this bound (0 = legacy always-200 behavior)
        self.stale_after_sec = float(stale_after_sec or 0.0)
        self.requested_port = int(port)
        self.addr = addr
        self.port_file = port_file
        self.started_monotonic = time.monotonic()
        self.port: Optional[int] = None  # bound port once started
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetryExporter":
        if self._server is not None:
            return self
        handler = type("BoundHandler", (_Handler,), {"exporter": self})
        try:
            server = ThreadingHTTPServer((self.addr, self.requested_port),
                                         handler)
        except OSError as e:
            # never fatal: on a shared box only the first process wins
            # the fixed port (the trainer binds from local rank 0 only,
            # so the ranks of one pod never race for it)
            log.warning("telemetry exporter disabled: cannot bind "
                        "%s:%d (%s)", self.addr, self.requested_port, e)
            if self.stale_after_sec > 0:
                # a chart-rendered livenessProbe is now probing a dead
                # port: connection refused counts as a probe failure
                # and kubelet will restart the pod — escalate so the
                # pod log names the cause before the restart loop does
                log.error(
                    "a /healthz liveness bound is configured "
                    "(stale_after_sec=%s) but the exporter could not "
                    "bind — any livenessProbe on this port will fail "
                    "and restart the pod", self.stale_after_sec)
            return self
        server.daemon_threads = True
        self._server = server
        self.port = server.server_address[1]
        self.started_monotonic = time.monotonic()
        self._thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.1},
            name="eksml-telemetry-http", daemon=True)
        self._thread.start()
        if self.port_file:
            # write-then-rename: a reader polling for the file's
            # existence must never catch it created-but-empty (the
            # chaos rungs parse it the instant it appears)
            try:
                tmp = self.port_file + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(self.port))
                os.replace(tmp, self.port_file)
            except OSError:
                log.warning("could not write telemetry port file %s",
                            self.port_file)
        log.info("telemetry exporter serving /metrics, /healthz and "
                 "/debugz on port %d", self.port)
        return self

    @property
    def running(self) -> bool:
        return self._server is not None

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.port = None
