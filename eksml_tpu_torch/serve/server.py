"""HTTP front-end: ``POST /v1/predict`` + ``POST /admin/reload`` +
``/healthz`` + ``/metrics`` (the port of ``eksml_tpu/serve/server.py``).

The ``TelemetryExporter`` pattern (telemetry/exporter.py) applied to
serving: a daemon-threaded stdlib ``ThreadingHTTPServer`` — no new
dependency — with one listener carrying the data plane and the
observability plane:

- ``POST /v1/predict`` — image in (raw JPEG/PNG bytes with an
  ``image/*`` content type, or JSON ``{image_b64, shape[, dtype,
  score_thresh, masks]}`` for raw RGB arrays), ``DetectionResult``
  JSON out, with the request's span-derived ``timings_ms`` breakdown
  (queue_wait / pad / device_infer / postprocess / total) and its
  (bucket, batch-rung) placement.  429 on a full queue, 503 while
  warming or draining.
- ``GET /healthz`` — READINESS with real gating: 503 "warming" until
  :meth:`InferenceEngine.warmup` completed (a pod never joins the
  Service with a cold compile on its request path), 200 "ok" while
  serving, 503 "draining" after SIGTERM so the Service stops routing
  new work during the flush.  The payload carries the engine/batcher
  state a load test reads (compile counters,
  queue depth, device count).
- ``POST /admin/reload`` — verified checkpoint hot-reload on demand
  (``serve/reload.py``): JSON ``{"step": N}`` or an empty body for the
  newest candidate; 200 with the outcome, 409 on a rejection (the old
  params keep serving), 503 without a reload manager.
- ``GET /metrics`` — the process registry as OpenMetrics, the
  ``eksml_serve_*`` family next to everything else; the charts/serve
  HPA scales on these series.

Drain (the trainer's preemption discipline applied to serving): SIGTERM →
stop admission (healthz + predict answer 503) → flush every accepted
request through the batcher → wait for handler threads to finish
writing responses → exit 0.  Zero accepted requests are dropped.  The
flush holds ``lifecycle_lock``, the lock a hot-reload swap takes, so a
swap and a flush never interleave.

Bind failures follow the exporter's rule — port 0 binds an ephemeral
port published via :attr:`ServingServer.port` and an optional
``port_file`` (write-then-rename, the discovery contract a load
test polls).
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from eksml_tpu_torch.serve.batcher import (DrainingError, MicroBatcher,
                                           QueueFullError)
from eksml_tpu_torch.telemetry.exporter import render_openmetrics

log = logging.getLogger(__name__)

#: default ceiling a handler thread waits for its batched result; far
#: above any sane SLO — it exists so a wedged dispatcher returns 500
#: instead of holding sockets forever
RESULT_TIMEOUT_SEC = 120.0


def _decode_image(handler: "_Handler", body: bytes) -> np.ndarray:
    """Request body → uint8 RGB [H, W, 3].

    ``image/*`` bodies decode through PIL; ``application/json`` bodies
    carry a base64 raw array (``image_b64`` + ``shape``) — the
    dependency-free path the hermetic load test uses."""
    ctype = (handler.headers.get("Content-Type") or "").split(";")[0]
    if ctype.startswith("image/"):
        from PIL import Image

        with Image.open(io.BytesIO(body)) as img:
            return np.asarray(img.convert("RGB"))
    payload = json.loads(body.decode("utf-8"))
    handler.request_params = payload
    raw = base64.b64decode(payload["image_b64"])
    shape = tuple(int(d) for d in payload["shape"])
    dtype = np.dtype(payload.get("dtype", "uint8"))
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


class _Handler(BaseHTTPRequestHandler):
    server_obj: "ServingServer"  # set on the bound subclass
    request_params: Dict = {}

    protocol_version = "HTTP/1.1"

    def _send_json(self, code: int, payload: Dict) -> None:
        body = (json.dumps(payload) + "\n").encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        path = self.path.partition("?")[0]
        s = self.server_obj
        if path == "/healthz":
            code, payload = s.health()
            self._send_json(code, payload)
        elif path == "/metrics":
            try:
                body = render_openmetrics(s.registry).encode("utf-8")
            except Exception:  # noqa: BLE001 — scrape must not 500
                log.exception("metric exposition failed")
                self.send_error(500)
                return
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
        path = self.path.partition("?")[0]
        s = self.server_obj
        # ALWAYS drain the request body first: protocol_version is
        # HTTP/1.1 (persistent connections), and an early-exit
        # response that leaves Content-Length bytes unread would make
        # the keep-alive peer's NEXT request parse the leftover body
        # as a request line — a silent connection desync
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length)
        if path == "/admin/reload":
            self._admin_reload(body)
            return
        if path != "/v1/predict":
            self._send_json(404, {"error": f"no route {path}"})
            return
        if not s.ready.is_set():
            self._send_json(503, {"error": "warming up: executables "
                                           "compiling"})
            return
        if s.draining.is_set():
            self._send_json(503, {"error": "draining for shutdown"})
            return
        s.note_http_start()
        try:
            self._predict(body)
        finally:
            s.note_http_done()

    def _admin_reload(self, body: bytes) -> None:
        """Verify + restore + swap a checkpoint step (JSON ``{"step": N}``;
        empty body = newest candidate) in THIS handler thread while the
        dispatcher keeps serving; 409 answers a rejection."""
        s = self.server_obj
        mgr = s.reload_manager
        if mgr is None:
            self._send_json(503, {"error": "no reload manager: server was "
                                           "started without a checkpoint "
                                           "directory"})
            return
        step = None
        if body:
            try:
                step = json.loads(body.decode("utf-8")).get("step")
            except Exception as e:  # noqa: BLE001 — bad input is a 400
                self._send_json(400, {"error": f"bad reload request: "
                                               f"{e!r}"})
                return
        s.note_http_start()
        try:
            outcome = mgr.reload_step(step)
        finally:
            s.note_http_done()
        self._send_json(200 if outcome.get("ok") else 409, outcome)

    def _predict(self, body: bytes) -> None:
        # error paths collect (code, payload) and answer OUTSIDE the
        # exception handlers — no control flow exits a handler here
        s = self.server_obj
        fail = None
        image = req = dets = None
        try:
            self.request_params = {}
            image = _decode_image(self, body)
            # shape-gate BEFORE admission: a decodable-but-malformed
            # array (RGBA, 1-D, empty) must answer 400 here — admitted,
            # it would poison the whole micro-batch (np.stack shape
            # mismatch fails CO-BATCHED requests from other clients)
            # or raise past the except-map below and kill the
            # connection with no HTTP response at all
            if (image.ndim != 3 or image.shape[2] != 3
                    or image.shape[0] < 1 or image.shape[1] < 1):
                raise ValueError(
                    f"expected an [H, W, 3] RGB image, got shape "
                    f"{tuple(image.shape)}")
        except Exception as e:  # noqa: BLE001 — bad input is a 400
            fail = (400, {"error": f"cannot decode image: {e!r}"})
        if fail is None:
            params = self.request_params
            thresh = params.get("score_thresh")
            want_masks = bool(params.get(
                "masks", s.result_masks_default))
            raw_topk = int(params.get("raw_topk") or 0)
            try:
                req = s.batcher.submit(image, score_thresh=thresh,
                                       want_masks=want_masks,
                                       raw_topk=raw_topk)
            except QueueFullError as e:
                fail = (429, {"error": str(e)})
            except DrainingError as e:
                fail = (503, {"error": str(e)})
        if fail is None:
            try:
                dets = req.wait_result(timeout=RESULT_TIMEOUT_SEC)
            except Exception as e:  # noqa: BLE001 — inference is 500
                fail = (500, {"error": f"inference failed: {e!r}"})
        if fail is not None:
            self._send_json(fail[0], fail[1])
            return
        out = []
        for d in dets:
            row: Dict = {"box": [float(x) for x in d.box],
                         "score": d.score, "class_id": d.class_id}
            if d.mask is not None:
                from eksml_tpu_torch.data.masks import rle_encode

                rle = dict(rle_encode(np.asarray(d.mask, np.uint8)))
                counts = rle.get("counts")
                if isinstance(counts, bytes):
                    rle["counts"] = counts.decode("ascii")
                row["mask_rle"] = rle
            out.append(row)
        bh, bw = s.batcher.engine.buckets[req.bucket]
        resp = {
            "detections": out,
            "timings_ms": req.timings_ms,
            "bucket": [bh, bw],
            "batch_fill": req.batch_fill,
            "batch_rung": req.batch_rung,
            # checkpoint step of the serving params (None: handed in)
            "params_step": req.served_step,
        }
        if req.raw_top is not None:
            resp["raw_top"] = req.raw_top
        self._send_json(200, resp)

    def log_message(self, fmt, *args):  # requests are not pod-log news
        log.debug("serve http: " + fmt, *args)


class ServingServer:
    """Threaded serving front-end bound to ``addr:port`` (0 =
    ephemeral, published via ``port_file``)."""

    def __init__(self, batcher: MicroBatcher, port: int = 8081,
                 addr: str = "0.0.0.0", port_file: Optional[str] = None,
                 registry=None, result_masks_default: bool = False):
        from eksml_tpu_torch.telemetry.registry import default_registry

        self.batcher = batcher
        self.registry = registry or default_registry()
        self.requested_port = int(port)
        self.addr = addr
        self.port_file = port_file
        self.result_masks_default = bool(result_masks_default)
        self.ready = threading.Event()     # warmup completed
        self.draining = threading.Event()  # SIGTERM seen / drain begun
        # THE shared swap/drain lock: the drain flush and a hot-reload
        # swap both run under it (reload.py re-checks `draining` under it)
        self.lifecycle_lock = threading.Lock()
        # ReloadManager when a checkpoint directory is served; None =
        # /admin/reload answers 503
        self.reload_manager = None
        self.started_monotonic = time.monotonic()
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._http_lock = threading.Lock()
        self._http_inflight = 0

    # -- handler-side bookkeeping --------------------------------------

    def note_http_start(self) -> None:
        with self._http_lock:
            self._http_inflight += 1

    def note_http_done(self) -> None:
        with self._http_lock:
            self._http_inflight -= 1

    def health(self):
        """(code, payload) for ``/healthz`` — readiness semantics:
        503 until warmup, 503 again while draining."""
        eng = self.batcher.engine
        if self.draining.is_set():
            status, code = "draining", 503
        elif not self.ready.is_set():
            status, code = "warming", 503
        else:
            status, code = "ok", 200
        payload = {
            "status": status,
            "uptime_sec": round(
                time.monotonic() - self.started_monotonic, 1),
            "warm_executables": len(eng._exes),
            "compiles": eng.compiles,
            "request_path_compiles": eng.request_path_compiles,
            "queue_depth": self.batcher._q.qsize()
            + len(self.batcher._pending),
            "buckets": [list(b) for b in eng.buckets],
            "batch_rungs": list(eng.rungs),
            "devices": torch.cuda.device_count(),
            "params_step": eng.params_step,
            "reloads": (self.reload_manager.reloads
                        if self.reload_manager else 0),
            "reload_rejected": (self.reload_manager.rejected
                                if self.reload_manager else 0),
        }
        return code, payload

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ServingServer":
        if self._server is not None:
            return self
        handler = type("BoundHandler", (_Handler,),
                       {"server_obj": self})
        server = ThreadingHTTPServer((self.addr, self.requested_port),
                                     handler)
        server.daemon_threads = True
        self._server = server
        self.port = server.server_address[1]
        self.started_monotonic = time.monotonic()
        self._thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.5},
            name="eksml-serve-http", daemon=True)
        self._thread.start()
        if self.port_file:
            # write-then-rename: a reader polling for the file must
            # never catch it created-but-empty (the load test parses
            # it the instant it appears)
            try:
                tmp = self.port_file + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(self.port))
                os.replace(tmp, self.port_file)
            except OSError:
                log.warning("could not write serve port file %s",
                            self.port_file)
        log.info("serving /v1/predict, /healthz and /metrics on "
                 "port %d", self.port)
        return self

    def mark_ready(self) -> None:
        """Flip ``/healthz`` to 200 — call after the engine warmup."""
        self.ready.set()

    def drain(self, timeout: float = 60.0) -> None:
        """Graceful shutdown: stop admission, flush in-flight batches,
        finish writing responses, stop the listener."""
        self.draining.set()
        log.info("drain: admission closed, flushing in-flight "
                 "requests")
        # a swap either completed before this (the flush serves the new
        # params) or is rejected "draining" when it re-checks under the
        # lock; `draining` is set first so a reload not yet holding the
        # lock bails before its restore
        with self.lifecycle_lock:
            self.batcher.close(drain=True, timeout=timeout)
        # batched results are set; give handler threads a moment to
        # write their responses before the listener dies
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with self._http_lock:
                left = self._http_inflight
            if left <= 0:
                break
            time.sleep(0.05)
        self.stop()
        log.info("drain complete")

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
