"""Dynamic micro-batching: bounded queue → bucket-homogeneous batches
(the port of ``eksml_tpu/serve/batcher.py``).

The dispatch policy (one dispatcher thread, the classic serving
shape — cf. TF-Serving's BatchingSession / Triton's dynamic batcher):

- ``submit()`` (called from HTTP handler threads) preprocesses the
  image into its bucket canvas (the ``pad`` span — parallel across
  handler threads) and enqueues; a full queue rejects with 429
  semantics (:class:`QueueFullError`) — load sheds at admission,
  never as unbounded memory.
- the dispatcher pops the oldest request, then holds the batch open
  for up to ``SERVE.MAX_BATCH_DELAY_MS`` collecting SAME-BUCKET
  requests (different-bucket arrivals park in a pending deque and
  lead the next batch), closing early at ``SERVE.MAX_BATCH_SIZE``.
  ``MAX_BATCH_DELAY_MS=0`` is pass-through: every request dispatches
  alone, immediately — the latency floor.
- the batch pads up to the engine's batch rung and dispatches the
  pre-warmed (bucket, rung) executable; per-request postprocess
  (``detections_from_raw``) runs in the dispatcher thread.

Every request carries its SLO span chain — ``queue_wait`` / ``pad`` /
``device_infer`` / ``postprocess`` — through the telemetry span layer
(joins the trace timeline) AND as per-request ``timings_ms`` in the
response, so the load generator can attribute tail latency without
scraping.  Registry metrics: ``eksml_serve_requests`` /
``eksml_serve_batches`` counters, latency histograms, queue-depth /
in-flight / batch-occupancy gauges.

Drain contract (the trainer's preemption discipline applied to serving):
``close(drain=True)`` stops admission, flushes everything already
accepted — queued AND pending — then stops the dispatcher.  Zero
accepted requests are ever dropped by a graceful shutdown.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from eksml_tpu_torch import telemetry

log = logging.getLogger(__name__)


class ServeError(Exception):
    """Base class for serving rejections."""


class QueueFullError(ServeError):
    """Admission rejected: the bounded request queue is full (429)."""


class DrainingError(ServeError):
    """Admission rejected: the server is draining for shutdown (503)."""


class _Request:
    """One in-flight request; handler threads block in
    :meth:`wait_result`."""

    __slots__ = ("canvas", "scale", "nh", "nw", "bucket", "orig_hw",
                 "score_thresh", "want_masks", "raw_topk", "t_enqueue",
                 "timings_ms", "batch_fill", "batch_rung", "served_step",
                 "raw_top", "_done", "_result", "_error")

    def __init__(self, canvas, scale, nh, nw, bucket, orig_hw,
                 score_thresh, want_masks, pad_ms, raw_topk=0):
        self.canvas = canvas
        self.scale = scale
        self.nh, self.nw = nh, nw
        self.bucket = bucket
        self.orig_hw = orig_hw
        self.score_thresh = score_thresh
        self.want_masks = want_masks
        self.raw_topk = raw_topk
        self.t_enqueue = time.perf_counter()
        self.timings_ms: Dict[str, float] = {"pad": round(pad_ms, 3)}
        self.batch_fill = 0
        self.batch_rung = 0
        self.served_step: Optional[int] = None  # checkpoint that served
        self.raw_top = None                     # pre-threshold top-k
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def set_result(self, result) -> None:
        self._result = result
        self._done.set()

    def set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    def wait_result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("inference result not ready in time")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Bounded request queue + single dispatcher thread."""

    _STOP = object()

    def __init__(self, engine, cfg=None):
        from eksml_tpu_torch.serve.engine import _serve_knobs

        self.engine = engine
        knobs = _serve_knobs(cfg if cfg is not None else engine.cfg)
        self.max_batch = min(int(knobs["MAX_BATCH_SIZE"]),
                             engine.max_batch)
        self.delay_s = max(0.0, float(knobs["MAX_BATCH_DELAY_MS"])) \
            / 1000.0
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(knobs["MAX_QUEUE"])))
        # different-bucket requests parked while a batch was forming;
        # dispatcher-thread-only (no lock needed)
        self._pending: "collections.deque" = collections.deque()
        self._draining = False
        self._abort = False
        self._stop_seen = False
        # guards the cross-thread counters/flags (handler threads
        # mutate on admission, the dispatcher on completion); never
        # held across a blocking call
        self._state_lock = threading.Lock()
        self._in_flight = 0

        reg = telemetry.default_registry()
        self._m_requests = {
            outcome: reg.counter(
                "eksml_serve_requests",
                "serving requests by outcome",
                labels={"outcome": outcome})
            for outcome in ("ok", "error", "rejected")}
        self._m_batches = reg.counter(
            "eksml_serve_batches", "micro-batches dispatched")
        self._m_latency = reg.histogram(
            "eksml_serve_request_latency_ms",
            "request latency, enqueue to postprocess done")
        self._m_queue_wait = reg.histogram(
            "eksml_serve_queue_wait_ms",
            "time a request waited before its batch formed")
        self._m_infer = reg.histogram(
            "eksml_serve_infer_ms", "device inference time per batch")
        self._m_depth = reg.gauge(
            "eksml_serve_queue_depth",
            "requests admitted but not yet dispatched")
        self._m_depth.set_function(
            lambda: self._q.qsize() + len(self._pending))
        self._m_inflight = reg.gauge(
            "eksml_serve_in_flight",
            "requests admitted and not yet answered")
        self._m_inflight.set_function(lambda: self._in_flight)
        self._m_occupancy = reg.gauge(
            "eksml_serve_batch_occupancy",
            "fill fraction (requests / batch rung) of the last "
            "dispatched micro-batch")

        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serve-dispatcher")
        self._thread.start()

    # -- admission (handler threads) -----------------------------------

    def submit(self, image: np.ndarray,
               score_thresh: Optional[float] = None,
               want_masks: bool = False,
               raw_topk: int = 0) -> _Request:
        """Preprocess + enqueue; returns the request handle.  Raises
        :class:`DrainingError` / :class:`QueueFullError` on rejection
        (mapped to 503 / 429 by the server)."""
        if self._draining:
            self._m_requests["rejected"].inc()
            raise DrainingError("server is draining")
        if self._q.full():
            # best-effort shed BEFORE the milliseconds of resize/
            # normalize: under exactly the overload the 429 exists
            # for, rejected requests must not burn handler-thread CPU
            # on preprocessing that is thrown away (the authoritative
            # check is the locked put_nowait below)
            self._m_requests["rejected"].inc()
            raise QueueFullError(
                f"request queue full ({self._q.maxsize}); shed load "
                "or raise SERVE.MAX_QUEUE / replica count")
        t0 = time.perf_counter()
        canvas, scale, (nh, nw), bucket = self.engine.preprocess(image)
        t1 = time.perf_counter()
        telemetry.complete_span("pad", t0, t1, bucket=bucket)
        req = _Request(canvas, scale, nh, nw, bucket,
                       image.shape[:2], score_thresh, want_masks,
                       pad_ms=(t1 - t0) * 1e3,
                       raw_topk=max(0, int(raw_topk)))
        # drain re-check + enqueue are ATOMIC vs close(): close() sets
        # _draining and enqueues the STOP sentinel under this same
        # lock, so a request either lands in the queue AHEAD of STOP
        # (the flush serves it) or is rejected here — it can never be
        # accepted after the dispatcher's exit sentinel (the TOCTOU
        # that would strand a client until RESULT_TIMEOUT_SEC).
        # put_nowait never blocks, so the critical section is bounded.
        with self._state_lock:
            if self._draining:
                rejected: Optional[ServeError] = DrainingError(
                    "server is draining")
            else:
                try:
                    self._q.put_nowait(req)
                    rejected = None
                    self._in_flight += 1
                except queue.Full:
                    rejected = QueueFullError(
                        f"request queue full ({self._q.maxsize}); "
                        "shed load or raise SERVE.MAX_QUEUE / "
                        "replica count")
        if rejected is not None:
            self._m_requests["rejected"].inc()
            raise rejected
        return req

    # -- dispatcher ----------------------------------------------------

    def _take_same_bucket(self, bucket: int) -> Optional[_Request]:
        for i, r in enumerate(self._pending):
            if r.bucket == bucket:
                del self._pending[i]
                return r
        return None

    def _gather(self, first: _Request) -> List[_Request]:
        """Form one bucket-homogeneous batch starting at ``first``."""
        batch = [first]
        if self.delay_s <= 0.0:
            return batch  # pass-through: no waiting, no coalescing
        deadline = time.perf_counter() + self.delay_s
        while len(batch) < self.max_batch:
            r = self._take_same_bucket(first.bucket)
            if r is not None:
                batch.append(r)
                continue
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is self._STOP:
                self._stop_seen = True
                break
            if item.bucket == first.bucket:
                batch.append(item)
            else:
                self._pending.append(item)
        return batch

    def _dispatch(self, batch: List[_Request]) -> None:
        from eksml_tpu_torch.predict.predictor import detections_from_raw

        t_d0 = time.perf_counter()
        n = len(batch)
        rung = self.engine.rung_for(n)
        for r in batch:
            wait_ms = (t_d0 - r.t_enqueue) * 1e3
            r.timings_ms["queue_wait"] = round(wait_ms, 3)
            self._m_queue_wait.observe(wait_ms)
            telemetry.complete_span("queue_wait", r.t_enqueue, t_d0,
                                    bucket=r.bucket)
        try:
            images = np.stack([r.canvas for r in batch])
            hw = np.asarray([[r.nh, r.nw] for r in batch], np.float32)
            out = self.engine.infer(images, hw, batch[0].bucket)
            t_d1 = time.perf_counter()
            infer_ms = (t_d1 - t_d0) * 1e3
            telemetry.complete_span("device_infer", t_d0, t_d1,
                                    bucket=batch[0].bucket, n=n,
                                    rung=rung)
            self._m_infer.observe(infer_ms)
            self._m_batches.inc()
            self._m_occupancy.set(n / float(rung))
            thresh_default = float(
                self.engine.cfg.TEST.RESULT_SCORE_THRESH)
            for i, r in enumerate(batch):
                t_p0 = time.perf_counter()
                h, w = r.orig_hw
                thresh = (thresh_default if r.score_thresh is None
                          else float(r.score_thresh))
                dets = detections_from_raw(
                    {k: v[i] for k, v in out.items()}, r.scale, h, w,
                    thresh, want_masks=r.want_masks)
                if r.raw_topk:
                    # pre-threshold top-k raw head outputs: the shadow
                    # scorer's drift signal — differs whenever the
                    # params differ, even when both checkpoints emit
                    # zero above-threshold detections
                    k_top = min(r.raw_topk, out["scores"].shape[1])
                    order = np.argsort(-out["scores"][i],
                                       kind="stable")[:k_top]
                    r.raw_top = {
                        "scores": [float(s) for s in
                                   out["scores"][i][order]],
                        "classes": [int(c) for c in
                                    out["classes"][i][order]],
                        "boxes": [[float(x) for x in bx] for bx in
                                  out["boxes"][i][order]],
                    }
                r.served_step = self.engine.params_step
                t_p1 = time.perf_counter()
                telemetry.complete_span("postprocess", t_p0, t_p1)
                r.timings_ms["device_infer"] = round(infer_ms, 3)
                r.timings_ms["postprocess"] = round(
                    (t_p1 - t_p0) * 1e3, 3)
                total_ms = (t_p1 - r.t_enqueue) * 1e3
                r.timings_ms["total"] = round(total_ms, 3)
                r.batch_fill, r.batch_rung = n, rung
                self._m_latency.observe(total_ms)
                self._m_requests["ok"].inc()
                with self._state_lock:
                    self._in_flight -= 1
                r.set_result(dets)
        except Exception as e:  # noqa: BLE001 — server must survive
            log.exception("micro-batch dispatch failed (%d request(s))",
                          n)
            for r in batch:
                if not r._done.is_set():
                    self._m_requests["error"].inc()
                    with self._state_lock:
                        self._in_flight -= 1
                    r.set_error(e)

    def _run(self) -> None:
        while True:
            if self._abort:
                self._fail_remaining()
                return
            if self._pending:
                first = self._pending.popleft()
            else:
                try:
                    item = self._q.get(timeout=0.1)
                except queue.Empty:
                    if self._stop_seen:
                        return
                    continue
                if item is self._STOP:
                    self._stop_seen = True
                    continue
                first = item
            self._dispatch(self._gather(first))

    def _fail_remaining(self) -> None:
        """Abort path only: answer everything still queued."""
        leftovers = list(self._pending)
        self._pending.clear()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not self._STOP:
                leftovers.append(item)
        for r in leftovers:
            self._m_requests["error"].inc()
            with self._state_lock:
                self._in_flight -= 1
            r.set_error(DrainingError("server shut down before "
                                      "this request was served"))

    # -- shutdown ------------------------------------------------------

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop admission; ``drain=True`` flushes every accepted
        request before the dispatcher exits (graceful SIGTERM),
        ``drain=False`` fails them fast (abort)."""
        # same lock as submit()'s check-and-enqueue: once this section
        # runs, no request can be admitted behind the STOP sentinel
        with self._state_lock:
            self._draining = True
            if not drain:
                self._abort = True
            try:
                self._q.put_nowait(self._STOP)
            except queue.Full:
                # a full queue still drains: the dispatcher empties it
                # and then times out on get() with _stop_seen never
                # set — set it directly; admission is already closed
                self._stop_seen = True
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            log.warning("serve dispatcher still alive after %.0fs "
                        "drain window", timeout)
