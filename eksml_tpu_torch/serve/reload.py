"""Verified checkpoint hot-reload: the serving engine tracks training
(the port of ``eksml_tpu/serve/reload.py``).

1. **Watch** — a daemon thread polls ``<logdir>/checkpoints/`` for a
   step newer than the one serving (``SERVE.RELOAD_POLL_SEC``; 0
   disables the watcher but keeps ``/admin/reload``).
2. **Verify** — the candidate must pass its integrity manifest
   (``resilience/integrity.py``).  Serving is STRICTER than a training
   relaunch: training's walk-back leniency ("no manifest → structural
   check only") exists because refusing to restore discards real
   progress, but a live server already holds known-good params — an
   unproven checkpoint must never reach traffic, so a missing or
   unreadable manifest is a rejection here.
3. **Restore off the request path** — ``restore_predict_params`` reads
   the model's ``state_dict`` in the watcher or handler thread; the
   dispatcher keeps serving the old params throughout.
4. **Swap between micro-batches** — ``InferenceEngine.swap_params``
   checks names, shapes and dtypes, builds the new model on the device,
   then swaps the ``(model, step)`` pair under the engine lock.  The
   dispatcher snapshots ``(model, step)`` once per micro-batch, so
   in-flight batches finish on the old weights and the warm shapes are
   reused as-is — ``request_path_compiles`` stays 0 across the swap.
5. **Fail closed** — any rejection (integrity, restore exception,
   structure mismatch, drain in progress) leaves the old params
   serving, emits a ``serve_reload_rejected`` flight event and bumps
   ``eksml_serve_reload_rejected_total{reason=}``; steps the watcher
   saw rejected are remembered so it does not hot-loop on them.

The swap and the SIGTERM drain share ONE lock
(``ServingServer.lifecycle_lock``): a drain flush can never interleave
with a params swap — whichever acquires first completes, and a swap
that loses the race is rejected with reason ``draining``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

from eksml_tpu_torch import telemetry

log = logging.getLogger(__name__)

#: rejection reason classes — a closed set so the counter's label
#: space is preregistered (first scrape shows the whole family at 0)
REJECT_REASONS = ("integrity", "restore", "structure", "draining",
                  "no_step")


class ReloadManager:
    """Watch / verify / restore / swap for one :class:`InferenceEngine`.

    ``lock`` is the shared swap/drain lock (the server's
    ``lifecycle_lock``); ``is_draining`` is polled before and under the
    lock so a reload never races a drain flush.  ``restore_fn(step)``
    (a model ``state_dict``) is injectable for tests; the default is
    ``restore_predict_params``.  ``last_timings`` holds the last
    completed reload's ``verify_ms``, ``restore_ms`` and ``swap_ms``.
    ``recorder`` (a :class:`FlightRecorder`) takes this manager's flight
    events; the default is the process's installed recorder.  Two
    serving tracks in one process (the stable and canary tracks of
    ``chip_smoke.py``'s fleet phase) each pass their own.
    """

    def __init__(self, engine, logdir: str,
                 lock: Optional[threading.Lock] = None,
                 poll_sec: float = 0.0,
                 is_draining: Optional[Callable[[], bool]] = None,
                 restore_fn: Optional[Callable[[int], object]] = None,
                 check_digest: bool = True,
                 registry=None, recorder=None):
        self.engine = engine
        self.logdir = logdir
        self.root = os.path.join(logdir, "checkpoints")
        self.lock = lock if lock is not None else threading.Lock()
        self.poll_sec = float(poll_sec)
        self._is_draining = is_draining or (lambda: False)
        self._restore_fn = restore_fn or self._restore
        self.check_digest = bool(check_digest)
        self._event = recorder.record if recorder is not None \
            else telemetry.event
        # serializes concurrent reload attempts (watcher thread vs the
        # /admin/reload handler): restores are seconds of I/O and two
        # interleaved ones would race the swap ordering
        self._busy = threading.Lock()
        # steps that failed validation/restore/structure: skipped by
        # the watcher until a NEWER step appears (an explicit
        # /admin/reload retries them — the operator may have repaired
        # the manifest)
        self._rejected: Dict[int, str] = {}
        self.reloads = 0
        self.rejected = 0
        self.last_timings: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        reg = registry or telemetry.default_registry()
        self._m_reloads = reg.counter(
            "eksml_serve_reloads",
            "checkpoint hot-reloads completed (params swapped between "
            "micro-batches, warm shapes reused)")
        self._m_rejected = {
            reason: reg.counter(
                "eksml_serve_reload_rejected",
                "hot-reload candidates rejected (old params keep "
                "serving)", labels={"reason": reason})
            for reason in REJECT_REASONS}
        self._m_reload_ms = reg.histogram(
            "eksml_serve_reload_ms",
            "verify + restore + swap duration per completed reload")
        self._m_step = reg.gauge(
            "eksml_serve_params_step",
            "checkpoint step of the params currently serving "
            "(-1 = random/unknown params)")
        self._m_step.set_function(
            lambda: self.engine.params_step
            if self.engine.params_step is not None else -1)

    # -- candidate discovery -------------------------------------------

    def candidate_steps(self):
        """Committed digit step dirs under ``checkpoints/``, sorted."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.root, n)))

    def latest_candidate(self) -> Optional[int]:
        cur = self.engine.params_step
        cur = -1 if cur is None else int(cur)
        cands = [s for s in self.candidate_steps()
                 if s > cur and s not in self._rejected]
        return max(cands) if cands else None

    # -- validation (stricter than the training restore) ---------------

    def validate_step(self, step: int):
        """``(ok, reason, topology)`` — the serving gate.

        Unlike the relaunch path (which must not discard a
        likely-good step), a live server already holds good params,
        so "cannot prove integrity" means REJECT: the manifest must
        exist, parse, and verify."""
        from eksml_tpu_torch.resilience import integrity

        if not integrity.manifest_readable(self.root, step):
            return (False,
                    f"step {step}: integrity manifest missing or "
                    "unreadable (serving requires a verified "
                    "checkpoint; training's walk-back leniency does "
                    "not apply)", None)
        ok, reason = integrity.verify_step(
            self.root, step, check_digest=self.check_digest)
        if not ok:
            return False, reason, None
        # topology manifest: evidence recorded with the reload event
        # (every tensor is whole in the checkpoint, so any saved
        # topology restores; absence is tolerated)
        topo = integrity.read_topology_manifest(self.root, step)
        return True, reason, topo

    # -- restore + swap -------------------------------------------------

    def _restore(self, step: int):
        from eksml_tpu_torch.predict.predictor import restore_predict_params

        return restore_predict_params(self.engine.cfg, self.logdir, step)

    def _reject(self, step: Optional[int], reason: str,
                detail: str, remember: bool = False) -> Dict:
        self.rejected += 1
        self._m_rejected.get(
            reason, self._m_rejected["integrity"]).inc()
        if remember and step is not None:
            self._rejected[int(step)] = reason
        log.warning("hot-reload rejected (%s): %s", reason, detail)
        self._event("serve_reload_rejected", step=step,
                        reason=reason, detail=detail)
        return {"ok": False, "step": step, "reason": reason,
                "detail": detail}

    def reload_step(self, step: Optional[int] = None) -> Dict:
        """Verify + restore + swap one candidate (the latest when
        ``step`` is None).  Never raises: every failure path answers
        an outcome dict with the old params still serving."""
        with self._busy:
            return self._reload_locked(step)

    def _reload_locked(self, step: Optional[int]) -> Dict:
        t0 = time.perf_counter()
        explicit = step is not None
        if step is None:
            step = self.latest_candidate()
            if step is None:
                return {"ok": False, "step": None, "reason": "no_step",
                        "detail": "no new candidate step"}
        step = int(step)
        if self._is_draining():
            return self._reject(step, "draining",
                                "server is draining for shutdown")
        ok, reason, topo = self.validate_step(step)
        if not ok:
            return self._reject(step, "integrity", reason,
                                remember=not explicit)
        t1 = time.perf_counter()
        try:
            params = self._restore_fn(step)
        except Exception as e:  # noqa: BLE001 — old params keep serving
            return self._reject(step, "restore",
                                f"step {step}: restore failed: {e!r}",
                                remember=not explicit)
        t2 = time.perf_counter()
        # the swap itself: shared with the drain path, so a flush and
        # a swap serialize — the re-check under the lock closes the
        # race where SIGTERM lands between restore and swap
        with self.lock:
            if self._is_draining():
                return self._reject(step, "draining",
                                    "drain began during restore")
            try:
                old_step = self.engine.params_step
                self.engine.swap_params(params, step=step)
            except ValueError as e:
                return self._reject(step, "structure", str(e),
                                    remember=not explicit)
        t3 = time.perf_counter()
        dt_ms = (t3 - t0) * 1e3
        self.last_timings = {"verify_ms": (t1 - t0) * 1e3,
                             "restore_ms": (t2 - t1) * 1e3,
                             "swap_ms": (t3 - t2) * 1e3}
        self.reloads += 1
        self._m_reloads.inc()
        self._m_reload_ms.observe(dt_ms)
        # newly-proven steps supersede older rejections: the watcher
        # only ever looks FORWARD of the serving step
        self._rejected = {s: r for s, r in self._rejected.items()
                          if s > step}
        log.info("hot-reload: step %s -> %d in %.0f ms (%s)",
                 old_step, step, dt_ms, reason)
        self._event("serve_reload", step=step,
                        previous_step=old_step,
                        duration_ms=round(dt_ms, 1),
                        verification=reason,
                        topology_chips=(topo or {}).get("num_devices"))
        return {"ok": True, "step": step, "previous_step": old_step,
                "duration_ms": round(dt_ms, 1), **self.last_timings}

    # -- the watcher ----------------------------------------------------

    def poll_once(self) -> Optional[Dict]:
        if self.latest_candidate() is None:
            return None  # don't touch _busy on the idle path
        # step=None (not the candidate we just saw): reload_step
        # re-resolves under _busy, and a None step marks the attempt
        # as watcher-initiated so rejections are REMEMBERED (no
        # hot-loop on a bad candidate); explicit /admin/reload retries
        return self.reload_step()

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_sec):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — watcher must survive
                log.exception("hot-reload poll failed; old params "
                              "keep serving")

    def start(self) -> "ReloadManager":
        if self.poll_sec > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._watch, daemon=True,
                name="serve-reload-watcher")
            self._thread.start()
            log.info("hot-reload watcher up: polling %s every %.1fs",
                     self.root, self.poll_sec)
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
