"""Fault-tolerant data ingest: classify → retry → quarantine → report
(a copy of ``eksml_tpu/data/robust.py``).

The reference stages COCO onto a shared filesystem (EFS/FSx ≙
Filestore/GCS-FUSE here) where transient NFS errors, throttling
stalls, and partially-staged files are routine — and its DataFlow
pipeline trusts every byte: one truncated JPEG kills the producer and
with it the whole N-host job.  This module owns the ingest half of the
resilience story (knobs under ``config.RESILIENCE.DATA``):

- :class:`RobustImageReader` — classifies read failures. *Transient*
  I/O errors (EIO/ESTALE/timeout — the shared-filesystem blips) are
  retried with bounded exponential backoff; *permanent* failures
  (missing file, truncated/undecodable image) raise
  :class:`PermanentDataError` immediately — re-reading a bad byte N
  times just multiplies the stall.
- :class:`QuarantineLedger` — after retries are exhausted the record
  is quarantined: logged to ``<logdir>/quarantine-host<i>.jsonl`` and
  replaced by a deterministic substitute from the same bucket cycle
  (loader.py), so batch shapes and the cross-host step/draw schedule
  are untouched.  A ``MAX_QUARANTINE_FRAC`` circuit breaker turns a
  vanished mount into ONE loud :class:`QuarantineOverflowError`
  naming the ledger, instead of a job silently training on
  substitutes.
- :class:`LoaderHealth` — producer-side heartbeat/stats (queue depth,
  batch build timing, quarantine counts) surfaced through the hang
  watchdog's report (resilience/watchdog.py) so input starvation
  produces a stalled-phase diagnosis, not a generic hang; and
  :class:`DataStarvationError`, raised by the consumer when the
  producer thread is dead with nothing queued (the ``q.get()``
  forever-block this replaces).

The ``BrokenProcessPool`` half of self-healing (decode worker
OOM-killed mid-batch) lives in loader.py, which owns the pool.

One difference from the reference: an ``ImportError`` from the decoder
(no PIL in the environment) is not a fact about any record's bytes, so
:meth:`RobustImageReader.read` lets it propagate at once instead of
classifying it as a permanent decode error; otherwise every record would
quarantine in turn until the circuit breaker fired, naming no cause.

The registry and the flight recorder are imported as modules of their
own (not through ``eksml_tpu_torch.telemetry``), so the decode path
imports nothing of torch.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from eksml_tpu_torch.telemetry.recorder import event
from eksml_tpu_torch.telemetry.registry import default_registry

log = logging.getLogger(__name__)

# Errno values that indicate the *filesystem* hiccuped, not that the
# bytes are bad: worth a bounded retry.  ESTALE (NFS handle expired
# after a server failover) and EIO (generic transport error) are the
# two the reference's EFS/FSx staging actually produces; timeouts and
# interrupted syscalls ride along.
TRANSIENT_ERRNOS = frozenset(
    e for e in (
        errno.EIO, errno.ESTALE, errno.EAGAIN, errno.ETIMEDOUT,
        errno.EINTR, getattr(errno, "EREMOTEIO", None),
    ) if e is not None)

TRANSIENT = "transient"
PERMANENT = "permanent"


def classify_error(exc: BaseException) -> str:
    """TRANSIENT (retry-worthy I/O blip) vs PERMANENT (bad bytes).

    FileNotFoundError is permanent: a partially-staged dataset is a
    data bug, and ENOENT does not heal by waiting.  Decode errors
    (PIL's UnidentifiedImageError/SyntaxError, truncated-stream
    OSErrors with no errno) are permanent by the same logic.
    """
    if isinstance(exc, FileNotFoundError):
        return PERMANENT
    if isinstance(exc, (TimeoutError, InterruptedError)):
        return TRANSIENT
    if isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS:
        return TRANSIENT
    return PERMANENT


class PermanentDataError(Exception):
    """A record's bytes cannot be produced: decode error, missing
    file, or transient retries exhausted.  Carries what the ledger
    needs."""

    def __init__(self, path: str, kind: str, cause: BaseException,
                 attempts: int):
        super().__init__(
            f"{kind} failure reading {path!r} after {attempts} "
            f"attempt(s): {cause!r}")
        self.path = path
        self.kind = kind        # "missing" | "decode" | "io_exhausted"
        self.cause = cause
        self.attempts = attempts


class QuarantineOverflowError(RuntimeError):
    """Quarantined fraction exceeded RESILIENCE.DATA.MAX_QUARANTINE_FRAC
    — systemic data loss (vanished mount, mass-truncated staging), not
    scattered bad records.  Training on substitutes would silently
    converge on garbage; fail loudly instead."""


class DataStarvationError(RuntimeError):
    """The producer thread died without delivering its end-of-stream
    sentinel — the consumer would otherwise block on ``q.get()``
    forever (the pre-robustness deadlock)."""


class RobustImageReader:
    """``read(path)`` with fault classification and bounded backoff.

    ``io_retries`` counts *extra* attempts after the first; only
    TRANSIENT failures consume them.  The chaos hook
    (``inject_eio_path``/``inject_eio_count``) makes the first N reads
    of any matching path raise EIO — a deterministic stand-in for a
    shared-filesystem blip, used by the chaos ladder.
    """

    def __init__(self, io_retries: int = 3, backoff_sec: float = 0.5,
                 backoff_factor: float = 2.0, max_backoff_sec: float = 10.0,
                 sleep: Callable[[float], None] = time.sleep,
                 load: Optional[Callable[[str], np.ndarray]] = None,
                 inject_eio_path: str = "", inject_eio_count: int = 0):
        self.io_retries = max(0, int(io_retries))
        self.backoff_sec = float(backoff_sec)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff_sec = float(max_backoff_sec)
        self._sleep = sleep
        self._load = load
        self._inject_path = inject_eio_path
        self._inject_left = int(inject_eio_count) if inject_eio_path else 0
        self._inject_lock = threading.Lock()
        # observability: how many transient blips were absorbed
        self.transient_recoveries = 0

    def matches_injection(self, path: str) -> bool:
        """True while the chaos EIO injection still targets ``path`` —
        the loader keeps such reads out of the decode process pool
        (spawned workers cannot see the parent's injection state, so a
        pooled read would bypass the hook)."""
        if not self._inject_path or self._inject_path not in path:
            return False
        with self._inject_lock:
            return self._inject_left > 0

    def _maybe_inject(self, path: str) -> None:
        if not self._inject_path or self._inject_path not in path:
            return
        with self._inject_lock:
            if self._inject_left <= 0:
                return
            self._inject_left -= 1
        raise OSError(errno.EIO, "chaos: injected transient I/O error",
                      path)

    def read(self, path: str) -> np.ndarray:
        if self._load is None:
            from eksml_tpu_torch.data.coco import load_image

            self._load = load_image
        delay = self.backoff_sec
        attempts = 0
        while True:
            attempts += 1
            try:
                self._maybe_inject(path)
                image = self._load(path)
                if attempts > 1:
                    with self._inject_lock:  # concurrent decode threads
                        self.transient_recoveries += 1
                    default_registry().counter(
                        "eksml_data_io_recoveries",
                        "transient I/O errors absorbed by bounded "
                        "retry").inc()
                    log.info("transient I/O on %s recovered after %d "
                             "attempt(s)", path, attempts)
                return image
            except ImportError:
                # the decoder itself is missing: no record is at fault
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                if isinstance(e, FileNotFoundError):
                    raise PermanentDataError(path, "missing", e,
                                             attempts) from e
                if classify_error(e) == PERMANENT:
                    raise PermanentDataError(path, "decode", e,
                                             attempts) from e
                if attempts > self.io_retries:
                    raise PermanentDataError(path, "io_exhausted", e,
                                             attempts) from e
                log.warning("transient I/O error on %s (attempt %d/%d):"
                            " %s — retrying in %.2fs", path, attempts,
                            self.io_retries + 1, e, delay)
                self._sleep(delay)
                delay = min(delay * self.backoff_factor,
                            self.max_backoff_sec)


class QuarantineLedger:
    """Append-only record of quarantined records + the circuit breaker.

    One JSONL line per quarantine event under the run's logdir
    (``path=None`` keeps it in-memory — tests, synthetic runs).  A
    record is quarantined at most once: repeat draws of a known-bad
    record substitute silently, so the ledger is a census of distinct
    bad records, not of draws — the count the breaker fraction and the
    acceptance contract ("exactly the two permanent failures") need.

    An existing ledger file is reloaded on init, so a preemption-resume
    with the same logdir keeps the census deduplicated and substitutes
    known-bad records immediately instead of re-paying their retry
    cost.  To re-admit records after repairing the data in place,
    delete the ledger file before relaunching.
    """

    def __init__(self, total_records: int, max_frac: float = 0.05,
                 path: Optional[str] = None, host_id: int = 0):
        self.total_records = max(1, int(total_records))
        self.max_frac = float(max_frac)
        self.path = path
        self.host_id = host_id
        self._lock = threading.Lock()
        self._keys: set = set()
        self.entries: List[Dict] = []
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        entry = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn write from a killed process
                    if entry.get("image_id") not in self._keys:
                        self._keys.add(entry.get("image_id"))
                        self.entries.append(entry)
            if self._keys:
                log.warning(
                    "resuming with %d previously quarantined record(s)"
                    " from %s (delete the file to re-admit repaired "
                    "records)", len(self._keys), path)
                # the breaker must hold across relaunches: a restart
                # already above the threshold would otherwise train on
                # substitutes with no NEW quarantine to trip on
                frac = len(self._keys) / self.total_records
                if frac > self.max_frac:
                    raise QuarantineOverflowError(
                        f"resumed quarantine ledger already lists "
                        f"{len(self._keys)}/{self.total_records} "
                        f"records ({100 * frac:.1f}%) — above "
                        f"RESILIENCE.DATA.MAX_QUARANTINE_FRAC="
                        f"{self.max_frac}. Repair the data and delete "
                        f"the ledger to re-admit records: {path}")

    def is_quarantined(self, key) -> bool:
        with self._lock:
            return key in self._keys

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._keys)

    @property
    def fraction(self) -> float:
        return self.count / self.total_records

    def quarantine(self, key, rec: Dict, kind: str, error: str,
                   attempts: int) -> None:
        """Record one distinct bad record; trips the breaker when the
        quarantined fraction exceeds ``max_frac``."""
        entry = {
            "image_id": rec.get("image_id"), "path": rec.get("path"),
            "kind": kind, "error": error, "attempts": attempts,
            "host_id": self.host_id, "time": time.time(),
        }
        with self._lock:
            if key in self._keys:
                return
            self._keys.add(key)
            self.entries.append(entry)
            frac = len(self._keys) / self.total_records
        log.warning("quarantined record image_id=%s (%s): %s — "
                    "substituting deterministically [%d/%d records, "
                    "%.1f%%]", entry["image_id"], kind, error,
                    self.count, self.total_records, 100 * frac)
        default_registry().counter(
            "eksml_data_quarantined_records",
            "distinct records quarantined by the data-ingest layer",
            labels={"kind": kind}).inc()
        event("quarantine", image_id=entry["image_id"],
                        path=entry["path"], fault_kind=kind,
                        attempts=attempts)
        if self.path:
            # one write() per line: appends stay whole even when
            # multiple hosts share the logdir over NFS
            with open(self.path, "a") as f:
                f.write(json.dumps(entry) + "\n")
        if frac > self.max_frac:
            where = self.path or "<in-memory ledger>"
            raise QuarantineOverflowError(
                f"{len(self._keys)}/{self.total_records} records "
                f"({100 * frac:.1f}%) quarantined — above "
                f"RESILIENCE.DATA.MAX_QUARANTINE_FRAC="
                f"{self.max_frac}. This is systemic data loss (vanished"
                f" mount? mass-truncated staging?), not scattered bad "
                f"records; refusing to train on substitutes. See the "
                f"quarantine ledger: {where}")

    def stats(self) -> Dict:
        return {"quarantined": self.count,
                "quarantine_frac": round(self.fraction, 4),
                "ledger_path": self.path}


class LoaderHealth:
    """Shared producer/consumer health surface for one loader.

    The producer stamps batch-build timings; the consumer stamps
    starvation waits; the fit loop forwards scalars into the metric
    stream and registers :meth:`report` with the hang watchdog, so a
    device idling on an empty queue produces a diagnosis (queue depth,
    stage timing, quarantine census) instead of a bare stack dump.
    """

    def __init__(self, ledger: Optional[QuarantineLedger] = None,
                 reader: Optional[RobustImageReader] = None):
        self._lock = threading.Lock()
        self.ledger = ledger
        self.reader = reader
        self.queue_depth: Callable[[], int] = lambda: 0
        self.producer_alive: Callable[[], bool] = lambda: False
        self._batches_produced = 0
        self._last_batch_ready = time.monotonic()
        self._build_ms_ewma: Optional[float] = None
        self._decode_ms_ewma: Optional[float] = None
        self._starvation_waits = 0
        self._prefetch_wait_ms_ewma: Optional[float] = None
        self._prefetch_batches = 0
        self._pool_rebuilds = 0

    def register_gauges(self, registry=None) -> None:
        """Publish this health surface as collect-time gauges in the
        telemetry registry (``eksml_data_*``) — the /metrics view of
        the same numbers :meth:`scalars` feeds the metric stream.
        Re-registering simply points the series at the newest loader
        (callback semantics, registry.Gauge.set_function)."""
        registry = registry or default_registry()

        def from_scalars(key):
            return lambda: float(self.scalars().get(key, 0.0))

        for key, help_text in (
            ("queue_depth", "host batch queue depth"),
            ("batches_produced", "batches built by the producer"),
            ("starvation_waits", "consumer waits on an empty queue"),
            ("batch_build_ms", "batch assembly ms (ewma)"),
            ("prefetch_wait_ms", "device-prefetch blocking ms (ewma)"),
            ("quarantined", "distinct quarantined records"),
            ("quarantine_frac", "quarantined fraction of the shard"),
        ):
            registry.gauge(f"eksml_data_{key}", help_text
                           ).set_function(from_scalars(key))

    # -- producer side ------------------------------------------------

    def record_batch(self, build_ms: float) -> None:
        with self._lock:
            self._batches_produced += 1
            self._last_batch_ready = time.monotonic()
            self._build_ms_ewma = (
                build_ms if self._build_ms_ewma is None
                else 0.8 * self._build_ms_ewma + 0.2 * build_ms)

    def note_decode(self, ms: float) -> None:
        """Per-image decode timing (called from decode threads)."""
        with self._lock:
            self._decode_ms_ewma = (
                ms if self._decode_ms_ewma is None
                else 0.8 * self._decode_ms_ewma + 0.2 * ms)

    # -- consumer side ------------------------------------------------

    def note_starvation_wait(self) -> None:
        with self._lock:
            self._starvation_waits += 1
        event("starvation")

    def note_pool_rebuild(self) -> None:
        """Decode process-pool self-heal (loader._heal_proc_pool)."""
        with self._lock:
            self._pool_rebuilds += 1

    def note_prefetch_wait(self, ms: float) -> None:
        """Per-batch time the step loop blocked on the device
        prefetcher (loader.DevicePrefetcher).  ~0 = the host→device
        transfer fully overlaps compute; step-sized values mean the
        input pipeline is the bottleneck."""
        with self._lock:
            self._prefetch_batches += 1
            self._prefetch_wait_ms_ewma = (
                ms if self._prefetch_wait_ms_ewma is None
                else 0.8 * self._prefetch_wait_ms_ewma + 0.2 * ms)

    # -- reporting ----------------------------------------------------

    def scalars(self) -> Dict[str, float]:
        """Flat numeric view for the metric stream."""
        with self._lock:
            out = {
                "queue_depth": float(self.queue_depth()),
                "batches_produced": float(self._batches_produced),
                "starvation_waits": float(self._starvation_waits),
                "pool_rebuilds": float(self._pool_rebuilds),
            }
            if self._build_ms_ewma is not None:
                out["batch_build_ms"] = round(self._build_ms_ewma, 2)
            if self._prefetch_wait_ms_ewma is not None:
                out["prefetch_wait_ms"] = round(
                    self._prefetch_wait_ms_ewma, 2)
        if self.reader is not None:
            out["io_recoveries"] = float(
                self.reader.transient_recoveries)
        if self.ledger is not None:
            out["quarantined"] = float(self.ledger.count)
            out["quarantine_frac"] = self.ledger.fraction
        return out

    def report(self) -> str:
        """Multi-line diagnosis for the watchdog's hang report."""
        with self._lock:
            age = time.monotonic() - self._last_batch_ready
            lines = [
                f"queue depth: {self.queue_depth()}",
                f"producer alive: {self.producer_alive()}",
                f"batches produced: {self._batches_produced}",
                f"seconds since last batch ready: {age:.1f}",
                f"consumer starvation waits: {self._starvation_waits}",
            ]
            if self._build_ms_ewma is not None:
                lines.append(
                    f"batch build ms (ewma): {self._build_ms_ewma:.1f}")
            if self._decode_ms_ewma is not None:
                lines.append(
                    f"decode ms (ewma): {self._decode_ms_ewma:.1f}")
            if self._prefetch_wait_ms_ewma is not None:
                lines.append(
                    "device-prefetch wait ms (ewma): "
                    f"{self._prefetch_wait_ms_ewma:.1f} over "
                    f"{self._prefetch_batches} batches")
        if self.reader is not None:
            lines.append("transient I/O recoveries: "
                         f"{self.reader.transient_recoveries}")
        if self.ledger is not None:
            s = self.ledger.stats()
            lines.append(
                f"quarantined: {s['quarantined']} "
                f"({100 * s['quarantine_frac']:.1f}%) — ledger: "
                f"{s['ledger_path'] or '<in-memory>'}")
        return "\n".join(lines)


def ledger_path_for(logdir: Optional[str], host_id: int) -> Optional[str]:
    """Per-host ledger file under the run dir (hosts share the logdir
    on the shared filesystem; one file per host keeps appends local)."""
    if not logdir:
        return None
    os.makedirs(logdir, exist_ok=True)
    return os.path.join(logdir, f"quarantine-host{host_id}.jsonl")
