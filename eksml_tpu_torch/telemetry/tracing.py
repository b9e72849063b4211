"""Request-lifecycle spans (the span layer of
``eksml_tpu/telemetry/tracing.py``): a bounded ring of Chrome-trace
events that ``Tracer.flush`` writes as JSON.  Without an installed
tracer :func:`complete_span` is a no-op."""

from __future__ import annotations

import collections
import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


class Tracer:
    """Bounded, thread-safe ring of Chrome-trace span events.  Timestamps
    are wall-clock microseconds from ONE ``(time.time, perf_counter)``
    epoch pair taken at construction: monotonic within the process."""

    def __init__(self, capacity: int = 4096, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(16, int(capacity)))
        self._epoch_wall_us = time.time() * 1e6
        self._epoch_perf = time.perf_counter()

    def _complete(self, name: str, t0: float, t1: float,
                  attrs: Optional[Dict]) -> None:
        ev = {"name": str(name), "ph": "X",
              "ts": round(self._epoch_wall_us
                          + (t0 - self._epoch_perf) * 1e6, 3),
              "dur": round((t1 - t0) * 1e6, 3),
              "pid": 0,
              "tid": threading.get_ident() % 2 ** 31,
              "args": dict(attrs or {})}
        with self._lock:
            self._ring.append(ev)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Write the ring as one Chrome-trace JSON document, atomically
        (write-then-rename).  Never raises: a full disk must not take
        down the server."""
        path = path or self.path
        if not path:
            return None
        doc = {"traceEvents": self.snapshot(), "displayTimeUnit": "ms"}
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            return path
        except OSError:
            log.warning("could not write span trace %s", path,
                        exc_info=True)
            return None


_tracer: Optional[Tracer] = None
_install_lock = threading.Lock()


def install_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or with ``None``, remove) the process tracer; returns
    the previous one so callers can restore it."""
    global _tracer
    with _install_lock:
        prev, _tracer = _tracer, tracer
    return prev


def complete_span(name: str, t0: float, t1: float, **attrs) -> None:
    """Record an already-measured interval (``time.perf_counter``
    endpoints) as a span.  No-op without an installed tracer."""
    t = _tracer
    if t is not None:
        t._complete(name, t0, t1, attrs)


def format_thread_stacks() -> str:
    """All live threads' stacks as text (the hang watchdog's reports)."""
    frames = sys._current_frames()
    threads = {t.ident: t for t in threading.enumerate()}
    lines = [f"{len(frames)} thread(s) at "
             f"{time.strftime('%Y-%m-%d %H:%M:%S %z')}", ""]
    for ident, frame in frames.items():
        t = threads.get(ident)
        name = t.name if t else f"unknown-{ident}"
        daemon = getattr(t, "daemon", "?")
        lines.append(f"--- thread {name} (ident={ident}, "
                     f"daemon={daemon}) ---")
        lines.extend(line.rstrip("\n")
                     for line in traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines)
