"""Typed in-process metric registry: the single telemetry sink.

Before this layer, every subsystem kept its own ad-hoc dict of numbers
(``LoaderHealth.scalars()``, ``DevicePrefetcher.wait_ms_ewma``,
sentinel/watchdog attributes) and only what the fit loop hand-copied
into ``MetricWriter`` ever left the process — and only on rank 0.
The registry gives every subsystem one typed publish surface
(:class:`Counter` / :class:`Gauge` / :class:`Histogram`), and the
OpenMetrics exporter (telemetry/exporter.py) serves the whole registry
from every pod, so per-host signals are scrapeable fleet-wide.

Design rules:

- get-or-create: ``registry.counter("x")`` returns the existing series
  when one is already registered (subsystems are constructed many
  times per process in tests); re-registering under a different TYPE
  raises — a name must mean one thing.
- series = family name + fixed label set.  Families share TYPE/HELP;
  ``registry.counter("eksml_data_quarantined_records",
  labels={"kind": "decode"})`` and ``... "missing"`` are two series of
  one family.
- thread-safe and cheap: one lock per series for value updates, one
  registry lock for (rare) registration.  Collect-time callbacks
  (``Gauge.set_function``) let surfaces like queue depth be read lazily
  at scrape time instead of pushed every step.
- dependency-free: no prometheus_client; exposition lives in
  telemetry/exporter.py.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# default histogram buckets in milliseconds — wide enough for both a
# ~100 ms TPU step and a multi-second checkpoint commit
DEFAULT_BUCKETS_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                      1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _check_labels(labels: Optional[Dict[str, str]]
                  ) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    out = []
    for k in sorted(labels):
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
        out.append((k, str(labels[k])))
    return tuple(out)


class _Series:
    """One (family, labelset) time series."""

    def __init__(self, labels: Tuple[Tuple[str, str], ...]):
        self.labels = labels
        self._lock = threading.Lock()


class Counter(_Series):
    """Monotonic accumulator.  ``inc`` only; exposed as ``name_total``."""

    def __init__(self, labels=()):
        super().__init__(labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Series):
    """Point-in-time value; ``set_function`` makes it collect-time lazy
    (the callback is re-settable so a new loader/health instance simply
    takes the series over)."""

    def __init__(self, labels=()):
        super().__init__(labels)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._fn = None
            self._value += amount

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 — a dead callback reads 0
            return 0.0


class Histogram(_Series):
    """Cumulative-bucket histogram (OpenMetrics semantics)."""

    def __init__(self, labels=(), buckets: Iterable[float] = ()):
        super().__init__(labels)
        bs = tuple(sorted(float(b) for b in buckets)) or DEFAULT_BUCKETS_MS
        if any(not math.isfinite(b) for b in bs):
            raise ValueError("histogram buckets must be finite "
                             "(+Inf is implicit)")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # +1 = the +Inf bucket
        self._sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
        return None

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
        cum, running = [], 0
        for c in counts:
            running += c
            cum.append(running)
        return cum, total_sum, running


class _Family:
    def __init__(self, name: str, kind: str, help_text: str):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.series: Dict[Tuple[Tuple[str, str], ...], _Series] = {}


class MetricRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- registration (get-or-create) ---------------------------------

    def _series(self, name: str, kind: str, help_text: str,
                labels: Optional[Dict[str, str]], factory):
        _check_name(name)
        key = _check_labels(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_text)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"cannot re-register as {kind}")
            if help_text and not fam.help:
                fam.help = help_text
            series = fam.series.get(key)
            if series is None:
                series = factory(key)
                fam.series[key] = series
            return series

    def counter(self, name: str, help_text: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._series(name, COUNTER, help_text, labels, Counter)

    def gauge(self, name: str, help_text: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._series(name, GAUGE, help_text, labels, Gauge)

    def histogram(self, name: str, help_text: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Iterable[float] = ()) -> Histogram:
        return self._series(
            name, HISTOGRAM, help_text, labels,
            lambda key: Histogram(key, buckets=buckets))

    # -- collection ---------------------------------------------------

    def collect(self) -> List[_Family]:
        """Families sorted by name; series sorted by label tuple —
        deterministic exposition order."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        return fams

    def get(self, name: str,
            labels: Optional[Dict[str, str]] = None) -> Optional[_Series]:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam.series.get(_check_labels(labels))

    def clear(self) -> None:
        """Drop everything — tests only."""
        with self._lock:
            self._families.clear()


# -- process-default registry -----------------------------------------

_default = MetricRegistry()


def default_registry() -> MetricRegistry:
    return _default
