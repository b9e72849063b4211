"""Goodput ledger: whole-run wall-clock accounting across restarts
(the port of ``eksml_tpu/telemetry/goodput.py``, the same buckets and
the same bank format, so ``tools/goodput_report.py`` reads the port's
``goodput-host<i>.jsonl`` unchanged).

A step time says how fast a STEP is; this says what fraction of the
run's WALL-CLOCK was steps at all.  A run loses time to the first
step's cuDNN autotune (the ``compile`` bucket in the port),
input stalls, checkpoint commits, eval passes, hangs — and, invisibly
to every in-process metric, to the gap between a preemption exit and
the relaunch's first step.  This module classifies every second of a
run into named buckets and carries the ledger ACROSS restarts:

==================== ===================================================
bucket               wall-clock attributed to it
==================== ===================================================
``train_step``       dispatching/executing train steps — the only
                     *goodput* bucket; everything else is badput
``compile``          the first step, which runs cuDNN's autotune of
                     every convolution (a later bucket shape's
                     autotune lands in ``train_step`` — a documented
                     blind spot)
``data_wait``        the step loop blocked on the input pipeline
``h2d_prefetch_wait`` host→device batch transfer on the loop
                     (``globalize_batch``); with
                     ``TRAIN.PREFETCH_TO_DEVICE`` the transfer
                     overlaps and residual queue-wait shows as
                     ``data_wait``
``checkpoint_save``  step-loop blocking portion of checkpoint saves
``checkpoint_restore`` startup auto-resume + divergence rollbacks
``eval``             the eval hook (coordinator)
``host_overhead``    metric materialization, aggregation collectives,
                     and (spans mode) all unattributed residual
``hang``             watchdog-attributed stall seconds
                     (``watchdog_dump.stalled_sec``)
``downtime``         the gap between the PREVIOUS segment's last
                     observable activity (flight-recorder event or
                     checkpoint commit mtime) and THIS relaunch's
                     ``run_start`` — recovered from
                     ``events-host<i>.jsonl`` + checkpoint timestamps,
                     so it spans restarts and elastic reshards
==================== ===================================================

Two halves, one bucket taxonomy:

- **Live** (:class:`GoodputMeter`, owned by ``Trainer.fit``): fed by
  the EXISTING span layer (a module-level span sink on the tracer —
  zero new hot-path instrumentation) and the flight recorder (an
  event sink), plus phase credits at the loop's cold boundaries
  (compile, restore, checkpoint, eval).  Publishes the rolling
  ``eksml_goodput_ratio`` gauge and monotonic
  ``eksml_badput_seconds_total{bucket=...}`` counters through the
  OpenMetrics exporter — the run-level SLI an elastic controller
  watches — and banks periodic snapshots to
  ``<logdir>/goodput-host<i>.jsonl`` so the ledger survives the
  process.
- **Offline** (:func:`build_ledger`): folds the banked snapshots,
  flight-recorder events, span traces and checkpoint timestamps of a
  whole logdir into ONE cross-restart ledger (segments split at
  ``run_start``, downtime from the inter-segment gaps), rendered by
  ``tools/goodput_report.py`` and ``tools/run_report.py``.

Degradation contract (pinned in tests/test_goodput.py and held to
the reference by tests/test_torch_observability.py): with
``TELEMETRY.TRACING.ENABLED=False`` there are no spans, so the meter
runs COARSE — unattributed wall (which includes data stalls) is
credited to ``train_step`` and the published ratio is an upper bound;
with spans the residual lands in ``host_overhead`` and ``data_wait``
is exact.  Either way the ledger never raises: partial evidence
yields a partial ledger, not a crash.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

# the taxonomy — ONE tuple shared by the meter, the exporter series,
# the offline ledger and the report tools
BUCKETS = ("train_step", "compile", "data_wait", "h2d_prefetch_wait",
           "checkpoint_save", "checkpoint_restore", "eval",
           "host_overhead", "hang", "downtime")
GOODPUT_BUCKET = "train_step"
BADPUT_BUCKETS = tuple(b for b in BUCKETS if b != GOODPUT_BUCKET)

# step-loop SEQUENTIAL spans → buckets.  Producer-thread spans
# (``h2d_prefetch``, ``batch_build``) deliberately have no entry: they
# overlap the loop's wall-clock and would double-count it — the loop's
# own blocking already shows as ``data_wait``.
SPAN_BUCKETS = {
    "train_step": "train_step",
    "data_wait": "data_wait",
    "globalize_batch": "h2d_prefetch_wait",
    "host_metrics": "host_overhead",
    "host_aggregate": "host_overhead",
    "eval": "eval",
    "checkpoint_save": "checkpoint_save",
    "checkpoint_restore": "checkpoint_restore",
}

# exporter series names (the inputs an elastic controller watches) — counters are exposed with the ``_total`` suffix
RATIO_GAUGE = "eksml_goodput_ratio"
BADPUT_COUNTER = "eksml_badput_seconds"
GOODPUT_COUNTER = "eksml_goodput_seconds"


def goodput_path_for(logdir: Optional[str], host_id: int
                     ) -> Optional[str]:
    """Per-host banked-ledger file under the run dir (same contract
    as ``events-host<i>.jsonl``: appends stay host-local)."""
    if not logdir:
        return None
    os.makedirs(logdir, exist_ok=True)
    return os.path.join(logdir, f"goodput-host{host_id}.jsonl")


class GoodputMeter:
    """Live per-segment wall-clock classifier.

    Thread-safe: the span sink fires from the step loop AND (via
    ``complete_span``) producer threads; the event sink fires from
    the watchdog thread.  Nothing blocking runs under the lock.
    """

    def __init__(self, fine: bool = False,
                 segment_start_wall: Optional[float] = None,
                 clock=time.time):
        # fine = a span tracer is installed: span-exact buckets,
        # residual → host_overhead.  coarse = events only: residual →
        # train_step (goodput reads as an upper bound — documented).
        self.fine = bool(fine)
        self._clock = clock
        self.segment_start_wall = float(
            segment_start_wall if segment_start_wall is not None
            else clock())
        self._lock = threading.Lock()
        self._buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._in_compile = False
        self._compile_span_s = 0.0
        # last values pushed to the monotonic exporter counters
        self._published: Dict[str, float] = {}
        self.bank_failures = 0

    # -- feeds ---------------------------------------------------------

    def on_span(self, name: str, dur_s: float,
                step: Optional[int] = None) -> None:
        """Span sink (telemetry.install_span_sink): classify one
        completed step-loop span.  Unmapped spans are ignored —
        overlap-safe by construction (see SPAN_BUCKETS)."""
        bucket = SPAN_BUCKETS.get(name)
        if bucket is None:
            return
        with self._lock:
            if self._in_compile and bucket == "train_step":
                # the first call of the step fn IS the compile; its
                # train_step span must not read as goodput
                bucket = "compile"
                self._compile_span_s += max(0.0, float(dur_s))
            self._buckets[bucket] += max(0.0, float(dur_s))

    def on_event(self, entry: Dict) -> None:
        """Flight-recorder sink (telemetry.add_event_sink): the hang
        bucket is watchdog-attributed — no span ever completes inside
        a wedge, so the watchdog's measurement is the only source."""
        if entry.get("kind") == "watchdog_dump":
            try:
                self.credit("hang", float(entry.get("stalled_sec", 0.0)))
            except (TypeError, ValueError):
                pass

    def credit(self, bucket: str, seconds: float,
               coarse_only: bool = False) -> None:
        """Explicit phase credit from the fit loop's cold boundaries.
        ``coarse_only=True`` marks phases a span already covers in
        fine mode (checkpoint/eval/restore) — crediting them twice
        would double-count the same wall-clock."""
        if coarse_only and self.fine:
            return
        if bucket not in self._buckets:
            return
        with self._lock:
            self._buckets[bucket] += max(0.0, float(seconds))

    def begin_compile(self) -> None:
        with self._lock:
            self._in_compile = True
            self._compile_span_s = 0.0

    def end_compile(self, measured_s: float) -> None:
        """Book the measured compile window.  In fine mode the first
        train_step span was already routed into ``compile`` by the
        flag, and any share of the window outside that span (the
        reference's AOT lowering) is added, so compile ends up the
        full window either way, never double-counted."""
        with self._lock:
            self._in_compile = False
            measured = max(0.0, float(measured_s))
            if self.fine:
                measured = max(0.0, measured - self._compile_span_s)
            self._buckets["compile"] += measured

    # -- output --------------------------------------------------------

    def snapshot(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """Cumulative segment ledger: buckets with the residual routed
        per the mode, wall elapsed (downtime rides on top of the
        segment's own wall), and the rolling goodput ratio."""
        with self._lock:
            buckets = dict(self._buckets)
        elapsed = max(0.0, self._clock() - self.segment_start_wall)
        wall = elapsed + buckets["downtime"]
        accounted = sum(v for b, v in buckets.items()
                        if b != "downtime")
        residual = max(0.0, elapsed - accounted)
        buckets["host_overhead" if self.fine
                else "train_step"] += residual
        ratio = (buckets[GOODPUT_BUCKET] / wall) if wall > 0 else 0.0
        out = {
            "time": self._clock(),
            "segment_start": self.segment_start_wall,
            "elapsed_s": round(elapsed, 3),
            "wall_s": round(wall, 3),
            "mode": "spans" if self.fine else "coarse",
            "buckets": {b: round(v, 3) for b, v in buckets.items()},
            "goodput_ratio": round(min(1.0, max(0.0, ratio)), 6),
        }
        if steps is not None:
            out["steps"] = int(steps)
        return out

    def publish(self, registry, steps: Optional[int] = None
                ) -> Dict[str, Any]:
        """Push the snapshot to the exporter registry: the ratio gauge
        plus MONOTONIC per-bucket badput counters (deltas are clamped
        at 0 — a residual reclassification can never decrement a
        counter)."""
        snap = self.snapshot(steps=steps)
        registry.gauge(
            RATIO_GAUGE,
            "fraction of run wall-clock spent in train steps "
            "(rolling, cumulative per segment incl. recovered "
            "downtime)").set(snap["goodput_ratio"])
        for bucket in BADPUT_BUCKETS:
            cur = snap["buckets"][bucket]
            last = self._published.get(bucket, 0.0)
            delta = cur - last
            if delta > 0:
                registry.counter(
                    BADPUT_COUNTER,
                    "non-training wall-clock seconds by bucket",
                    labels={"bucket": bucket}).inc(delta)
                self._published[bucket] = cur
        cur = snap["buckets"][GOODPUT_BUCKET]
        last = self._published.get(GOODPUT_BUCKET, 0.0)
        if cur - last > 0:
            registry.counter(
                GOODPUT_COUNTER,
                "training wall-clock seconds (the goodput bucket)"
            ).inc(cur - last)
            self._published[GOODPUT_BUCKET] = cur
        return snap

    def bank(self, path: Optional[str], steps: Optional[int] = None,
             final: bool = False) -> Optional[Dict[str, Any]]:
        """Append one snapshot line to the per-host banked ledger.
        Append+flush like the flight recorder (each line is complete;
        the offline reader skips torn tails).  Never raises."""
        snap = self.snapshot(steps=steps)
        if final:
            snap["final"] = True
        if not path:
            return snap
        try:
            with open(path, "a") as f:
                f.write(json.dumps(snap) + "\n")
                f.flush()
        except OSError:
            self.bank_failures += 1
            log.warning("could not bank goodput snapshot to %s", path,
                        exc_info=True)
        return snap


# ---------------------------------------------------------------------
# restart-gap recovery (live side: credit downtime at fit start)
# ---------------------------------------------------------------------


def _read_jsonl(path: str) -> List[Dict]:
    rows: List[Dict] = []
    if not os.path.exists(path):
        return rows
    try:
        with open(path) as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn write from a killed process
    except OSError:
        pass
    return rows


def checkpoint_commit_times(logdir: str) -> List[float]:
    """mtimes of committed ``checkpoints/<step>/`` dirs — the only
    activity trace a segment leaves when it dies without flushing
    events (SIGKILL), and the tiebreaker the downtime recovery uses."""
    d = os.path.join(logdir, "checkpoints")
    out: List[float] = []
    if not os.path.isdir(d):
        return out
    for name in os.listdir(d):
        if not name.isdigit():
            continue
        try:
            out.append(os.path.getmtime(os.path.join(d, name)))
        except OSError:
            continue
    return sorted(out)


def recover_downtime(logdir: Optional[str], host_id: int = 0
                     ) -> Tuple[float, Optional[float]]:
    """``(downtime_s, this_segment_start)`` for the CURRENT relaunch.

    The current segment is the newest ``run_start`` in
    ``events-host<i>.jsonl`` (Trainer.__init__ has already appended
    it by the time fit runs); its downtime is the gap back to the
    previous segment's last observable activity — its newest event,
    or a newer checkpoint-commit mtime (a SIGKILLed segment's last
    trace).  When the previous segment's events are missing ENTIRELY
    (killed before the recorder's first flush) the newest
    checkpoint-commit mtime alone still credits the gap.  A genuine
    first launch (no prior checkpoints) → (0, run_start or None)."""
    if not logdir:
        return 0.0, None
    events = _read_jsonl(os.path.join(logdir,
                                      f"events-host{host_id}.jsonl"))
    starts = [i for i, e in enumerate(events)
              if e.get("kind") == "run_start"]
    if not starts:
        return 0.0, None
    cur = events[starts[-1]]
    cur_t = float(cur.get("time", 0.0))
    if len(starts) < 2:
        # the previous segment left NO events at all (SIGKILL before
        # the recorder's first flush, or an events file lost with the
        # local disk) — its newest checkpoint-commit mtime is still on
        # the shared filesystem and is the only activity trace left.
        # A genuine first launch has no committed checkpoints either,
        # so this stays (0, start) there.
        prev_end = max((t for t in checkpoint_commit_times(logdir)
                        if t < cur_t), default=0.0)
        if prev_end <= 0.0 or cur_t <= prev_end:
            return 0.0, cur_t or None
        return cur_t - prev_end, cur_t
    prev_events = events[starts[-2]:starts[-1]]
    prev_end = max((float(e.get("time", 0.0)) for e in prev_events),
                   default=0.0)
    for t in checkpoint_commit_times(logdir):
        if prev_end < t < cur_t:
            prev_end = t
    if prev_end <= 0.0 or cur_t <= prev_end:
        return 0.0, cur_t or None
    return cur_t - prev_end, cur_t


# ---------------------------------------------------------------------
# offline cross-restart ledger (tools/goodput_report.py, run_report.py)
# ---------------------------------------------------------------------


def _span_rows(logdir: str, host_id: int = 0
               ) -> List[Tuple[float, str, float]]:
    """``(start_wall_s, name, dur_s)`` for every mapped span in
    ``trace-host<host_id>.json`` (tracer timestamps are wall-epoch
    µs).  One host — the ledger is the coordinator's view, like the
    metric stream; a torn/missing file yields no rows (the coarse
    fallback takes over)."""
    rows: List[Tuple[float, str, float]] = []
    path = os.path.join(logdir, f"trace-host{host_id}.json")
    try:
        with open(path) as f:
            doc = json.load(f)
        events = doc.get("traceEvents", []) \
            if isinstance(doc, dict) else []
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return rows
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") not in SPAN_BUCKETS:
            continue
        try:
            rows.append((float(ev["ts"]) / 1e6, str(ev["name"]),
                         float(ev.get("dur", 0.0)) / 1e6))
        except (KeyError, TypeError, ValueError):
            continue
    return rows


def _segment_buckets_from_events(seg_events: List[Dict],
                                 metric_rows: List[Dict],
                                 start: float, end: float,
                                 spans: List[Tuple[float, str, float]]
                                 ) -> Tuple[Dict[str, float], str]:
    """Fallback classification for a segment with no banked snapshot:
    duration-carrying flight events first, spans when the run traced,
    the metric stream's step times for train_step otherwise."""
    buckets = {b: 0.0 for b in BUCKETS}
    for e in seg_events:
        kind = e.get("kind")
        try:
            if kind == "compile_done":
                buckets["compile"] += float(e.get("compile_ms", 0)) / 1e3
            elif kind == "eval_done":
                buckets["eval"] += float(e.get("eval_ms", 0)) / 1e3
            elif kind == "checkpoint_save":
                buckets["checkpoint_save"] += \
                    float(e.get("save_ms", 0)) / 1e3
            elif kind == "checkpoint_restore":
                buckets["checkpoint_restore"] += \
                    float(e.get("restore_ms", 0)) / 1e3
            elif kind == "watchdog_dump":
                buckets["hang"] += float(e.get("stalled_sec", 0))
        except (TypeError, ValueError):
            continue
    seg_spans = [(t, n, d) for t, n, d in spans if start <= t < end]
    mode = "events"
    if seg_spans:
        mode = "events+spans"
        # spans supersede the event durations for the phases both
        # cover — zero those buckets before folding the span view in
        for b in ("eval", "checkpoint_save", "checkpoint_restore"):
            buckets[b] = 0.0
        # compile windows (compile_start..compile_done): the first
        # train_step span is the compiling dispatch and its wall is
        # already booked from compile_ms — crediting it as train too
        # would double-count (the live meter's _in_compile routing,
        # reproduced offline)
        windows, t_open = [], None
        for e in seg_events:
            if e.get("kind") == "compile_start":
                t_open = float(e.get("time", 0.0))
            elif e.get("kind") == "compile_done" and t_open is not None:
                windows.append((t_open, float(e.get("time", 0.0))))
                t_open = None
        if t_open is not None:  # died mid-compile: open-ended window
            windows.append((t_open, float("inf")))
        for t, name, dur in seg_spans:
            if name == "train_step" and any(
                    lo <= t < hi for lo, hi in windows):
                continue
            buckets[SPAN_BUCKETS[name]] += dur
    else:
        # train_step from the metric stream: each logged row's mean
        # step time × the steps the interval covered
        prev_step = None
        for r in metric_rows:
            t = r.get("time")
            if (not isinstance(t, (int, float))
                    or not start <= t < end):
                continue
            st = r.get("step_time_ms")
            step = r.get("step")
            if not isinstance(st, (int, float)) or step is None:
                continue
            n = 1 if prev_step is None else max(1, int(step) - prev_step)
            prev_step = int(step)
            buckets["train_step"] += float(st) * n / 1e3
    return buckets, mode


def build_ledger(logdir: str, host_id: int = 0) -> Dict[str, Any]:
    """The cumulative cross-restart ledger of one logdir.

    Segments split at ``run_start`` events (host ``host_id``'s file —
    the coordinator's view).  Per-segment buckets come from the
    banked ``goodput-host<i>.jsonl`` snapshots when present (the live
    meter's exact accounting), else are reconstructed from
    events/spans/metrics.  Inter-segment ``downtime`` is recovered
    from the event/checkpoint timestamps — the TIMESTAMP-derived gap
    is authoritative; a banked snapshot's own recovered-downtime
    bucket is dropped so the boundary is never counted twice.

    Degrades, never raises: an empty logdir yields an empty ledger
    with a note."""
    events = _read_jsonl(os.path.join(logdir,
                                      f"events-host{host_id}.jsonl"))
    # path built directly (goodput_path_for is the WRITER contract —
    # it mkdirs the logdir, which a read-only report must not)
    banked = _read_jsonl(os.path.join(logdir,
                                      f"goodput-host{host_id}.jsonl"))
    metric_rows = _read_jsonl(os.path.join(logdir, "metrics.jsonl"))
    starts = [i for i, e in enumerate(events)
              if e.get("kind") == "run_start"]
    if not starts:
        return {"logdir": logdir, "segments": [], "buckets": {},
                "total_wall_s": 0.0, "goodput_ratio": 0.0,
                "downtime": {"between_segments_s": [], "total_s": 0.0},
                "note": ("no run_start events in "
                         f"events-host{host_id}.jsonl — nothing to "
                         "account")}
    spans = _span_rows(logdir, host_id)
    ckpt_times = checkpoint_commit_times(logdir)
    bank_times = [float(s.get("time", 0.0)) for s in banked]

    bounds = [float(events[i].get("time", 0.0)) for i in starts]
    bounds.append(float("inf"))
    segments: List[Dict[str, Any]] = []
    for k, i in enumerate(starts):
        start, next_start = bounds[k], bounds[k + 1]
        j = starts[k + 1] if k + 1 < len(starts) else len(events)
        seg_events = events[i:j]
        header = events[i]
        # segment end: the last observable activity inside the window
        end = max((float(e.get("time", 0.0)) for e in seg_events),
                  default=start)
        for t in (ckpt_times + bank_times):
            if start <= t < next_start:
                end = max(end, t)
        for r in metric_rows:
            # scalar rows only: a relaunch's run_start HEADER is
            # written milliseconds before its flight-recorder
            # run_start event and would otherwise extend the PREVIOUS
            # segment right up to the relaunch, erasing the downtime
            # gap the ledger exists to measure
            if r.get("event") is not None:
                continue
            t = r.get("time")
            if isinstance(t, (int, float)) and start <= t < next_start:
                end = max(end, float(t))
        # banked snapshots for THIS segment: a snapshot belongs to
        # the run_start NEAREST its segment_start (the live meter
        # pins segment_start to the run_start event time, so the
        # match is ~exact; a fixed slack window would let a crash
        # loop under the slack attribute the PREVIOUS segment's
        # cumulative rows to the next one and double-count them),
        # newest wins (cumulative)
        starts_wall = bounds[:-1]

        def _nearest(t: float) -> int:
            return min(range(len(starts_wall)),
                       key=lambda j: abs(t - starts_wall[j]))

        seg_bank = [
            s for s in banked
            if isinstance(s.get("segment_start"), (int, float))
            and _nearest(float(s["segment_start"])) == k
            and abs(float(s["segment_start"]) - start) <= 2.0]
        steps = max((int(e["step"]) for e in seg_events
                     if isinstance(e.get("step"), int)), default=0)
        if seg_bank:
            last = seg_bank[-1]
            buckets = {b: float(last.get("buckets", {}).get(b, 0.0))
                       for b in BUCKETS}
            mode = "banked:" + str(last.get("mode", "?"))
            steps = int(last.get("steps", steps) or steps)
        else:
            buckets, mode = _segment_buckets_from_events(
                seg_events, metric_rows, start, next_start, spans)
        # the boundary gap below is authoritative for downtime —
        # never double-count the live meter's own recovery of it
        buckets["downtime"] = 0.0
        segments.append({
            "index": k + 1,
            "start": start,
            "end": round(end, 3),
            "wall_s": round(max(0.0, end - start), 3),
            "steps": steps,
            "mode": mode,
            "host_count": header.get("host_count"),
            "config_digest": header.get("config_digest"),
            "resharded": any(
                e.get("kind") == "checkpoint_resharded"
                or (e.get("kind") == "checkpoint_restore"
                    and e.get("resharded"))
                for e in seg_events),
            "buckets": {b: round(v, 3) for b, v in buckets.items()},
        })

    gaps = [round(max(0.0, segments[k + 1]["start"]
                      - segments[k]["end"]), 3)
            for k in range(len(segments) - 1)]
    merged = {b: 0.0 for b in BUCKETS}
    for seg in segments:
        for b in BUCKETS:
            merged[b] += seg["buckets"][b]
    merged["downtime"] = sum(gaps)
    total_wall = max(0.0, segments[-1]["end"] - segments[0]["start"])
    train = merged[GOODPUT_BUCKET]
    ratio = (train / total_wall) if total_wall > 0 else 0.0
    return {
        "logdir": logdir,
        "host": host_id,
        "segments": segments,
        "downtime": {"between_segments_s": gaps,
                     "total_s": round(sum(gaps), 3)},
        "buckets": {b: round(v, 3) for b, v in merged.items()},
        "badput_s": {b: round(merged[b], 3) for b in BADPUT_BUCKETS},
        "train_s": round(train, 3),
        "total_wall_s": round(total_wall, 3),
        "goodput_ratio": round(min(1.0, max(0.0, ratio)), 6),
        "accounted_frac": round(
            min(1.0, sum(merged.values()) / total_wall), 6)
        if total_wall > 0 else 0.0,
    }
