"""Hang watchdog: heartbeat deadline → all-thread stack dump (a copy of
``eksml_tpu/resilience/watchdog.py``; the host line names the pid only).

The silent failure mode of synchronous SPMD training: one host's DCN
link blips, a collective never completes, and every process sits in
``step_fn`` forever — no crash, no log line, nothing for the operator
to act on until the JobSet's own (much coarser) liveness gives up.
The reference stack is no better off: a wedged NCCL ring just stops
the mpirun output (SURVEY.md §5.3).

A daemon thread tracks the last heartbeat the fit loop recorded
(phase name + step).  When ``deadline_sec`` passes without a beat it
writes ``<logdir>/hang_report_<n>.txt`` — stalled phase, step, elapsed
time, per-host identity, and a stack for every live thread — and logs
an ERROR pointing at it.  It keeps re-arming (a later beat resumes
normal operation; a persistent hang produces a report every deadline)
and can optionally escalate through ``on_hang`` after repeated fires.

The first deadline is stretched by ``first_beat_factor`` because step
one includes cuDNN's autotune of every convolution (about two minutes
for the full model on an H100), which is slow but not hung.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


class HangWatchdog:
    def __init__(self, deadline_sec: float, report_dir: str,
                 first_beat_factor: float = 10.0,
                 poll_sec: Optional[float] = None,
                 on_hang: Optional[Callable[[int, str], None]] = None):
        self.deadline_sec = float(deadline_sec)
        self.report_dir = report_dir
        self.first_beat_factor = max(1.0, float(first_beat_factor))
        self.poll_sec = poll_sec if poll_sec else min(
            1.0, self.deadline_sec / 4)
        self.on_hang = on_hang
        self.fires = 0
        self.reports = []  # paths written, newest last

        self._lock = threading.Lock()
        self._phase = "startup"
        self._step: Optional[int] = None
        self._last_beat = time.monotonic()
        self._compile_headroom = True
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._providers: list = []  # (name, fn) report sections

    def add_report_provider(self, name: str, fn: Callable[[], str]
                            ) -> None:
        """Attach a diagnostic section to every hang report — e.g. the
        data loader's health surface (queue depth, stage timing,
        quarantine census), so input starvation reads as a diagnosis
        instead of a bare stack dump.  ``fn`` is called on the
        watchdog thread at dump time; failures are contained."""
        self._providers.append((name, fn))

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "HangWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()  # a stopped watchdog must restart live
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="eksml-hang-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5 * self.poll_sec)
            if self._thread.is_alive():
                # stuck mid-dump (stalled logdir?) — keep the handle so
                # start() refuses to spawn a second watcher alongside
                # the zombie (which would resume on _stop.clear())
                log.warning("watchdog thread did not exit in time; "
                            "restart disabled until it does")
                return
            self._thread = None

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- heartbeat ----------------------------------------------------

    def beat(self, phase: str, step: Optional[int] = None) -> None:
        """Record progress; called by the fit loop at phase edges
        (next_batch / train_step / checkpoint_save / eval)."""
        with self._lock:
            self._phase = phase
            self._step = step
            self._last_beat = time.monotonic()

    def end_compile_headroom(self) -> None:
        """Switch from the stretched first deadline to the steady-state
        one.  Called by the fit loop AFTER the first jitted step
        returns — a beat cannot end the headroom, because the loop
        beats (to_device, train_step) milliseconds before the
        multi-minute autotune it exists to excuse."""
        with self._lock:
            self._compile_headroom = False
            self._last_beat = time.monotonic()

    # -- the watcher --------------------------------------------------

    def _current_deadline(self) -> float:
        if self._compile_headroom:
            return self.deadline_sec * self.first_beat_factor
        return self.deadline_sec

    def _run(self) -> None:
        while not self._stop.wait(self.poll_sec):
            with self._lock:
                elapsed = time.monotonic() - self._last_beat
                phase, step = self._phase, self._step
                deadline = self._current_deadline()
            if elapsed < deadline:
                continue
            self.fires += 1
            try:
                path = self._dump(phase, step, elapsed)
                self.reports.append(path)
                log.error(
                    "watchdog: no progress for %.1fs (deadline %.1fs) — "
                    "stalled in phase %r at step %s; all-thread stack "
                    "report: %s", elapsed, deadline, phase, step, path)
                # telemetry publish AFTER the dump: the report is the
                # evidence; the event/counter point at it
                from eksml_tpu_torch import telemetry

                telemetry.default_registry().counter(
                    "eksml_resilience_watchdog_fires",
                    "hang-watchdog deadline expiries").inc()
                telemetry.event("watchdog_dump", step=step,
                                phase=phase, report=path,
                                stalled_sec=round(elapsed, 1))
            except Exception:
                log.exception("watchdog report failed")
            if self.on_hang is not None:
                try:
                    self.on_hang(self.fires, phase)
                except Exception:
                    log.exception("watchdog on_hang callback failed")
            with self._lock:
                # re-arm so a persistent hang re-reports every deadline
                self._last_beat = time.monotonic()

    def _dump(self, phase: str, step, elapsed: float) -> str:
        os.makedirs(self.report_dir, exist_ok=True)
        # pid in the name: relaunched incarnations share the logdir and
        # must not clobber the previous run's post-mortem evidence
        path = os.path.join(
            self.report_dir,
            f"hang_report_{os.getpid()}_{self.fires}.txt")
        lines = [
            f"eksml_tpu_torch hang watchdog report #{self.fires}",
            f"time: {time.strftime('%Y-%m-%d %H:%M:%S %z')}",
            f"stalled phase: {phase}",
            f"step: {step}",
            f"seconds since last heartbeat: {elapsed:.1f}",
            f"deadline_sec: {self.deadline_sec}",
            self._host_line(),
            "",
        ]
        for name, fn in self._providers:
            lines.append(f"--- {name} ---")
            try:
                lines.extend(str(fn()).splitlines())
            except Exception as e:  # noqa: BLE001 — report must land
                lines.append(f"<report provider failed: {e!r}>")
            lines.append("")
        from eksml_tpu_torch.telemetry.tracing import format_thread_stacks

        lines.extend(format_thread_stacks().splitlines())
        # atomic: an operator tails these the moment the watchdog
        # fires — never show a half-written report
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.replace(tmp, path)
        return path

    @staticmethod
    def _host_line() -> str:
        """Which process's report this is (one process per host in the
        port until multi-GPU)."""
        return f"host: pid {os.getpid()}"
