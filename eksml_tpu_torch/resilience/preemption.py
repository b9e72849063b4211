"""Graceful preemption: SIGTERM → forced checkpoint → resumable exit (a
copy of ``eksml_tpu/resilience/preemption.py``).

Kubernetes sends SIGTERM and waits ``terminationGracePeriodSeconds``
before SIGKILL (the chart sizes that window to cover a forced
checkpoint commit).  The handler here only sets a flag — everything
unsafe in signal context (checkpoint I/O, device syncs) happens at the
next step boundary in the fit loop, which then exits with
``RESILIENCE.PREEMPT_EXIT_CODE``.  The chart's Job podFailurePolicy
matches that exit code and restarts the run without burning a
``maxRestarts`` budget entry.

Under a process group the flag is agreed across ranks with a
collective every ``RESILIENCE.PREEMPT_SYNC_PERIOD`` steps, as the
reference agrees it across hosts: a SIGTERM on any rank makes every
rank commit the forced checkpoint together and exit resumable.
"""

from __future__ import annotations

import logging
import signal
import threading
import time

log = logging.getLogger(__name__)

#: Default "preempted, resumable" exit code.  77 = EX_NOPERM's
#: neighborhood is unused by Python/the runtime; must stay in sync with
#: config.RESILIENCE.PREEMPT_EXIT_CODE and the charts'
#: maskrcnn.preempt_exit_code (tests/test_orchestration.py pins all
#: three together).
DEFAULT_EXIT_CODE = 77


class PreemptedError(SystemExit):
    """Raised at a step boundary after the forced checkpoint committed.

    Subclasses ``SystemExit`` so an uncaught escape still terminates
    the process with the documented resumable code (no traceback spam
    in the pod log), while ``train.main`` can catch it for a clean
    log line first.
    """

    def __init__(self, exit_code: int, step: int):
        super().__init__(exit_code)
        self.exit_code = exit_code
        self.step = step


class PreemptionHandler:
    """Installable SIGTERM (and optionally SIGINT) flag.

    Usage::

        handler = PreemptionHandler(exit_code=cfg.RESILIENCE.PREEMPT_EXIT_CODE)
        handler.install()
        try:
            ...
            if handler.should_checkpoint(step, sync_period):
                ckpt.save(step, state, force=True); ckpt.wait()
                raise handler.preempted(step)
        finally:
            handler.uninstall()
    """

    def __init__(self, exit_code: int = DEFAULT_EXIT_CODE,
                 signals=(signal.SIGTERM,)):
        self.exit_code = exit_code
        self._signals = tuple(signals)
        self._flag = threading.Event()
        self._prev = {}
        self._installed = False
        self.signal_time = None

    # -- signal plumbing ----------------------------------------------

    def _on_signal(self, signum, frame):  # noqa: ARG002 (signal API)
        # FLAG FIRST, and nothing lock-taking after it: the handler
        # runs between bytecodes on the main thread, which holds the
        # telemetry registry/recorder locks many times per log
        # interval — a counter inc or flight-recorder write here
        # would deadlock against the interrupted critical section and
        # the forced checkpoint would never happen.  The telemetry
        # publish for this signal (counter + "sigterm" event) is
        # emitted by the fit loop at the step boundary
        # (train._graceful_exit), outside signal context.
        first = not self._flag.is_set()
        self._flag.set()
        if first:
            self.signal_time = time.time()
            # log from signal context is re-entrant-unsafe in theory;
            # in practice the logging module masks its own locks and
            # this fires once.  Keep it to one line — and keep it the
            # ONLY non-flag operation in any handler (reviewed
            # exception to the flag-only rule, hence the inline
            # suppression rather than a baseline entry).
            log.warning("received signal %d: requesting forced "  # eksml-lint: disable=signal-safety
                        "checkpoint at the next step boundary", signum)

    def install(self) -> "PreemptionHandler":
        """Install handlers (main thread only — signal module rule).
        No-op outside the main thread so library users can't crash."""
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            log.warning("PreemptionHandler.install skipped: not on the "
                        "main thread")
            return self
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # non-main thread/teardown
                pass
        self._prev.clear()
        self._installed = False

    # -- fit-loop API -------------------------------------------------

    @property
    def requested(self) -> bool:
        """This host's local flag (signal seen)."""
        return self._flag.is_set()

    def request(self) -> None:
        """Programmatic preemption request (tests, external pollers
        such as a GCE maintenance-event watcher)."""
        self._flag.set()

    def should_checkpoint(self, step: int, sync_period: int = 1) -> bool:
        """Cross-rank agreement on "checkpoint now and exit".

        Without a process group: the local flag, checked every step.
        With one: the sum of every rank's flag every ``sync_period``
        steps — a collective, so ALL ranks call this at the same steps
        (the fit loop calls it unconditionally each step)."""
        import torch.distributed as dist

        if not dist.is_initialized():
            return self.requested
        if sync_period <= 0:
            sync_period = 1
        if step % sync_period != 0:
            return False
        from eksml_tpu_torch.parallel.collectives import cross_host_sum

        total = cross_host_sum({"preempt": 1.0 if self.requested else 0.0})
        return float(total["preempt"]) > 0.0

    def preempted(self, step: int) -> PreemptedError:
        return PreemptedError(self.exit_code, step)
