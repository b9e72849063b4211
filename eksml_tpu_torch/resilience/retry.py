"""Bounded retry with exponential backoff (a copy of
``eksml_tpu/resilience/retry.py``).

The integrity layer retries a transient I/O error while it verifies a
checkpoint file (NFS failover, ESTALE) with it.  Generic on purpose;
anything transient (mount lag, DNS propagation) can use the same
helper.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Tuple, Type

log = logging.getLogger(__name__)


def retry_call(fn: Callable, *, attempts: int = 5,
               backoff_sec: float = 2.0, backoff_factor: float = 2.0,
               max_backoff_sec: float = 60.0,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               describe: str = "operation",
               cleanup: Optional[Callable[[], None]] = None,
               sleep: Callable[[float], None] = time.sleep):
    """Call ``fn`` up to ``attempts`` times.

    Between attempts: run ``cleanup`` (best-effort — e.g. tear down a
    half-initialized distributed runtime) and sleep an exponentially
    growing backoff.  On exhaustion raises ``RuntimeError`` whose
    message carries the attempt count, total wait, and the last
    underlying error (chained via ``__cause__``) — ONE actionable
    error instead of N stack traces.
    """
    attempts = max(1, int(attempts))
    delay = float(backoff_sec)
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 (retry loop)
            last = e
            if attempt == attempts:
                break
            log.warning("%s failed (attempt %d/%d): %s — retrying in "
                        "%.1fs", describe, attempt, attempts, e, delay)
            if cleanup is not None:
                try:
                    cleanup()
                except Exception:
                    log.debug("cleanup between retries failed",
                              exc_info=True)
            sleep(delay)
            delay = min(delay * backoff_factor, max_backoff_sec)
    raise RuntimeError(
        f"{describe} failed after {attempts} attempt(s) over "
        f"{time.monotonic() - t0:.1f}s; last error: {last}") from last
