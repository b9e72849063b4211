"""Divergence sentinel: NaN/Inf loss detection with rollback budget (a
copy of ``eksml_tpu/resilience/sentinel.py``).

A single non-finite ``total_loss`` means the gradients — and therefore
the params after the update — are already poisoned; every later
checkpoint commits the poison and the run is unrecoverable even though
the process never crashes.  The reference stack has nothing here; its
Horovod ranks happily save NaN weights forever (SURVEY.md §5.2/§5.3).

The sentinel is deliberately host-side and cheap: the fit loop feeds
it scalar loss values it was materializing anyway (log boundaries,
checkpoint boundaries — or every ``RESILIENCE.NAN_CHECK_PERIOD`` steps
when the operator wants a tighter guard at the cost of one device sync
per check).  Policy:

- ``patience`` consecutive non-finite observations → roll back to the
  newest verified checkpoint.  The data iterator is NOT rewound, so
  the re-run sees fresh batches — the offending data window is skipped.
- more than ``max_rollbacks`` rollbacks → :class:`DivergenceError`
  with the full observation history (step of first NaN, rollback
  targets), so the pod log says *why* instead of looping silently.
- the fit loop separately refuses to save any state whose loss
  observation was non-finite (:meth:`allows_save`) — no non-finite
  checkpoint is ever committed, whatever the cadence.
"""

from __future__ import annotations

import logging
import math
from typing import List, Optional, Tuple

from eksml_tpu_torch import telemetry

log = logging.getLogger(__name__)

OK = "ok"
WATCH = "watch"        # non-finite seen, patience not yet exhausted
ROLLBACK = "rollback"  # patience exhausted: restore last good state


class DivergenceError(RuntimeError):
    """Training diverged beyond the rollback budget (or with nothing
    to roll back to).  Non-resumable by design: restarting the pod
    would reproduce the same divergence."""


class DivergenceSentinel:
    def __init__(self, patience: int = 3, max_rollbacks: int = 2):
        self.patience = max(1, int(patience))
        self.max_rollbacks = int(max_rollbacks)
        self._consecutive_bad = 0
        self.first_bad_step: Optional[int] = None
        self.rollbacks: List[Tuple[int, int]] = []  # (from_step, to_step)
        self.last_observation: Optional[float] = None

    # -- observation --------------------------------------------------

    def observe(self, step: int, loss: float) -> str:
        """Feed one scalar loss; returns OK / WATCH / ROLLBACK."""
        self.last_observation = loss
        if math.isfinite(loss):
            self._consecutive_bad = 0
            self.first_bad_step = None
            return OK
        self._consecutive_bad += 1
        if self.first_bad_step is None:
            self.first_bad_step = step
        telemetry.default_registry().counter(
            "eksml_resilience_nonfinite_losses",
            "non-finite total_loss observations").inc()
        telemetry.event("nan_observed", step=step, loss=repr(loss),
                        consecutive=self._consecutive_bad)
        log.warning("non-finite total_loss=%r at step %d (%d/%d "
                    "consecutive)", loss, step, self._consecutive_bad,
                    self.patience)
        if self._consecutive_bad < self.patience:
            return WATCH
        self._consecutive_bad = 0  # reset: count anew after rollback
        return ROLLBACK

    def allows_save(self) -> bool:
        """False while the most recent observation was non-finite —
        the guard that keeps poisoned state out of ``ckpt.save``."""
        return (self.last_observation is None
                or math.isfinite(self.last_observation))

    # -- rollback accounting ------------------------------------------

    def register_rollback(self, from_step: int, to_step: int) -> None:
        """Record a rollback; raises :class:`DivergenceError` once the
        budget is exhausted."""
        self.rollbacks.append((from_step, to_step))
        telemetry.default_registry().counter(
            "eksml_resilience_rollbacks",
            "divergence rollbacks to a previous checkpoint").inc()
        if len(self.rollbacks) > self.max_rollbacks:
            raise DivergenceError(self.diagnostic(
                f"exceeded RESILIENCE.MAX_ROLLBACKS={self.max_rollbacks}"))
        log.warning("divergence rollback %d/%d: step %d -> checkpoint "
                    "step %d (data iterator not rewound: offending "
                    "window skipped)", len(self.rollbacks),
                    self.max_rollbacks, from_step, to_step)

    def no_checkpoint_to_restore(self, step: int) -> DivergenceError:
        return DivergenceError(self.diagnostic(
            f"no restorable checkpoint exists at step {step}"))

    def diagnostic(self, headline: str) -> str:
        hist = ", ".join(f"{a}->{b}" for a, b in self.rollbacks) or "none"
        return (
            f"training diverged: {headline}. "
            f"first non-finite loss at step {self.first_bad_step}, "
            f"last observation {self.last_observation!r}, "
            f"rollbacks so far: {hist}. "
            "Likely causes: LR spike at a schedule boundary, corrupt "
            "input batch, or numeric overflow in bf16 — inspect "
            "metrics.jsonl around the first bad step; lower "
            "TRAIN.BASE_LR / raise TRAIN.GRADIENT_CLIP to continue.")
