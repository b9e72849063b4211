"""In-process resilience layer of the port (copies of
``eksml_tpu/resilience/``, one process):

- :mod:`preemption` — SIGTERM → forced checkpoint at the next step
  boundary → the resumable exit code ``RESILIENCE.PREEMPT_EXIT_CODE``.
- :mod:`integrity` — per-step checkpoint manifests; restore verifies
  and walks back to the newest good step.
- :mod:`sentinel` — NaN/Inf loss → rollback to the last good
  checkpoint, or :class:`DivergenceError` past the budget.
- :mod:`watchdog` — heartbeat deadline → all-thread stack report.
- :mod:`retry` — bounded retry with backoff (the integrity layer's
  file checks).

Knobs live in ``config.RESILIENCE``.
"""

from eksml_tpu_torch.resilience.integrity import (  # noqa: F401
    list_manifest_steps, manifest_path, prune_manifests, quarantine_step,
    verify_step, write_manifest)
from eksml_tpu_torch.resilience.preemption import (  # noqa: F401
    PreemptedError, PreemptionHandler)
from eksml_tpu_torch.resilience.retry import retry_call  # noqa: F401
from eksml_tpu_torch.resilience.sentinel import (  # noqa: F401
    ROLLBACK, DivergenceError, DivergenceSentinel)
from eksml_tpu_torch.resilience.watchdog import HangWatchdog  # noqa: F401
