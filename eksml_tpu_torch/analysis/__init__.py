"""eksml-lint for the port: framework-invariant static analysis of
``eksml_tpu_torch`` (the port of ``eksml_tpu/analysis/``, with the same
thirteen rules under the same names, so suppressions and ``--rules``
read the same in both packages).

Module and project rules (:mod:`.checkers`):

- ``jit-purity``        — what autograd runs twice (callables passed to
  ``torch.utils.checkpoint.checkpoint``, ``torch.autograd.Function``
  ``forward``/``backward``) reads no wall clock, draws no host RNG,
  mutates no environment and does no host I/O
- ``config-drift``      — after ``--config`` overrides land via
  ``update_args``, the shadowed argparse attribute is not read
- ``signal-safety``     — ``signal.signal`` handlers are flag-only: no
  registry/recorder/logging/lock acquisition in their call graph
- ``atomic-write``      — artifact writes follow write-then-
  ``os.replace`` (``fsio.atomic_write_text``) so a reader never sees a
  torn file
- ``scope-coverage``    — every ``named_scope``/``record_function`` in
  ``models/``, ``ops/`` and ``train.py`` resolves under
  ``profiling/attribution.py``'s ``SCOPE_RULES`` and every rule keeps
  an anchor in the tree
- ``values-config-sync``— the GPU charts' values render into
  ``--config`` keys that exist in the port's ``config.py``, and no
  values key goes dead

The four SPMD-safety rules (:mod:`.spmd`) on the whole-program call
graph (:mod:`.graph`):

- ``collective-order``  — no ``torch.distributed`` collective (or
  DTensor ``redistribute``/``full_tensor``, or a wrapper of one)
  reachable only under a rank-divergent conditional, inside an
  exception handler, or after a rank-divergent early exit that a
  collective can follow
- ``rng-discipline``    — the zero-RNG contract set (loader quarantine
  substitution, span tracing, telemetry aggregation) reaches no host or
  torch RNG draw through any call chain
- ``host-sync``         — no per-step device sync (``.item()``,
  ``.cpu()``, ``torch.cuda.synchronize`` …) on the hot loop
  (``Trainer.fit``, ``DevicePrefetcher``) outside justified suppressions
- ``recompile-hazard``  — batch-content ``len``/``.shape[i]`` does not
  size what reaches the training step or a model forward outside the
  bucketed shape schedule (a new shape is a new cuDNN autotune)

The three thread-topology rules (:mod:`.concurrency`): ``lock-order``,
``unlocked-shared-state``, ``blocking-under-lock``.

Entry point: ``python -m eksml_tpu_torch.tools.eksml_lint`` (JSON and
human output — findings carry the root→sink ``chain`` — a committed
baseline, ``# eksml-lint: disable=<rule>`` suppressions, ``--changed``
for the files changed against a git ref, nonzero exit on any finding
that is neither suppressed nor baselined).  The package imports neither
torch nor JAX: it reads source.
"""

from eksml_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    LintResult,
    load_baseline,
    run_lint,
)
from eksml_tpu_torch.analysis.checkers import ALL_RULES  # noqa: F401
