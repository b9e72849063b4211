"""The port's ``jax.named_scope``: a ``torch.profiler.record_function``
range under one of the reference's scope names, usable as a context
manager or a decorator.  A capture's trace holds the ranges as
``user_annotation`` events, which ``profiling/attribution.py`` resolves
to components under ``SCOPE_RULES``.  With no profiler active a range
costs one small host call (timed by ``chip_smoke.py``'s observe phase)
and records nothing."""

from __future__ import annotations

import contextlib

import torch


class named_scope(contextlib.ContextDecorator):
    """``with named_scope("roi_align"): ...`` or ``@named_scope("nms")``."""

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def _recreate_cm(self):
        # a decorated function enters a fresh range on every call (one
        # shared range would be clobbered by nested or threaded calls)
        return named_scope(self.name)

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        return self._range.__enter__()

    def __exit__(self, *exc):
        rng, self._range = self._range, None
        return rng.__exit__(*exc)
