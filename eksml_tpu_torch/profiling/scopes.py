"""The port's ``jax.named_scope``: a ``torch.profiler.record_function``
range under one of the reference's scope names, usable as a context
manager or a decorator.  A capture's trace holds the ranges as
``user_annotation`` events, which ``profiling/attribution.py`` resolves
to components under ``SCOPE_RULES``.  With no profiler active a range
costs one small host call (timed by ``chip_smoke.py``'s observe phase)
and records nothing.

Each thread also keeps its stack of open scope names
(:func:`scope_path`), which the step counter of ``profiling/predict.py``
reads for every operation it counts.  That counter registers itself
here while it runs (:func:`set_counter`); the kernels' wrappers, whose
launches go through ctypes and stay invisible to it, hand it their
calls through :func:`counted_call`."""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Tuple

import torch

_local = threading.local()
# the active step counter (profiling/predict.py StepCounter), or None
_COUNTER = [None]


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def scope_names() -> Tuple[str, ...]:
    """The scope names open on this thread, outermost first."""
    return tuple(_stack())


def scope_path() -> str:
    """The open scope names on this thread joined by ``/``."""
    return "/".join(_stack())


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
        out = self._range.__enter__()
        _stack().append(self.name)
        counter = _COUNTER[0]
        if counter is not None:
            counter.on_scope()
        return out

    def __exit__(self, *exc):
        rng, self._range = self._range, None
        try:
            return rng.__exit__(*exc)
        finally:
            _stack().pop()
            counter = _COUNTER[0]
            if counter is not None:
                counter.on_scope()


def set_counter(counter) -> Optional[object]:
    """Install ``counter`` (None: none) as the active step counter;
    returns the previous one."""
    prev, _COUNTER[0] = _COUNTER[0], counter
    return prev


def counted_call(kind: str, fn: Callable, *args):
    """``fn(*args)``.  While a step counter runs, the operations inside
    are not counted one by one: the counter counts the call once, as
    ``kind``, from its arguments and result (a hand-written kernel's
    closed form)."""
    counter = _COUNTER[0]
    if counter is None:
        return fn(*args)
    return counter.opaque_call(kind, fn, args)


@contextlib.contextmanager
def uncounted():
    """Operations inside are not counted by an active step counter (the
    kernels' cached, read-only buffers made at first use)."""
    counter = _COUNTER[0]
    if counter is None:
        yield
        return
    with counter.suspended():
        yield


def recomputed(fn: Callable) -> Callable:
    """``fn`` for ``torch.utils.checkpoint``: a call made inside the
    backward pass (REMAT's recompute) is marked as such on its thread
    for the step counter; the forward call is untouched."""

    def call(*args, **kwargs):
        if torch._C._current_autograd_node() is None:
            return fn(*args, **kwargs)
        prev = getattr(_local, "recompute", False)
        _local.recompute = True
        try:
            return fn(*args, **kwargs)
        finally:
            _local.recompute = prev

    return call


def in_recompute() -> bool:
    """True inside a :func:`recomputed` call made by the backward."""
    return getattr(_local, "recompute", False)
