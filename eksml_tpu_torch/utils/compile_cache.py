"""cuDNN's algorithm choice for the port's convolutions, set in one place.

The counterpart of ``eksml_tpu/utils/compile_cache.py``
(``enable_persistent_cache``).  There, every process start of the
reference pays XLA's compile of its programs, and a cache on disk makes
that a cost per program.  The port compiles nothing at run time: its
CUDA kernels and host libraries are built once, into the image or
``_build/``.  What a process start pays instead is cuDNN's autotune:
under ``torch.backends.cudnn.benchmark`` each new convolution shape
times the algorithms cuDNN offers and keeps the fastest.  PyTorch keeps
those choices in memory only, per process and per thread, and has no way
to save or load them, so nothing is written to disk here.  What can be
chosen is how a process picks its algorithms.  A shorter autotune
(``benchmark_limit=2``) and cuDNN's heuristics (no timing at all) were
measured beside the full autotune; each starts a process faster, and
neither kept every point's steady step within the noise in every run,
so every row keeps the full autotune.

:func:`choose_cudnn_algorithms` applies :data:`POLICY` for a process's
mode and ``TRAIN.PRECISION``.  The trainer, the serving engine and the
evaluator call it where they take their config; nothing else in the port
sets ``torch.backends.cudnn.benchmark`` or ``benchmark_limit``.  The
table is the autotune phase of ``chip_smoke.py`` read by the rule in
``PERF.md``: keep the full autotune unless another setting's steady step
is within the noise of it in every run, then take the fastest start.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

log = logging.getLogger(__name__)

#: PyTorch's own default ``torch.backends.cudnn.benchmark_limit``
DEFAULT_BENCHMARK_LIMIT = 10

#: the settings a row of :data:`POLICY` can take
SETTINGS: Dict[str, Dict[str, object]] = {
    # every algorithm cuDNN lists, up to PyTorch's default limit
    "autotune": {"benchmark": True,
                 "benchmark_limit": DEFAULT_BENCHMARK_LIMIT},
}

#: (train or serve, TRAIN.PRECISION) -> a key of :data:`SETTINGS`, as
#: the rule read chip_smoke.py's autotune phase on an NVIDIA H100 80GB
#: HBM3 at 700 W (PERF.md holds the numbers)
POLICY: Dict[tuple, str] = {
    ("train", "float32"): "autotune",
    ("train", "bfloat16"): "autotune",
    ("serve", "float32"): "autotune",
    ("serve", "bfloat16"): "autotune",
}

MODES = ("train", "serve", "eval")

# the policy this process applied last (None before the first call)
_applied: Optional[Dict[str, object]] = None


def policy_for(mode: str, precision: str) -> Dict[str, object]:
    """The record :func:`choose_cudnn_algorithms` applies for ``mode`` at
    ``precision``: ``{"mode", "precision", "setting", "benchmark",
    "benchmark_limit"}``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    # the evaluator is inference at the eval batch: the serving row
    setting = POLICY["serve" if mode == "eval" else mode, str(precision)]
    return {"mode": mode, "precision": str(precision), "setting": setting,
            **SETTINGS[setting]}


def choose_cudnn_algorithms(cfg, mode: str,
                            keep_process_policy: bool = False
                            ) -> Dict[str, object]:
    """Set how cuDNN picks convolution algorithms in this process, from
    :data:`POLICY` for ``mode`` (``train``, ``serve`` or ``eval``) and
    ``cfg.TRAIN.PRECISION``, and return the applied record
    (:func:`policy_for`).  Logged when it changes, so once per process
    for an entry point.

    With ``keep_process_policy`` a policy this process already applied
    stays (an eval inside a training process keeps the trainer's).

    The flags are process-wide and cost nothing off CUDA: a CPU run
    applies and records the same policy."""
    global _applied
    if keep_process_policy and _applied is not None:
        return dict(_applied)
    rec = policy_for(mode, str(cfg.TRAIN.PRECISION))
    torch.backends.cudnn.benchmark = bool(rec["benchmark"])
    torch.backends.cudnn.benchmark_limit = int(rec["benchmark_limit"])
    if rec != _applied:
        log.info("cuDNN algorithm choice for %s at %s: %s (benchmark=%s, "
                 "benchmark_limit=%s)", mode, rec["precision"],
                 rec["setting"], rec["benchmark"], rec["benchmark_limit"])
    _applied = rec
    return dict(rec)
