"""Metric writing: ``metrics.jsonl``, TensorBoard event files of every
scalar (``utils/tfevents.py``, the port's own writer: the files appear
whatever is installed, where the reference's need ``flax.metrics``'
TensorBoard backend), and a mirror of every scalar into the telemetry
registry (``eksml_train_*`` gauges).  A copy of
``eksml_tpu/utils/metrics.py``; ``enable_tensorboard=False`` writes no
event file.

JSONL contract:

- every line is STRICT JSON.  ``json.dumps`` would happily emit bare
  ``NaN``/``Infinity`` tokens for a diverged loss — which are not JSON
  and break every downstream parser at exactly the row a post-mortem
  needs most.  Non-finite scalars are serialized as ``null`` with the
  raw float preserved in a ``<key>_raw_repr`` string field.
- each (re)launch writes ONE ``{"event": "run_start", ...}`` header
  row (argv, config digest, host count, git sha) before any scalars,
  so a logdir shared across preemption relaunches segments cleanly.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import time
from typing import Dict, Optional

from eksml_tpu_torch.utils.tfevents import EventFileWriter


def _git_sha() -> str:
    """Best-effort HEAD sha of the installed framework tree (no
    subprocess: the trainer may run in a stripped container)."""
    try:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        head_path = os.path.join(repo, ".git", "HEAD")
        with open(head_path) as f:
            head = f.read().strip()
        if head.startswith("ref:"):
            ref = head.split(None, 1)[1]
            with open(os.path.join(repo, ".git", *ref.split("/"))) as f:
                return f.read().strip()[:12]
        return head[:12]
    except OSError:
        return "unknown"


# names whose registry mirror failed (type collision / bad name):
# warned once each, process-wide
_mirror_warned: set = set()


def sanitize_row(scalars: Dict[str, float]) -> Dict:
    """Float-cast ``scalars`` for a strict-JSON row: finite values pass
    through; NaN/Inf become ``None`` plus ``<key>_raw_repr``."""
    out: Dict = {}
    for k, v in scalars.items():
        f = float(v)
        if math.isfinite(f):
            out[k] = f
        else:
            out[k] = None
            out[f"{k}_raw_repr"] = repr(f)
    return out


class MetricWriter:
    def __init__(self, logdir: str, enable_tensorboard: bool = True,
                 run_info: Optional[Dict] = None,
                 publish_registry: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._publish_registry = publish_registry
        self._tb = EventFileWriter(logdir) if enable_tensorboard else None
        self._write_run_start(run_info or {})

    def _write_run_start(self, run_info: Dict) -> None:
        rec = {
            "event": "run_start",
            "time": time.time(),
            "argv": list(sys.argv),
            "pid": os.getpid(),
            "host_count": 1,
            "git_sha": _git_sha(),
        }
        rec.update(run_info)  # config_digest etc. from the Trainer
        self._jsonl.write(json.dumps(rec, allow_nan=False,
                                     default=str) + "\n")
        self._jsonl.flush()

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        # registry FIRST, file second: a scraper that saw the JSONL
        # row must never observe a registry older than it (the chaos
        # rung scrapes the instant the first row lands)
        if self._publish_registry:
            self._mirror_to_registry(step, scalars)
        rec = {"step": int(step), "time": time.time()}
        rec.update(sanitize_row(scalars))
        # allow_nan=False is the backstop: a non-finite value that
        # slipped past sanitize_row fails HERE, not in every consumer
        self._jsonl.write(json.dumps(rec, allow_nan=False) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalars(step, {k: float(v)
                                        for k, v in scalars.items()},
                                 wall_time=rec["time"])

    @staticmethod
    def _mirror_to_registry(step: int, scalars: Dict[str, float]) -> None:
        """Every scalar the trainer logs is also a scrapeable
        ``eksml_train_<name>`` gauge (non-finite values pass through:
        OpenMetrics gauges may be NaN, and a diverged loss SHOULD look
        diverged on the dashboard)."""
        from eksml_tpu_torch.telemetry.registry import default_registry

        reg = default_registry()
        reg.gauge("eksml_train_step", "last logged training step"
                  ).set(float(step))
        for k, v in scalars.items():
            name = "eksml_train_" + "".join(
                c if (c.isalnum() or c == "_") else "_" for c in k)
            try:
                reg.gauge(name).set(float(v))
            except ValueError as e:
                # invalid sanitized name, or the name is already a
                # non-gauge family — the scalar is NOT scrapeable, and
                # silence would hide that forever.  One warning per
                # name.
                if name not in _mirror_warned:
                    _mirror_warned.add(name)
                    logging.getLogger(__name__).warning(
                        "metric %r not mirrored to the telemetry "
                        "registry: %s", k, e)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
