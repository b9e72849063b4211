"""Live device-memory gauges (``publish_hbm_gauges`` of
``eksml_tpu/profiling/memory.py``, under the same gauge names), fed by
``torch.cuda.memory_stats()``: the caching allocator's bytes allocated
now and at its peak on the trainer's device.  The reference's HLO
liveness walk (``analyze_memory``) has no counterpart yet (ROADMAP.md
Queue 1 item 7)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

HBM_IN_USE_GAUGE = "eksml_train_hbm_bytes_in_use"
HBM_PEAK_GAUGE = "eksml_train_hbm_peak_bytes"


def publish_hbm_gauges(device, registry=None) -> Optional[Dict[str, int]]:
    """Best effort: on a CUDA ``device`` publish
    ``eksml_train_hbm_bytes_in_use`` and ``eksml_train_hbm_peak_bytes``
    (``allocated_bytes.all.current`` / ``.peak``) and return them; on the
    CPU, or where the allocator reports nothing, do nothing and return
    None.  Never raises: a missing gauge must not end a training loop."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats(device)
    except Exception:  # noqa: BLE001 — a gauge never ends training
        return None
    in_use = stats.get("allocated_bytes.all.current")
    peak = stats.get("allocated_bytes.all.peak")
    if in_use is None and peak is None:
        return None
    if registry is None:
        from eksml_tpu_torch.telemetry.registry import default_registry

        registry = default_registry()
    out: Dict[str, int] = {}
    if in_use is not None:
        registry.gauge(HBM_IN_USE_GAUGE,
                       "live HBM bytes in use on local device 0"
                       ).set(float(in_use))
        out["bytes_in_use"] = int(in_use)
    if peak is not None:
        registry.gauge(HBM_PEAK_GAUGE,
                       "peak HBM bytes in use on local device 0"
                       ).set(float(peak))
        out["peak_bytes"] = int(peak)
    return out
