"""Device memory of the port's step: the live gauges and the liveness
peak of a counted step (``eksml_tpu/profiling/memory.py``).

- :func:`publish_hbm_gauges` (the reference's gauge names), fed by
  ``torch.cuda.memory_stats()``: the caching allocator's bytes allocated
  now and at its peak on the trainer's device.
- :func:`analyze_memory`, the counterpart of the reference's HLO
  liveness walk, over the same pass that counts the roofline
  (``profiling/predict.py`` ``StepCounter``): each storage an operation
  of the step creates is live from that operation until its release;
  the storages that exist before the step (parameters, optimizer state,
  the batch, caches) are live throughout.  The peak is the most bytes
  live right after an operation's outputs are made, and the live set at
  that operation is attributed by component (the component of the
  operation that made each storage; ``params``, ``optimizer``,
  ``batch`` and ``resident`` for the rest).  Outside the count: what an
  operation allocates and frees inside itself (cuDNN's workspaces), and
  the caching allocator's rounding, both of which
  ``torch.cuda.max_memory_allocated`` includes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

HBM_IN_USE_GAUGE = "eksml_train_hbm_bytes_in_use"
HBM_PEAK_GAUGE = "eksml_train_hbm_peak_bytes"

_TIMELINE_POINTS = 64
_TOP_TENSORS = 10


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


def analyze_memory(counts) -> Dict[str, Any]:
    """A counted step (``predict.StepCounts``) → the ``hbm`` record, with
    the reference's keys (capacity is joined by the predictor from the
    spec): ``peak_hbm_bytes``, ``peak_instruction`` (``<op>#<index>``),
    ``peak_opcode``, ``peak_index``, ``donated_bytes`` (0: nothing is
    donated), ``parameter_bytes``, ``live_at_peak_by_component``,
    ``timeline`` (at most 64 points, the peak included) and
    ``n_instructions``; and the port's ``resident_bytes`` (by label),
    ``peak_component`` and ``top_tensors`` (the largest storages live at
    the peak: bytes, shape, dtype, the operation and component that made
    each)."""
    resident = dict(counts.resident)
    base = sum(resident.values())
    timeline = counts.timeline
    if not timeline:
        return {"peak_hbm_bytes": int(base), "live_at_peak_by_component":
                {k: int(v) for k, v in resident.items()},
                "timeline": [], "n_instructions": 0,
                "resident_bytes": resident, "top_tensors": [],
                "parameter_bytes": int(resident.get("params", 0)),
                "donated_bytes": 0}
    peak_idx = max(range(len(timeline)), key=timeline.__getitem__)
    live = [a for a in counts.allocations
            if a.op_index <= peak_idx
            and (a.freed_at is None or a.freed_at > peak_idx)]
    by_comp: Dict[str, float] = dict(resident)
    for a in live:
        by_comp[a.component] = by_comp.get(a.component, 0) + a.nbytes
    peak_op = counts.ops[peak_idx]
    top = sorted(live, key=lambda a: -a.nbytes)[:_TOP_TENSORS]
    return {
        "peak_hbm_bytes": int(base + timeline[peak_idx]),
        "peak_instruction": f"{peak_op.name}#{peak_idx}",
        "peak_opcode": peak_op.name,
        "peak_index": peak_idx,
        "peak_component": peak_op.component,
        "donated_bytes": 0,
        "parameter_bytes": int(resident.get("params", 0)),
        "resident_bytes": {k: int(v) for k, v in resident.items()},
        "live_at_peak_by_component": {
            k: int(v) for k, v in
            sorted(by_comp.items(), key=lambda kv: -kv[1])},
        "top_tensors": [
            {"bytes": a.nbytes, "shape": list(a.shape), "dtype": a.dtype,
             "op": a.op, "op_index": a.op_index, "component": a.component}
            for a in top],
        "timeline": _downsample_timeline([base + v for v in timeline],
                                         peak_idx),
        "n_instructions": len(timeline),
    }


def _downsample_timeline(vals: List[float], peak_idx: int,
                         n: int = _TIMELINE_POINTS
                         ) -> List[Dict[str, int]]:
    """≤n evenly-spaced (index, live_bytes) samples, peak always
    included."""
    if not vals:
        return []
    total = len(vals)
    step = max(1, -(-total // (n - 2)))
    picked = sorted(set(range(0, total, step)) | {peak_idx, total - 1})
    return [{"index": i, "live_bytes": int(vals[i])} for i in picked]


def top_components(hbm: Dict[str, Any], n: int = 3) -> str:
    """'backbone 12.3MB, params 8.1MB, roi-bwd 4.0MB' — the naming half
    of every memory verdict message."""
    comps = (hbm or {}).get("live_at_peak_by_component") or {}
    parts = [f"{k} {v / 1e6:.1f}MB" for k, v in list(comps.items())[:n]]
    return ", ".join(parts) if parts else "no attribution"
