"""Topology descriptors: what a checkpoint was saved ON (the port of
``eksml_tpu/parallel/topology.py``).

The checkpoint manager persists a descriptor next to each step's
integrity manifest (``resilience/integrity.py``) and compares it with
the current launch's at restore time: a step saved on another topology
(another world size, strategy or card) restores after the difference is
logged — checkpoints hold whole tensors, so any layout reads any step —
unless ``RESILIENCE.ELASTIC_RESUME`` is off.

A descriptor is a plain JSON-serializable dict (one key per
:data:`FIELDS` entry); :func:`describe` and :func:`diff` render the
one-liners the restore log and the flight recorder carry.  The port
adds ``device_kind`` (the card's name) to the reference's fields; its
``process_count`` counts ranks (one per GPU), the reference's hosts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

#: Manifest payload schema version (bump on incompatible field
#: changes; readers treat unknown versions as "no manifest").
SCHEMA_VERSION = 1

#: Descriptor fields, in render order.  ANY differing field makes two
#: topologies incompatible: the restore logs the difference (and, with
#: ``RESILIENCE.ELASTIC_RESUME`` off, refuses the step).
FIELDS = ("mesh_shape", "mesh_axes", "num_slices", "strategy",
          "fsdp_axis_size", "model_axis_size", "num_devices",
          "process_count", "device_kind")


def current_topology(device="cpu", plan=None, mesh=None,
                     num_slices: int = 1) -> Dict[str, Any]:
    """Descriptor of the topology THIS process trains on ``device``,
    from the live plan (``parallel/sharding.ShardingPlan``; ``None``:
    one process, one device, replicated): ``mesh`` is the plan's
    ``DeviceMesh``, or ``None`` without a process group (then the
    plan's own 1-device shape).  The fsdp and model widths are the
    plan's resolved ones, not the raw knobs (0 means "every device of a
    slice")."""
    import torch

    from eksml_tpu_torch.parallel.distributed import process_count

    if mesh is not None:
        shape = [int(s) for s in mesh.mesh.shape]
        axes = [str(a) for a in mesh.mesh_dim_names]
    elif plan is not None:
        shape = [int(s) for s in plan.mesh_shape]
        axes = [str(a) for a in plan.mesh_axes]
    else:
        shape, axes = [1, 1], ["data", "model"]
    n = 1
    for s in shape:
        n *= s
    device = torch.device(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return {
        "mesh_shape": shape,
        "mesh_axes": axes,
        "num_slices": int(num_slices),
        "strategy": str(plan.strategy) if plan is not None else "replicated",
        "fsdp_axis_size": int(plan.axis_size) if plan is not None else 1,
        "model_axis_size": (int(plan.model_axis_size) if plan is not None
                            else 1),
        "num_devices": n,
        "process_count": process_count(),
        "device_kind": kind,
    }


def normalize(topo: Any) -> Optional[Dict[str, Any]]:
    """Tolerant load of a (possibly hand-edited / cross-version)
    descriptor: every known field, sequences as lists, or ``None``
    when the payload is not a dict at all."""
    if not isinstance(topo, dict):
        return None
    out: Dict[str, Any] = {}
    for f in FIELDS:
        v = topo.get(f)
        out[f] = list(v) if isinstance(v, (list, tuple)) else v
    return out


def compatible(saved: Any, current: Any) -> bool:
    """True when a checkpoint saved at ``saved`` can be restored at
    ``current`` trusting the byte layout as-is (every descriptor field
    equal).  Absence is never a mismatch — a whole missing descriptor
    (no manifest) AND a per-field ``None`` (a manifest written before
    a field joined :data:`FIELDS`) both mean "no evidence", so only
    fields recorded on BOTH sides are compared; otherwise adding a
    field would make every pre-upgrade checkpoint read as saved on a
    different topology."""
    a, b = normalize(saved), normalize(current)
    if a is None or b is None:
        return True
    return all(a[f] == b[f] for f in FIELDS
               if a[f] is not None and b[f] is not None)


def describe(topo: Any) -> str:
    """One-line descriptor for logs/events: ``mesh [1, 1] over
    ['data', 'model'], replicated, 1 slice(s), 1 device(s) (NVIDIA H100
    80GB HBM3), 1 proc(s)``."""
    t = normalize(topo)
    if t is None:
        return "(unknown topology)"
    return (f"mesh {t['mesh_shape']} over {t['mesh_axes']}, {t['strategy']}, "
            f"{t['num_slices']} slice(s), {t['num_devices']} "
            f"device(s) ({t['device_kind']}), {t['process_count']} "
            "proc(s)")


def diff(saved: Any, current: Any) -> str:
    """One-line saved→current diff naming ONLY the changed fields —
    the operator-facing payload of the ``checkpoint_topology_changed``
    event and the restore log line."""
    a, b = normalize(saved), normalize(current)
    if a is None or b is None:
        return f"{describe(saved)} -> {describe(current)}"
    # per-field absence is "no evidence", matching compatible()
    parts = [f"{f}: {a[f]} -> {b[f]}" for f in FIELDS
             if a[f] is not None and b[f] is not None and a[f] != b[f]]
    return "; ".join(parts) if parts else "(identical topologies)"
