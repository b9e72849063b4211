"""Cross-rank metric aggregation and straggler attribution (the port of
``eksml_tpu/telemetry/aggregate.py``).

Rank 0 writes the metrics, so without this a run of N ranks reports one
rank's step time and prefetch wait; the straggler that sets the
synchronous step rate stays invisible unless it is rank 0.  At every log
step each rank contributes one fixed-order vector of local scalars
(:data:`HOST_AGG_KEYS`); an ``all_gather`` gives the N×K matrix, and
rank 0's row gains ``hosts/<key>_min|_max|_mean``, ``hosts/count`` and
``hosts/lagging`` (the rank with the largest step time).  It is a
collective: every rank calls it at the same log steps.  Without a group
the matrix is the local vector (min = max = mean), so the row has the
same keys at any world size.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# One fixed, ordered contract for the gathered vector (the reference's).
HOST_AGG_KEYS: Tuple[str, ...] = (
    "step_time_ms",       # wall time per step over the log interval
    "prefetch_wait_ms",   # step-loop blocking on the device prefetcher
    "batch_build_ms",     # producer-side batch assembly time
    "quarantined",        # distinct bad records on this host
    "io_recoveries",      # transient I/O blips absorbed by retry
    "pool_rebuilds",      # decode process-pool self-heals
    "starvation_waits",   # consumer waits on an empty batch queue
)


def host_vector(values: Dict[str, float]) -> np.ndarray:
    """``values`` → the fixed-order float64 vector (missing keys 0)."""
    return np.asarray([float(values.get(k, 0.0) or 0.0)
                       for k in HOST_AGG_KEYS], np.float64)


def stats_from_matrix(matrix: np.ndarray,
                      lag_key: str = "step_time_ms") -> Dict[str, float]:
    """N×K gathered matrix → the flat aggregate row."""
    matrix = np.asarray(matrix, np.float64).reshape(
        -1, len(HOST_AGG_KEYS))
    out: Dict[str, float] = {"hosts/count": float(matrix.shape[0])}
    for j, k in enumerate(HOST_AGG_KEYS):
        col = matrix[:, j]
        out[f"hosts/{k}_min"] = float(col.min())
        out[f"hosts/{k}_max"] = float(col.max())
        out[f"hosts/{k}_mean"] = float(col.mean())
    lag_col = matrix[:, HOST_AGG_KEYS.index(lag_key)]
    out["hosts/lagging"] = float(int(np.argmax(lag_col)))
    return out


def aggregate_host_scalars(values: Dict[str, float]) -> Dict[str, float]:
    """Gather this rank's :data:`HOST_AGG_KEYS` values across all ranks
    and return the min/max/mean and straggler row (a collective)."""
    import torch
    import torch.distributed as dist

    vec = host_vector(values)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return stats_from_matrix(vec[None, :])
    from eksml_tpu_torch.parallel.distributed import collective_device

    mine = torch.from_numpy(vec).to(collective_device())
    gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    return stats_from_matrix(torch.stack(gathered).cpu().numpy())


def publish_aggregates(agg: Dict[str, float], registry=None) -> None:
    """Mirror the aggregate row into registry gauges
    (``eksml_hosts_<key>_<stat>``) so ``/metrics`` serves the same view
    as the row."""
    from eksml_tpu_torch.telemetry.registry import default_registry

    registry = registry or default_registry()
    for k, v in agg.items():
        name = "eksml_" + k.replace("/", "_")
        registry.gauge(
            name, "cross-rank aggregate (telemetry/aggregate.py)").set(v)
