"""Collectives outside the gradient path, and the replica sync check (the
port of ``eksml_tpu/parallel/collectives.py``: ``cross_host_sum``,
``param_fingerprint``, ``assert_replicas_in_sync``,
``warm_mesh_collectives``; and of ``recommend_combine_threshold`` from
``eksml_tpu/parallel/native.py``, its Python rule).

Every function here is a collective under a process group: all ranks
call it at the same point, or the run hangs.  Without a group each is
the identity (or a no-op).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

from eksml_tpu_torch.parallel.distributed import collective_device

log = logging.getLogger(__name__)

#: Weyl increment of the fingerprint's position weights (irrational:
#: no period), as float32 like the reference's
_PHI = 0.6180339887498949


def cross_host_sum(values: Mapping[str, float]) -> Dict[str, torch.Tensor]:
    """Sum scalar values across all ranks (loss sums, flags), as float64
    0-d CPU tensors; identity without a group."""
    keys = list(values)
    vec = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    if dist.is_initialized():
        vec = vec.to(collective_device())
        dist.all_reduce(vec)
        # callers sum at a sync period (the SIGTERM agreement), not per step
        vec = vec.cpu()  # eksml-lint: disable=host-sync
    return {k: vec[i] for i, k in enumerate(keys)}


def param_fingerprint(state_dict: Mapping[str, torch.Tensor],
                      generator_state: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Order- and position-sensitive fingerprint of the model's state
    (the reference's three mixing terms per leaf), over the tensors in
    the Flax leaf order and layouts (``convert.flax_leaves``), so that
    component 0 equals the reference's on converted weights.

    Per leaf ``i``: the Weyl-weighted mean (weights ``frac(k·φ) + 0.5``
    over the flattened leaf, computed in float32 as the reference does)
    plus 0.7 times the second moment, times ``(i mod 97) + 1``; the
    products and the sum are taken in float64.  With
    ``generator_state`` (a ``torch.Generator.get_state()``), each of its
    32-bit words follows as its high and low 16 bits, exact in any float
    type — the sampling stream's state in place of the reference's PRNG
    key.  Returns a float64 vector on the tensors' device."""
    from eksml_tpu_torch.convert import flax_leaves

    acc = None
    for i, (_, leaf) in enumerate(flax_leaves(state_dict)):
        flat = leaf.detach().float().reshape(-1)
        n = flat.numel()
        w = torch.remainder(
            torch.arange(n, dtype=torch.float32, device=flat.device)
            * torch.tensor(_PHI, dtype=torch.float32, device=flat.device),
            1.0) + 0.5
        f64 = flat.double()
        mix = (torch.dot(w.double(), f64) + 0.7 * torch.dot(f64, f64)) / n
        term = ((i % 97) + 1) * mix
        acc = term if acc is None else acc + term
    parts = [acc.reshape(1)]
    if generator_state is not None:
        raw = generator_state.detach().cpu().to(torch.uint8).reshape(-1)
        raw = torch.cat([raw, raw.new_zeros((-raw.numel()) % 4)])
        words = raw.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        parts += [(words >> 16).double().to(acc.device),
                  (words & 0xFFFF).double().to(acc.device)]
    return torch.cat(parts)


def assert_replicas_in_sync(state_dict: Mapping[str, torch.Tensor],
                            generator_state: Optional[torch.Tensor] = None,
                            atol: float = 1e-5) -> bool:
    """Check that every rank holds the same model state (and, when
    given, the same sampling-generator state): all-gather each rank's
    fingerprint and compare the spread — the silent divergence the
    reference's Horovod stack could not see.  Returns True; raises
    ``AssertionError`` naming what diverged.  A sharded tensor (a
    DTensor) is fingerprinted whole, gathered on every rank in one order,
    so two ranks holding different shards of it never read as diverged
    (the trainer still runs the check under ``replicated`` only, as the
    reference)."""
    state_dict = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                  for k, v in state_dict.items()}
    fp = param_fingerprint(state_dict, generator_state)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return True
    mine = fp.to(collective_device())
    gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    allv = torch.stack(gathered).cpu()
    high, low = allv.max(0).values, allv.min(0).values
    spread = (high - low).abs()
    if spread[0] > atol or (spread.numel() > 1 and bool((spread[1:] > 0).any())):
        what = ("params" if spread[0] > atol
                else "sampling generator stream")
        raise AssertionError(
            f"data-parallel replicas diverged ({what}): fingerprint "
            f"spread {float(spread.max())} (rank {dist.get_rank()}: "
            f"{float(fp[0])}; low {float(low[0])}, high {float(high[0])})")
    return True


def warm_mesh_collectives(mesh=None) -> None:
    """One trivial all-reduce on the default group and on each axis
    group of ``mesh``, at init while every rank is aligned from the
    rendezvous: NCCL builds a communicator lazily at its first
    collective, and step 1 should not pay (or time out on) that behind
    per-rank autotune skew.  One retry absorbs a transient first-connect
    failure; a second raises.  No-op without a group."""
    if not dist.is_initialized():
        return
    groups = [None]
    if mesh is not None:
        groups += [mesh.get_group(a) for a in mesh.mesh_dim_names]
    dev = collective_device()
    for group in groups:
        n = dist.get_world_size(group)
        for attempt in (1, 2):
            try:
                x = torch.ones(1, device=dev)
                dist.all_reduce(x, group=group)
                if float(x) != float(n):  # explicit: survives python -O
                    raise AssertionError(
                        f"warm-up all-reduce returned {float(x)}, expected "
                        f"{n} — the collective context is broken")
                break
            except Exception as e:  # noqa: BLE001 — one retry, then raise
                if attempt == 2:
                    raise
                log.warning("warm-up all-reduce failed (%s: %s); retrying "
                            "once in 2s", type(e).__name__, e)
                time.sleep(2.0)


def recommend_combine_threshold(param_bytes: int, chips: int) -> int:
    """HOROVOD_FUSION_THRESHOLD analogue, sized from model scale (the
    reference's Python rule): an eighth of the parameter bytes within
    [4 MiB, 64 MiB], halved past 256 chips."""
    t = max(4 << 20, min(param_bytes // 8, 64 << 20))
    return t // 2 if chips > 256 else t
