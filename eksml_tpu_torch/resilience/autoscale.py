"""Elastic autoscaling decision policy: capacity + goodput -> topology
(the port of ``eksml_tpu/resilience/autoscale.py``).

Elastic resume makes a topology change survivable (a relaunch at a
different GPU count reshards the restore, ``parallel/distributed.py``)
and the goodput ledger makes waste visible (``eksml_goodput_ratio`` and
the badput buckets, ``telemetry/goodput.py``).  This module is the
decision half that closes the loop: given what the fleet can offer
(available GPUs and a preemption forecast) and what the run achieves
(goodput ratio, badput buckets, preemption and straggler counters), pick
the topology the job should run at, deterministically, so the actuator
(``eksml_tpu_torch/tools/eksml_operator.py``) is a plain loop and every
decision replays from its banked inputs.

Design rules, held by ``tests/test_torch_operator.py`` against the
reference:

- **Pure and deterministic.**  :func:`decide` is a function of its
  arguments only; the caller passes ``now``.  No clock, RNG, filesystem
  or global state inside.
- **Only launchable topologies.**  Candidates come from
  :func:`topology_ladder`, which mirrors ``plan_mesh``'s divisibility
  contract (``parallel/sharding.py``) for every strategy the trainer
  launches (``STRATEGIES``: ``replicated``, ``fsdp``, ``tensor``,
  ``2d``), rung for rung as the reference.
- **Hysteresis + cooldown.**  Growth needs ``GROW_PATIENCE``
  consecutive grow-capable observations and ``COOLDOWN_SEC`` since the
  last transition; a shrink needs ``SHRINK_PATIENCE`` observations and
  ignores the cooldown: when the GPUs are being reclaimed, holding the
  larger shape means dying by SIGKILL instead of checkpointing.
- **Forecast-aware.**  A preemption forecast >= ``FORECAST_HOLD``
  vetoes growth.

:func:`serve_replicas` is the serving fleet's analogue: the queue-depth
HPA's desired-replicas math, for clusters without a prometheus-adapter.

Stdlib only (and the port's stdlib-only config): the operator imports
this module without torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Mapping, Optional, Sequence, Tuple

from eksml_tpu_torch.config import STRATEGIES

# actions a decision can carry (also the flight-event / metric label
# vocabulary — keep charts and dashboards in sync when extending)
ACTIONS = ("hold", "grow", "shrink")


@dataclass(frozen=True)
class Topology:
    """One launchable shape: a named rung of the ladder.

    ``fsdp_axis``/``model_axis`` are the axis sizes ``plan_mesh``
    would derive for this chip count — recorded explicitly so the
    relaunch config can pin them (``TRAIN.SHARDING.FSDP_AXIS_SIZE=…``)
    instead of trusting a second derivation to agree."""

    name: str
    chips: int
    strategy: str = "fsdp"
    fsdp_axis: int = 1
    model_axis: int = 1
    num_slices: int = 1

    def config_overrides(self, global_batch: int = 0) -> Tuple[str, ...]:
        """``--config`` items that relaunch the trainer at this shape.

        ``global_batch > 0`` holds the GLOBAL batch across topologies
        (chips × per-chip batch constant), so the LR schedule and the
        loss stream stay comparable — the elastic-resume contract."""
        items = [f"TRAIN.NUM_CHIPS={self.chips}",
                 f"TRAIN.SHARDING.STRATEGY={self.strategy}"]
        if self.strategy in ("fsdp", "2d"):
            items.append(
                f"TRAIN.SHARDING.FSDP_AXIS_SIZE={self.fsdp_axis}")
        if self.strategy in ("tensor", "2d"):
            items.append(
                f"TRAIN.SHARDING.MODEL_AXIS_SIZE={self.model_axis}")
        if global_batch > 0:
            if global_batch % self.chips:
                raise ValueError(
                    f"global batch {global_batch} does not divide "
                    f"over {self.chips} chip(s)")
            items.append("TRAIN.BATCH_SIZE_PER_CHIP="
                         f"{global_batch // self.chips}")
        return tuple(items)


def topology_ladder(chip_options: Sequence[int],
                    strategy: str = "fsdp",
                    model_axis: int = 1,
                    num_slices: int = 1) -> Tuple[Topology, ...]:
    """Valid topologies for the given chip counts, smallest first.

    Mirrors ``plan_mesh``'s validation (``parallel/sharding.py``): a chip
    count that does not split into ``num_slices``, or whose per-slice
    count the model axis (or the fsdp × model product) does not divide,
    yields NO rung, never an invalid one.  The fsdp axis is sized like
    the ``FSDP_AXIS_SIZE=0`` knob: the rest of the slice after the model
    axis.  ``tests/test_torch_operator.py`` pins every emitted rung
    against the port's ``plan_mesh`` and the reference's ladder."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r} is not one of "
                         f"{STRATEGIES}")
    num_slices = max(1, int(num_slices))
    rungs = []
    for chips in sorted({int(c) for c in chip_options}):
        if chips < 1 or chips % num_slices:
            continue
        per_slice = chips // num_slices
        if strategy == "replicated":
            rungs.append(Topology(f"replicated{chips}", chips,
                                  "replicated", 1, 1, num_slices))
            continue
        if strategy == "tensor":
            m = int(model_axis) or per_slice
            if m < 1 or per_slice % m:
                continue
            rungs.append(Topology(f"tensor{m}x{chips}", chips,
                                  "tensor", 1, m, num_slices))
            continue
        m = 1
        if strategy == "2d":
            m = int(model_axis)
            if m < 1 or per_slice % m:
                continue
        f = per_slice // m
        if f < 1 or per_slice % (f * m):
            continue
        name = (f"2d{f}x{m}-{chips}" if strategy == "2d"
                else f"fsdp{f}-{chips}" if f != chips
                else f"fsdp{f}")
        rungs.append(Topology(name, chips, strategy, f, m, num_slices))
    return tuple(rungs)


@dataclass(frozen=True)
class CapacitySignal:
    """What the fleet can offer right now (capacity provider view)."""

    available_chips: int
    # probability-like score in [0, 1] that current capacity shrinks
    # within the next decision horizon (spot/preemptible markets
    # publish these; the file provider passes them through; 0 = calm)
    preemption_forecast: float = 0.0


@dataclass(frozen=True)
class HealthSignal:
    """What the run is achieving (scraped from its /metrics).

    ``goodput_ratio`` is ``None`` when the scrape failed (trainer
    mid-relaunch) — unknown health never vetoes a capacity-mandated
    shrink, and vetoes growth only through explicit params."""

    goodput_ratio: Optional[float] = None
    badput_s: Mapping[str, float] = field(default_factory=dict)
    preemptions: float = 0.0
    stragglers: float = 0.0


@dataclass(frozen=True)
class PolicyParams:
    """Decision knobs — defaults mirror RESILIENCE.AUTOSCALE.*."""

    cooldown_sec: float = 300.0
    grow_patience: int = 2
    shrink_patience: int = 1
    forecast_hold: float = 0.5
    # 0 disables the health veto: a tiny chaos run's ratio is compile-
    # dominated and must still be allowed to grow
    min_goodput_for_grow: float = 0.0


@dataclass(frozen=True)
class PolicyState:
    """Everything :func:`decide` carries between calls — state in,
    state out, so the policy itself stays a pure function."""

    topology: Topology
    last_change_t: float = 0.0
    grow_streak: int = 0
    shrink_streak: int = 0


@dataclass(frozen=True)
class ScaleDecision:
    action: str                  # one of ACTIONS
    target: Topology             # == current topology for "hold"
    reason: str
    cooldown_remaining_s: float = 0.0

    def to_dict(self) -> Dict:
        return {"action": self.action,
                "target": self.target.name,
                "target_chips": self.target.chips,
                "target_strategy": self.target.strategy,
                "target_fsdp_axis": self.target.fsdp_axis,
                "target_model_axis": self.target.model_axis,
                "reason": self.reason,
                "cooldown_remaining_s":
                    round(self.cooldown_remaining_s, 3)}


def _best_fit(ladder: Sequence[Topology],
              available_chips: int) -> Optional[Topology]:
    """Largest rung that fits the available chips (None if none)."""
    best = None
    for topo in ladder:
        if topo.chips <= available_chips and (
                best is None or topo.chips > best.chips):
            best = topo
    return best


def decide(state: PolicyState,
           capacity: CapacitySignal,
           health: HealthSignal,
           ladder: Sequence[Topology],
           params: PolicyParams,
           now: float) -> Tuple[ScaleDecision, PolicyState]:
    """One observation → ``(decision, next_state)``.

    Pure and deterministic: ``now`` is the caller's clock (the
    actuator samples it once per tick), and every veto names itself
    in ``reason`` so the banked decision stream reads as a log of
    WHY, not just WHAT."""
    cur = state.topology
    cooldown_left = max(
        0.0, params.cooldown_sec - (now - state.last_change_t))

    best = _best_fit(ladder, capacity.available_chips)
    if best is None:
        # nothing launchable fits — keep the current shape and let the
        # fleet's own preemption take its course (the operator still
        # records the starvation for the post-mortem)
        dec = ScaleDecision(
            "hold", cur,
            f"no ladder rung fits {capacity.available_chips} "
            "available chip(s)", cooldown_left)
        return dec, replace(state, grow_streak=0, shrink_streak=0)

    if best.chips < cur.chips:
        streak = state.shrink_streak + 1
        if streak < params.shrink_patience:
            dec = ScaleDecision(
                "hold", cur,
                f"shrink to {best.name} pending hysteresis "
                f"({streak}/{params.shrink_patience})", cooldown_left)
            return dec, replace(state, grow_streak=0,
                                shrink_streak=streak)
        # capacity loss overrides the cooldown: holding an oversized
        # shape means dying by SIGKILL instead of checkpointing
        dec = ScaleDecision(
            "shrink", best,
            f"capacity {capacity.available_chips} < current "
            f"{cur.chips} chips", 0.0)
        return dec, PolicyState(best, last_change_t=now)

    if best.chips > cur.chips:
        streak = state.grow_streak + 1
        nxt = replace(state, grow_streak=streak, shrink_streak=0)
        if capacity.preemption_forecast >= params.forecast_hold:
            dec = ScaleDecision(
                "hold", cur,
                f"growth vetoed: preemption forecast "
                f"{capacity.preemption_forecast:g} >= "
                f"{params.forecast_hold:g}", cooldown_left)
            return dec, replace(nxt, grow_streak=0)
        if (params.min_goodput_for_grow > 0.0
                and health.goodput_ratio is not None
                and health.goodput_ratio <
                params.min_goodput_for_grow):
            dec = ScaleDecision(
                "hold", cur,
                f"growth vetoed: goodput {health.goodput_ratio:g} < "
                f"{params.min_goodput_for_grow:g} (a relaunch only "
                "adds badput)", cooldown_left)
            return dec, nxt
        if streak < params.grow_patience:
            dec = ScaleDecision(
                "hold", cur,
                f"grow to {best.name} pending hysteresis "
                f"({streak}/{params.grow_patience})", cooldown_left)
            return dec, nxt
        if cooldown_left > 0.0:
            dec = ScaleDecision(
                "hold", cur,
                f"grow to {best.name} pending cooldown "
                f"({cooldown_left:.1f}s left)", cooldown_left)
            return dec, nxt
        dec = ScaleDecision(
            "grow", best,
            f"capacity {capacity.available_chips} fits {best.name} "
            f"(> current {cur.chips} chips)", 0.0)
        return dec, PolicyState(best, last_change_t=now)

    dec = ScaleDecision(
        "hold", cur, "capacity matches current topology",
        cooldown_left)
    return dec, replace(state, grow_streak=0, shrink_streak=0)


def serve_replicas(queue_depth: float, current_replicas: int,
                   target_queue_depth: float,
                   min_replicas: int, max_replicas: int) -> int:
    """Desired serve replicas — the HPA's averageValue math, pure.

    ``queue_depth`` is the fleet's mean ``eksml_serve_queue_depth``;
    desired = ceil(current × depth / target), clamped.  The operator
    runs this as the ACTIVE half of the serving HPA when no
    prometheus-adapter exposes the Pods metric."""
    current_replicas = max(1, int(current_replicas))
    lo = max(1, int(min_replicas))
    hi = max(lo, int(max_replicas))
    if target_queue_depth <= 0:
        return min(max(current_replicas, lo), hi)
    desired = math.ceil(
        current_replicas * float(queue_depth) / float(target_queue_depth))
    return min(max(desired, lo), hi)
