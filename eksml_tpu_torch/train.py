"""Training of the port's Mask-RCNN: the optimizer, the one step builder,
the trainer's lifecycle and its entry point (``eksml_tpu/train.py``:
``lr_schedule``, ``_decay_mask``, ``make_optimizer``,
``Trainer._train_step``, ``Trainer.fit`` and ``main``).

The optimizer is the reference's optax chain, step for step:
``clip_by_global_norm`` (only when ``TRAIN.GRADIENT_CLIP`` > 0), weight
decay on trainable kernels only, SGD with momentum, and the warmup plus
piecewise-constant learning rate rescaled by the global batch.  Optax's
momentum trace (``t = g + m·t``, update ``-lr·t``) equals
``torch.optim.SGD``'s buffer with no dampening, and its decayed weights
(``g + wd·p``) equal SGD's ``weight_decay``, so one SGD with two
parameter groups is the chain; the learning rate is set from the
schedule before each update.

``TRAIN.PARAM_DTYPE=bfloat16`` stores the parameters and the FrozenBN
statistics in bfloat16 (:func:`cast_for_storage`, the reference's
``cast_params_for_storage``), before the optimizer is built, so the
momentum buffers are bfloat16 too.  The gradients then arrive in
bfloat16 and, as in optax, the global norm, the clip, the weight decay,
the momentum and the update are computed in bfloat16, with the learning
rate rounded to bfloat16 first (``scale_by_schedule``).
``TRAIN.PRECISION`` and ``TRAIN.REMAT`` are the model's
(``models/mask_rcnn.py``).

``Trainer`` checkpoints, auto-resumes, rolls back a divergence, exits
resumable on SIGTERM and evaluates COCO AP every ``TRAIN.EVAL_PERIOD``
epochs; ``python -m eksml_tpu_torch.train`` runs it on a staged COCO
directory or, with ``--synthetic``, on generated data (see
:func:`main`).  The knobs it does not read yet are listed in its
docstring.

Across GPUs (one process each, ``parallel/distributed.py``) the model
trains under the sharding plan's wrapper (``parallel/sharding.py``:
DDP or FSDP2).  Every rank takes its slice of the global batch; the
losses are per-image means over the batch, so with equal slices the
wrappers' gradient average is the global batch's gradient, and the
logged losses and ``grad_norm`` are averaged across ranks before
anything reads them.

Observability (``config.TELEMETRY``, as ``eksml_tpu/train.py``): the
fit loop serves ``/metrics``, ``/healthz`` (503 past
``HEALTHZ_STALE_SEC`` without a step), ``/debugz/profile`` and
``/debugz/stacks`` from local rank 0 of each host, times its phases as
spans (``TRACING``), banks the goodput ledger (``GOODPUT``) and takes
``torch.profiler`` captures on request (``--profile N``,
``/debugz/profile``, the anomaly detector), each written with its
attribution by model component under ``<logdir>/profile``.  With
``PREDICTED_STEP_TIME`` the first step runs under the step counter of
``profiling/predict.py`` and its roofline on the card is published as
``eksml_train_predicted_step_time_ms``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import math
import os
import sys
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from eksml_tpu_torch import telemetry
from eksml_tpu_torch.data.loader import DevicePrefetcher, batch_tensors
from eksml_tpu_torch.device import resolve_device
from eksml_tpu_torch.models import MaskRCNN
from eksml_tpu_torch.parallel.collectives import (assert_replicas_in_sync,
                                                  warm_mesh_collectives)
from eksml_tpu_torch.parallel.distributed import (barrier, broadcast_object,
                                                  is_coordinator,
                                                  local_rank,
                                                  process_count,
                                                  process_index)
from eksml_tpu_torch.parallel.sharding import (ShardingPlan,
                                               publish_state_byte_gauges)
from eksml_tpu_torch.parallel.topology import current_topology
from eksml_tpu_torch.profiling.memory import publish_hbm_gauges
from eksml_tpu_torch.profiling.scopes import named_scope
from eksml_tpu_torch.resilience import (ROLLBACK, DivergenceSentinel,
                                        HangWatchdog, PreemptedError,
                                        PreemptionHandler)
from eksml_tpu_torch.utils import CheckpointManager, MetricWriter
from eksml_tpu_torch.utils.checkpoint import (full_optimizer_state,
                                              full_state_dict,
                                              load_full_state)
from eksml_tpu_torch.utils.compile_cache import choose_cudnn_algorithms

log = logging.getLogger("eksml_tpu_torch.train")

#: one-element kernels a capture on the card launches right after the
#: profiler starts: late in a long process a torch.profiler session
#: loses a varying count of its first device records (16 to 69 seen,
#: PERF.md §6), which cost the captured steps their first kernels
CAPTURE_PRIMERS = 256


def lr_schedule(cfg) -> Callable[[int], float]:
    """Warmup + piecewise-constant decay: ``TRAIN.BASE_LR`` (per 8-image
    global batch) scaled to the global batch, ×0.1 at each
    ``TRAIN.LR_SCHEDULE`` boundary (steps at global batch 8, rescaled to
    this batch; boundaries that land on one step multiply), after a
    linear warmup from ``WARMUP_INIT_FACTOR``·base over
    ``WARMUP_STEPS``."""
    global_batch = cfg.TRAIN.NUM_CHIPS * cfg.TRAIN.BATCH_SIZE_PER_CHIP
    base = cfg.TRAIN.BASE_LR * global_batch / 8.0
    boundaries: Dict[int, float] = {}
    for s in cfg.TRAIN.LR_SCHEDULE:
        b = max(1, int(s * 8 / global_batch))
        boundaries[b] = boundaries.get(b, 1.0) * 0.1
    warm = cfg.TRAIN.WARMUP_STEPS
    init = base * cfg.TRAIN.WARMUP_INIT_FACTOR

    def main(step: int) -> float:
        v = base
        for threshold, scale in sorted(boundaries.items()):
            if step >= threshold:
                v *= scale
        return v

    def sched(step: int) -> float:
        if warm > 0 and step < warm:
            return init + (base - init) * min(step, warm) / warm
        return main(step)

    return sched


def decay_mask(model: torch.nn.Module, freeze_at: int) -> Dict[str, bool]:
    """Per parameter name: whether weight decay applies.  Kernels only
    (conv, deconv and linear weights), not biases, and not the frozen
    stem and stages (``BACKBONE.FREEZE_AT``), as ``train.py:100-122``."""
    mask = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        decay = parts[-1] == "weight"
        if decay and parts[0] == "backbone":
            if parts[1] == "conv0" and freeze_at >= 1:
                decay = False
            elif parts[1].startswith("group") \
                    and int(parts[1][len("group")]) + 2 <= freeze_at:
                decay = False
        mask[name] = decay
    return mask


def make_optimizer(model: torch.nn.Module, cfg):
    """``(optimizer, sched)``: SGD with momentum over the trainable
    parameters in two groups, with and without weight decay."""
    mask = decay_mask(model, cfg.BACKBONE.FREEZE_AT)
    decayed, plain = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (decayed if mask[name] else plain).append(p)
    sched = lr_schedule(cfg)
    groups = [{"params": decayed, "weight_decay": cfg.TRAIN.WEIGHT_DECAY},
              {"params": plain, "weight_decay": 0.0}]
    opt = torch.optim.SGD(groups, lr=sched(0), momentum=cfg.TRAIN.MOMENTUM)
    return opt, sched


def cast_for_storage(model: torch.nn.Module, param_dtype: str) -> None:
    """``TRAIN.PARAM_DTYPE`` storage: with ``bfloat16`` every float32
    parameter and persistent buffer of ``model`` (the reference's Flax
    params: kernels, biases, norm parameters, FrozenBN statistics)
    becomes bfloat16, in place; ``float32`` changes nothing.  Call it
    before the optimizer is built and before any wrapper."""
    from eksml_tpu_torch.models.mask_rcnn import dtype_of

    dtype = dtype_of(param_dtype)
    if dtype == torch.float32:
        return
    persistent = set(model.state_dict())
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)
        for name, b in model.named_buffers():
            if name in persistent and b.dtype == torch.float32:
                b.data = b.data.to(dtype)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (FSDP2), ``t`` itself otherwise."""
    return t.to_local() if hasattr(t, "to_local") else t


def global_norm(tensors: Sequence[torch.Tensor],
                group=None) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of squares, in
    the gradients' dtype (bfloat16 under bfloat16 storage, as optax: each
    tensor's sum is accumulated in float32 and rounded, the sums added in
    that dtype).  DTensor gradients (FSDP2 shards) add their local
    squares, summed over ``group`` (the shard group) by one all-reduce,
    so the norm is the whole gradients' and never a partial."""
    total = sum((t * t).sum() for t in map(_local, tensors))
    if group is not None:
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """``optax.clip_by_global_norm`` in place, with the global ``norm``
    of ``grads`` given: unchanged below ``max_norm``, else each gradient
    becomes ``(g / norm) · max_norm`` (optax's expression; not
    ``clip_grad_norm_``, which adds 1e-6 to the norm).  A DTensor is
    scaled in its local shard."""
    keep = norm < max_norm
    for g in map(_local, grads):
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    sched: Callable[[int], float], gradient_clip: float = 0.0,
                    norm_group=None):
    """The one training step: ``step(batch, priorities, step_index)`` →
    metrics (the losses, ``learning_rate`` and ``grad_norm``, as tensors
    on the model's device except the learning rate) after one update of
    ``model`` in place.  ``grad_norm`` is of the raw gradients, before
    clipping, as ``train.py:550``.

    ``model`` may be the plan's wrapper (DDP, or a module under FSDP2
    with ``norm_group`` its shard group).  Under a process group the
    losses and ``grad_norm`` are averaged across ranks (one all-reduce),
    so every rank returns the same metrics: the global batch's.

    Under bfloat16 storage the learning rate is rounded to bfloat16
    before the update, as optax's ``scale_by_schedule`` casts it to the
    update's dtype."""
    params = [p for group in optimizer.param_groups
              for p in group["params"]]
    lr_dtype = params[0].dtype if params else torch.float32

    def step(batch: Dict[str, torch.Tensor],
             priorities: Dict[str, torch.Tensor],
             step_index: int) -> Dict[str, object]:
        optimizer.zero_grad(set_to_none=True)
        losses = model(batch, priorities)
        losses["total_loss"].backward()
        for p in params:
            # the reference's gradient of an unused parameter is zero,
            # and it still decays and carries momentum
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with named_scope("optimizer"):
            grads = [p.grad for p in params]
            norm = global_norm(grads, norm_group)
            if gradient_clip > 0:
                clip_by_global_norm_(grads, gradient_clip, norm)
            lr = sched(step_index)
            if lr_dtype != torch.float32:
                lr = float(torch.tensor(lr, dtype=lr_dtype))
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
        values = {k: v.detach() for k, v in losses.items()}
        values["grad_norm"] = norm.detach().float()
        if dist.is_initialized() and dist.get_world_size() > 1:
            vec = torch.stack(list(values.values()))
            dist.all_reduce(vec)
            vec = vec / dist.get_world_size()
            values = dict(zip(values, vec))
        metrics: Dict[str, object] = dict(values)
        metrics["learning_rate"] = lr
        return metrics

    return step


def _telemetry_knobs(cfg) -> Dict[str, Any]:
    from eksml_tpu_torch.config import TELEMETRY_DEFAULTS, knobs_with_defaults

    return knobs_with_defaults(getattr(cfg, "TELEMETRY", None),
                               TELEMETRY_DEFAULTS)


def _tracing_knobs(cfg) -> Dict[str, Any]:
    from eksml_tpu_torch.config import (TELEMETRY_TRACING_DEFAULTS,
                                        knobs_with_defaults)

    return knobs_with_defaults(
        getattr(getattr(cfg, "TELEMETRY", None), "TRACING", None),
        TELEMETRY_TRACING_DEFAULTS)


def _goodput_knobs(cfg) -> Dict[str, Any]:
    from eksml_tpu_torch.config import (TELEMETRY_GOODPUT_DEFAULTS,
                                        knobs_with_defaults)

    return knobs_with_defaults(
        getattr(getattr(cfg, "TELEMETRY", None), "GOODPUT", None),
        TELEMETRY_GOODPUT_DEFAULTS)


def _preregister_core_metrics(registry) -> None:
    """Create the always-present series (the reference's set), so the
    FIRST scrape of a healthy run already shows every resilience, data,
    checkpoint and goodput series at 0: dashboards and alerts key on
    existence, not just increments."""
    for name, help_text in (
        ("eksml_resilience_preemptions",
         "SIGTERM preemption signals observed"),
        ("eksml_resilience_rollbacks",
         "divergence rollbacks to a previous checkpoint"),
        ("eksml_resilience_nonfinite_losses",
         "non-finite total_loss observations (divergence sentinel)"),
        ("eksml_resilience_watchdog_fires",
         "hang-watchdog deadline expiries (stack reports written)"),
        ("eksml_data_io_recoveries",
         "transient I/O errors absorbed by bounded retry"),
        ("eksml_data_pool_rebuilds",
         "decode process-pool self-heals after a worker death"),
        ("eksml_checkpoint_saves", "checkpoint commits started"),
        ("eksml_checkpoint_restores", "checkpoint restores completed"),
        ("eksml_checkpoint_fallbacks",
         "checkpoint integrity walk-backs to an earlier step"),
        ("eksml_checkpoint_restore_resharded",
         "checkpoint restores resharded across a topology change"),
    ):
        registry.counter(name, help_text)
    # the quarantine census is labeled by fault kind where it increments
    # (data/robust.py): preregister the same series
    for kind in ("decode", "missing", "io_exhausted"):
        registry.counter(
            "eksml_data_quarantined_records",
            "distinct records quarantined by the data-ingest layer",
            labels={"kind": kind})
    # the goodput ledger: every badput bucket, the ratio gauge and the
    # phase events it reads exist before the first increment
    from eksml_tpu_torch.telemetry import goodput as goodput_mod

    registry.gauge(goodput_mod.RATIO_GAUGE,
                   "fraction of run wall-clock spent in train steps")
    registry.counter(goodput_mod.GOODPUT_COUNTER,
                     "training wall-clock seconds (the goodput "
                     "bucket)")
    for bucket in goodput_mod.BADPUT_BUCKETS:
        registry.counter(goodput_mod.BADPUT_COUNTER,
                         "non-training wall-clock seconds by bucket",
                         labels={"bucket": bucket})
    for kind in ("compile_start", "compile_done", "eval_start",
                 "eval_done"):
        registry.counter("eksml_flight_events",
                         "flight-recorder events by kind",
                         labels={"kind": kind})


def _config_digest(cfg) -> str:
    """Short stable digest of the finalized config (the ``run_start``
    header field that tells a relaunch with the same config from a
    restart that changed hyperparameters)."""
    from eksml_tpu_torch.config import dump_config

    try:
        return hashlib.sha256(dump_config(cfg).encode()).hexdigest()[:12]
    except Exception:  # noqa: BLE001 — a digest must never block a run
        return "unknown"


class Trainer:
    """One process, one device (a rank of a process group, or alone): the
    model, the sharding plan it trains under, the optimizer, the sampling
    priority generator, the checkpoints and the loop.

    The live state is ``model`` (parameters and FrozenBN buffers), the
    optimizer's momentum buffers, the priority generator and ``step``
    (None until :meth:`init_state` or :meth:`restore_or_init` set it).
    A checkpoint holds exactly that (:meth:`checkpoint_state`): each
    step's priorities come from the generator, whose state stands in for
    the reference's ``TrainState.rng`` (``fold_in(rng, step)``,
    ``eksml_tpu/train.py:529``), so a restored run draws the priorities
    the uninterrupted run would have drawn.  Every rank draws the
    priorities of the whole global batch from its generator and takes its
    own rows, so the generators stay equal and a restore at another world
    size draws what the uninterrupted run would have drawn.

    Under a process group (``parallel/distributed.initialize_from_env``)
    ``TRAIN.SHARDING.*`` picks the wrapper (``parallel/sharding.py``),
    ``TRAIN.NUM_CHIPS`` must equal the world size (it sets the global
    batch the learning rate is scaled to), the coordinator alone writes
    the metrics and the checkpoints, each rank keeps its own flight
    events, and every decision that ends or rewinds the loop (rollback,
    preemption, the last step) is taken on values all ranks share.
    ``TRAIN.SYNC_CHECK_PERIOD`` runs the replica sync check under
    ``replicated``.

    ``TELEMETRY.ENABLED`` installs one flight recorder per rank and,
    with ``TELEMETRY.TRACING.ENABLED``, one span tracer per rank
    (``trace-host<rank>.json``); :meth:`fit` runs the rest of the
    telemetry layer."""

    def __init__(self, cfg, logdir: str, device="cuda", eval_fn=None):
        self.cfg = cfg
        self.logdir = logdir
        self.eval_fn = eval_fn
        self.device = resolve_device(device)
        #: cuDNN's algorithm choice for this process (``run_start`` row)
        self.cudnn = choose_cudnn_algorithms(cfg, "train")
        self.world, self.rank = process_count(), process_index()
        if dist.is_initialized() and int(cfg.TRAIN.NUM_CHIPS) != self.world:
            raise ValueError(
                f"TRAIN.NUM_CHIPS={cfg.TRAIN.NUM_CHIPS} but the process "
                f"group has {self.world} rank(s): the learning rate is "
                "scaled to TRAIN.NUM_CHIPS x TRAIN.BATCH_SIZE_PER_CHIP "
                "images, so set TRAIN.NUM_CHIPS to the world size")
        self.plan = ShardingPlan.from_config(cfg)
        warm_mesh_collectives(self.plan.mesh)
        if self.device.type == "cuda":
            from eksml_tpu_torch.ops.roi_align import KERNELS

            KERNELS.load()
        self.model = MaskRCNN.from_config(cfg).to(self.device)
        cast_for_storage(self.model, cfg.TRAIN.PARAM_DTYPE)
        #: the module the step calls (the plan's wrapper around
        #: ``model``), set by the first :meth:`init_state`
        self.train_module: Optional[torch.nn.Module] = None
        self.optimizer = None
        self.sched = None
        self._step = None
        self.step: Optional[int] = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(cfg.TRAIN.SEED))
        run_info = {"config_digest": _config_digest(cfg),
                    "cudnn": self.cudnn}
        self.writer = (MetricWriter(logdir, run_info=run_info)
                       if is_coordinator() else None)
        self._telemetry = _telemetry_knobs(cfg)
        self._tracing = _tracing_knobs(cfg)
        self._goodput_cfg = _goodput_knobs(cfg)
        # the live goodput meter: set only while fit runs
        self._goodput = None
        #: what the newest profiler capture wrote (``_finish_capture``)
        self.last_capture: Optional[Dict[str, Any]] = None
        #: the newest first-step roofline (``_counted_step``)
        self.last_prediction: Optional[Dict[str, Any]] = None
        self._hbm_peak_logged = False
        self.recorder = None
        self.tracer = None
        if self._telemetry["ENABLED"]:
            # one flight recorder per rank: incidents are per-rank facts
            prev = telemetry.install(telemetry.FlightRecorder(
                capacity=int(self._telemetry["FLIGHT_RECORDER_EVENTS"]),
                path=telemetry.events_path_for(logdir, self.rank),
                host_id=self.rank))
            if prev is not None:
                prev.close()    # a prior Trainer's recorder in this process
            self.recorder = telemetry.recorder.get()
            telemetry.event("run_start", pid=os.getpid(),
                            host_count=self.world, **run_info)
            if self._tracing["ENABLED"]:
                # one span tracer per rank too: trace-host<rank>.json
                prev_t = telemetry.install_tracer(telemetry.Tracer(
                    capacity=int(self._tracing["RING_EVENTS"]),
                    path=telemetry.trace_path_for(logdir, self.rank),
                    host_id=self.rank))
                if prev_t is not None:
                    prev_t.flush()
                self.tracer = telemetry.get_tracer()
        if is_coordinator():
            log.info("sharding plan: %s over mesh %s", self.plan.describe(),
                     dict(zip(self.plan.mesh_axes, self.plan.mesh_shape)))
        res = cfg.RESILIENCE
        self.ckpt = CheckpointManager(
            logdir, digest=bool(res.CHECKPOINT_DIGEST),
            topology=current_topology(self.device, self.plan,
                                      self.plan.mesh,
                                      int(cfg.TPU.NUM_SLICES)),
            elastic=bool(res.ELASTIC_RESUME))

    # -- state ---------------------------------------------------------

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> MaskRCNN:
        """Fresh state at step 0: ``params`` (a ``state_dict``), or the
        seeded init (``convert.init_params`` from ``TRAIN.SEED``) with
        ``BACKBONE.WEIGHTS`` loaded over it when set; a new optimizer and
        the generator reseeded.  Returns the model (the unwrapped module;
        the first call wraps it in the plan's wrapper, after loading)."""
        if params is None:
            from eksml_tpu_torch.convert import init_params

            params = init_params(self.cfg, torch.Generator().manual_seed(
                int(self.cfg.TRAIN.SEED)))
            if self.cfg.BACKBONE.WEIGHTS:
                from eksml_tpu_torch.models.backbone_loader import \
                    load_r50_npz

                loaded, expected = load_r50_npz(self.cfg.BACKBONE.WEIGHTS,
                                                params)
                log.info("backbone weights: loaded %d/%d arrays from %s",
                         loaded, expected, self.cfg.BACKBONE.WEIGHTS)
        if self.train_module is None or not dist.is_initialized():
            self.model.load_state_dict(params)
        else:   # already wrapped (sharded under FSDP2): every rank loads
            load_full_state(self.model, params)
        if self.train_module is None:
            self.train_module = self.plan.wrap(self.model)
        self.model.train()
        # built on the wrapped parameters (DTensors under FSDP2); the
        # decay mask comes from the names, which wrapping keeps
        self.optimizer, self.sched = make_optimizer(self.model, self.cfg)
        self._step = make_train_step(self.train_module, self.optimizer,
                                     self.sched,
                                     float(self.cfg.TRAIN.GRADIENT_CLIP),
                                     norm_group=self.plan.norm_group)
        self.generator.manual_seed(int(self.cfg.TRAIN.SEED))
        self.step = 0
        self._publish_memory_budget()
        return self.model

    def _publish_memory_budget(self) -> None:
        """One log line and the two state-byte gauges per (re)init: this
        rank's parameter bytes and the optimizer's, in the storage dtype
        under the active plan (the momentum buffers, one per trainable
        parameter in its dtype, are made at the first step; counted
        here at the size they will have)."""
        trainable = [p for g in self.optimizer.param_groups
                     for p in g["params"]]
        pb, ob = publish_state_byte_gauges(self.model.state_dict(),
                                           trainable)
        log.info("memory budget/device: params %.2f MiB + optimizer state "
                 "%.2f MiB (param_dtype=%s, sharding=%s)", pb / 2 ** 20,
                 ob / 2 ** 20, self.cfg.TRAIN.PARAM_DTYPE,
                 self.plan.describe())

    def checkpoint_state(self) -> Dict[str, Any]:
        """The live state as a checkpoint holds it, whole tensors under
        the module's own names at any world size and strategy
        (references to the live tensors where they are whole: the
        checkpoint manager copies them).  A collective under FSDP2, which
        gathers every shard."""
        return {"step": int(self.step), "model": full_state_dict(self.model),
                "optimizer": full_optimizer_state(self.optimizer),
                "generator": self.generator.get_state()}

    def state_bytes(self):
        """``(param_bytes, opt_bytes)`` this rank holds (its shards under
        FSDP2), also published as the state-byte gauges."""
        return publish_state_byte_gauges(self.model.state_dict(),
                                         self.optimizer.state_dict()["state"])

    def load_checkpoint_state(self, state: Optional[Dict[str, Any]]) -> None:
        """Make ``state`` (a :meth:`checkpoint_state` read back) the live
        state.  Checks names, shapes and dtypes first and raises
        ``ValueError`` before anything changes on a mismatch; float
        tensors saved in another float dtype (a run that changed
        ``TRAIN.PARAM_DTYPE``) load cast to the live dtype, as the
        reference restores into its state's dtypes.  Under a
        process group a collective: ``state`` is given on the coordinator
        (``None`` elsewhere), checked there, and broadcast into every
        rank's tensors and shards."""
        err = None
        if state is not None:
            try:
                self._check_checkpoint_state(state)
            except ValueError as e:
                err = str(e)
        if not dist.is_initialized():
            if err is not None:
                raise ValueError(err)
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            self.generator.set_state(state["generator"])
            self.step = int(state["step"])
            return
        err = broadcast_object(err)
        if err is not None:
            raise ValueError(err)
        load_full_state(self.model, state and state["model"], self.optimizer,
                        state and state["optimizer"])
        gen, step = broadcast_object(
            None if state is None else (state["generator"],
                                        int(state["step"])))
        self.generator.set_state(gen)
        self.step = step

    def _check_checkpoint_state(self, state: Dict[str, Any]) -> None:
        live = self.model.state_dict()
        saved = state["model"]
        if set(saved) != set(live):
            raise ValueError(
                "checkpoint model tensors differ from the model: missing "
                f"{sorted(set(live) - set(saved))[:5]}, unexpected "
                f"{sorted(set(saved) - set(live))[:5]}")
        cast = []
        for k, v in saved.items():
            same_kind = v.dtype == live[k].dtype or (
                v.is_floating_point() and live[k].is_floating_point())
            if v.shape != live[k].shape or not same_kind:
                raise ValueError(
                    f"checkpoint tensor {k} is {tuple(v.shape)}/{v.dtype}, "
                    f"the model's {tuple(live[k].shape)}/{live[k].dtype}")
            if v.dtype != live[k].dtype:
                cast.append(k)
        if cast:
            # the reference restores into its state's dtypes (Orbax casts
            # to the target), so a run that changed TRAIN.PARAM_DTYPE
            # resumes; loading casts the tensors and the momentum buffers
            log.warning("checkpoint holds %d tensors in another float dtype "
                        "than the model (e.g. %s: %s -> %s); restoring them "
                        "cast to the model's", len(cast), cast[0],
                        saved[cast[0]].dtype, live[cast[0]].dtype)
        groups = [len(g["params"]) for g in state["optimizer"]["param_groups"]]
        want = [len(g["params"]) for g in self.optimizer.param_groups]
        if groups != want:
            raise ValueError(f"checkpoint optimizer groups hold {groups} "
                             f"parameters, this optimizer {want}")

    def restore_or_init(self, step: Optional[int] = None) -> int:
        """Auto-resume: fresh state (:meth:`init_state`), then the newest
        checkpoint that verifies and loads (``restore_with_fallback``
        walks back past corrupt steps), or exactly ``step`` when given
        (``--load``).  Returns the step the live state is at."""
        self.init_state()
        if step is not None:
            barrier()
            self.load_checkpoint_state(self.ckpt.restore(step)
                                       if is_coordinator() else None)
        elif self.ckpt.restore_with_fallback(
                self.load_checkpoint_state) is None:
            return self.step
        log.info("resuming from checkpoint step %d", self.step)
        return self.step

    def _priorities(self, batch: Dict[str, torch.Tensor],
                    step: int) -> Dict[str, torch.Tensor]:
        """The sampling priorities of the step taken from ``step``: those
        of the whole global batch, drawn from the generator, of which
        this rank takes its own rows."""
        b, h, w, _ = batch["images"].shape
        g = batch["gt_boxes"].shape[1]
        pri = self.model.make_priorities((b * self.world, h, w, g),
                                         self.generator)
        if self.world == 1:
            return pri
        return {k: v[self.rank * b:(self.rank + 1) * b]
                for k, v in pri.items()}

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in batch_tensors(batch).items()}

    # -- the loop ------------------------------------------------------

    def fit(self, batches: Iterator[Dict[str, np.ndarray]],
            total_steps: int, start_step: int = 0,
            data_health=None, profile_steps: int = 0
            ) -> List[Dict[str, float]]:
        """Train up to ``total_steps`` over the host ``batches``.

        With live state (:meth:`init_state`, a previous ``fit``) the run
        continues from it at ``start_step``; without, the first batch
        triggers :meth:`restore_or_init` and the run continues from the
        checkpoint's step (``eksml_tpu/train.py:865-879``).

        Per step: checkpoints every ``TRAIN.CHECKPOINT_PERIOD`` epochs of
        ``TRAIN.STEPS_PER_EPOCH`` steps and at the last step (never while
        the divergence sentinel has seen a non-finite loss); the sentinel
        observes the loss at checkpoint steps and every
        ``RESILIENCE.NAN_CHECK_PERIOD`` steps (0: at log steps) and rolls
        back to the last good checkpoint without rewinding the data;
        ``eval_fn(model, step)`` every ``TRAIN.EVAL_PERIOD`` epochs and at
        the last step (:meth:`_run_eval`); SIGTERM forces a checkpoint and
        raises :class:`PreemptedError` (exit code
        ``RESILIENCE.PREEMPT_EXIT_CODE``); the hang watchdog beats at each
        phase.  With
        ``TRAIN.PREFETCH_TO_DEVICE`` the next batches are built and copied
        on a worker thread; it pulls only the batches the steps take.

        ``data_health``: the loader's ``LoaderHealth`` (``data/robust.py``).
        Its scalars (queue depth, quarantine census, batch-build time)
        join every logged row as ``data/*``, its gauges are registered,
        and its report joins the watchdog's hang dump, so input
        starvation reads as a stalled data pipeline, not a generic hang.

        Telemetry (``TELEMETRY.ENABLED``, as the reference): the core
        series are preregistered; local rank 0 serves ``/metrics``,
        ``/healthz``, ``/debugz/profile`` and ``/debugz/stacks`` on
        ``TELEMETRY.PORT`` for the loop's lifetime (the port it bound in
        ``<logdir>/telemetry-host<rank>.port``); the loop's phases are
        spans (``data_wait``, ``globalize_batch`` — the host-to-device
        copy —, ``train_step``, ``host_metrics``, ``host_aggregate``,
        ``checkpoint_save``/``_restore``, ``eval``); the first step is
        the ``compile`` window (cuDNN's autotune); with
        ``TELEMETRY.GOODPUT.ENABLED`` the goodput meter classifies the
        loop's wall time, recovers the downtime since the previous
        segment and banks ``goodput-host<rank>.jsonl`` at every log step
        and at exit.  ``train_step`` times the host's dispatch: the card
        runs behind it, and the step's own syncs (NMS) and the log step's
        loss read are where the host waits.

        ``profile_steps``: on global rank 0, a ``torch.profiler`` capture
        of that many steps after the first (``--profile N``).  The same
        executor takes ``/debugz/profile`` requests and the anomaly
        detector's (``TELEMETRY.TRACING``), under the trigger's cooldown
        and budget: each capture writes its Chrome trace and
        ``attribution.json`` (device time by model component) under
        ``<logdir>/profile`` (:meth:`_finish_capture`).

        Under a process group every rank runs this loop over its own
        ``batches`` (its shard); ``TRAIN.SYNC_CHECK_PERIOD`` checks that
        the replicas agree (``replicated`` only: under ``fsdp`` the shards
        legitimately differ and the check is disabled with a warning, as
        in the reference), and the SIGTERM flag is agreed across ranks
        every ``RESILIENCE.PREEMPT_SYNC_PERIOD`` steps (0: the log period).

        Returns the rows logged every ``TRAIN.LOG_PERIOD`` steps and at
        the last step (also written to ``metrics.jsonl`` by the
        coordinator): the losses, ``learning_rate``, ``grad_norm``,
        ``images_per_sec`` (the global batch), ``step_time_ms`` (wall
        time per step since the previous row, ending on the device's
        results), ``data/*`` (above), with ``TELEMETRY.AGGREGATE_HOSTS``
        the ranks' ``hosts/*`` min/max/mean and straggler, with goodput
        ``goodput/ratio``, and ``step``."""
        cfg = self.cfg
        res = cfg.RESILIENCE
        sync_every = int(cfg.TRAIN.SYNC_CHECK_PERIOD)
        if sync_every and self.plan.strategy != "replicated":
            log.warning("TRAIN.SYNC_CHECK_PERIOD disabled: the replica sync "
                        "check assumes replicated params (sharding strategy "
                        "%r)", self.plan.strategy)
            sync_every = 0
        tele = self._telemetry
        aggregate = bool(tele["ENABLED"] and tele["AGGREGATE_HOSTS"])
        steps_per_epoch = int(cfg.TRAIN.STEPS_PER_EPOCH)
        ckpt_every = max(1, int(cfg.TRAIN.CHECKPOINT_PERIOD)) * steps_per_epoch
        eval_every = max(1, int(cfg.TRAIN.EVAL_PERIOD)) * steps_per_epoch
        log_period = max(1, int(cfg.TRAIN.LOG_PERIOD))
        step = start_step if self.step is not None else None
        preempt = (PreemptionHandler(exit_code=res.PREEMPT_EXIT_CODE).install()
                   if res.GRACEFUL_SHUTDOWN else None)
        watchdog = None
        if res.WATCHDOG_TIMEOUT_SEC > 0:
            watchdog = HangWatchdog(
                res.WATCHDOG_TIMEOUT_SEC, report_dir=self.logdir,
                first_beat_factor=res.WATCHDOG_COMPILE_FACTOR).start()
            if data_health is not None:
                watchdog.add_report_provider("data pipeline",
                                             data_health.report)
            if self.recorder is not None:
                watchdog.add_report_provider("flight recorder",
                                             self.recorder.report)
        registry = telemetry.default_registry()
        _preregister_core_metrics(registry)
        if data_health is not None:
            data_health.register_gauges(registry)
        # /healthz liveness: seconds since the loop last made progress (a
        # step, a restore, a checkpoint save, an eval, a rollback); past
        # HEALTHZ_STALE_SEC the probe reads 503.  The bound must cover the
        # longest legitimate phase: the first step's autotune, one eval.
        health_state = {"step": step if step is not None else start_step,
                        "total_steps": total_steps}
        health_clock = {"last_step": time.monotonic()}

        def _progress() -> None:
            health_clock["last_step"] = time.monotonic()

        def _health() -> Dict[str, Any]:
            out = dict(health_state)
            out["seconds_since_last_step"] = round(
                time.monotonic() - health_clock["last_step"], 1)
            return out

        # captures on request: ONE trigger for /debugz/profile and the
        # anomaly detector; --profile takes the same executor
        profile_trigger = detector = None
        if tele["ENABLED"]:
            profile_trigger = telemetry.ProfileTrigger(
                cooldown_sec=float(self._tracing["PROFILE_COOLDOWN_SEC"]),
                max_captures=int(self._tracing["MAX_CAPTURES_PER_RUN"]),
                default_steps=int(self._tracing["PROFILE_STEPS"]))
            # automatic captures ride the tracing knob (off in the charts)
            if self._tracing["ENABLED"] and self._tracing["ANOMALY_TRIGGER"]:
                detector = telemetry.AnomalyDetector(
                    k_intervals=int(self._tracing["ANOMALY_INTERVALS"]),
                    p95_factor=float(self._tracing["ANOMALY_P95_FACTOR"]),
                    spread_factor=float(
                        self._tracing["ANOMALY_SPREAD_FACTOR"]))
        # a distinct family from the eksml_train_step_time_ms gauge the
        # MetricWriter mirror creates: one name, one type
        step_time_hist = registry.histogram(
            "eksml_train_step_duration_ms",
            "wall time per training step (log-interval mean)")
        sentinel = DivergenceSentinel(patience=res.NAN_PATIENCE,
                                      max_rollbacks=res.MAX_ROLLBACKS)
        nan_injected = False
        first_call = True
        # the roofline of the first step (profiling/predict.py): counted
        # once per fit, on the first batch shape
        predict_first = bool(tele["ENABLED"] and tele["PREDICTED_STEP_TIME"])
        capture = None      # the in-flight profiler capture
        exporter = None
        goodput_bank_path = None
        prev_span_sink = None
        prefetcher = None
        source = batches
        if cfg.TRAIN.PREFETCH_TO_DEVICE:
            prefetcher = DevicePrefetcher(
                batches, self.device,
                limit=max(0, total_steps - (step or start_step)),
                health=data_health)
            source = prefetcher
        logged: List[Dict[str, float]] = []
        t_last, steps_since_log = time.perf_counter(), 0
        if self.tracer is not None:
            # (re)installed for THIS fit; the finally uninstalls it
            telemetry.install_tracer(self.tracer)
        try:
            if tele["ENABLED"] and self._goodput_cfg["ENABLED"]:
                down_s, seg_start = telemetry.recover_downtime(
                    self.logdir, self.rank)
                meter = telemetry.GoodputMeter(
                    fine=self.tracer is not None,
                    segment_start_wall=seg_start)
                if down_s > 0:
                    meter.credit("downtime", down_s)
                    log.info("goodput: recovered %.1fs downtime since the "
                             "previous segment", down_s)
                # assigned before the sinks install: the finally removes
                # them after a partial set-up too
                self._goodput = meter
                prev_span_sink = telemetry.install_span_sink(meter.on_span)
                telemetry.add_event_sink(meter.on_event)
                if self._goodput_cfg["BANK"]:
                    goodput_bank_path = telemetry.goodput_path_for(
                        self.logdir, self.rank)
            if tele["ENABLED"] and local_rank() == 0:
                # one exporter per pod: the ranks of a host step in
                # lockstep, and only local rank 0 tries the pod's port
                exporter = telemetry.TelemetryExporter(
                    port=int(tele["PORT"]), health_fn=_health,
                    port_file=os.path.join(
                        self.logdir, f"telemetry-host{self.rank}.port"),
                    profile_trigger=profile_trigger,
                    stale_after_sec=float(tele["HEALTHZ_STALE_SEC"]),
                ).start()
            elif not tele["ENABLED"] and float(tele["HEALTHZ_STALE_SEC"]) > 0:
                log.warning(
                    "TELEMETRY.HEALTHZ_STALE_SEC=%s is set but "
                    "TELEMETRY.ENABLED=False: /healthz will NOT be served — "
                    "if the chart rendered a livenessProbe "
                    "(healthz_stale_seconds > 0) kubelet will restart this "
                    "pod in a loop. Set healthz_stale_seconds=0 when "
                    "disabling telemetry.", tele["HEALTHZ_STALE_SEC"])
            source_iter = iter(source)
            while True:
                # input spans are tagged with the step they feed (unknown
                # until the restore below has run)
                feeds = step + 1 if step is not None else None
                with telemetry.span("data_wait", step=feeds):
                    batch = next(source_iter, None)
                if batch is None:
                    break
                if watchdog:
                    watchdog.beat("to_device", step)
                with telemetry.span("globalize_batch", step=feeds):
                    if prefetcher is None:
                        batch = self._to_device(batch)
                if step is None:
                    t_restore = time.perf_counter()
                    step = self.restore_or_init()
                    _progress()     # a restore is not a hang
                    if self._goodput is not None and step > 0:
                        self._goodput.credit(
                            "checkpoint_restore",
                            time.perf_counter() - t_restore,
                            coarse_only=True)
                    health_state["step"] = step
                    if step >= total_steps:
                        break
                if watchdog:
                    watchdog.beat("train_step", step + 1)
                if first_call:
                    # the first step runs cuDNN's autotune: the goodput
                    # meter books it as compile, not as goodput
                    telemetry.event("compile_start", step=step + 1)
                    t_compile = time.perf_counter()
                    if self._goodput is not None:
                        self._goodput.begin_compile()
                # host-side dispatch: the card runs behind it
                with telemetry.span("train_step", step=step + 1):
                    priorities = self._priorities(batch, step)
                    if first_call and predict_first:
                        metrics = self._counted_step(batch, priorities,
                                                     step, registry)
                    else:
                        metrics = self._step(batch, priorities, step)
                if first_call:
                    if watchdog:
                        # from here the steady-state deadline applies
                        watchdog.end_compile_headroom()
                    compile_s = time.perf_counter() - t_compile
                    telemetry.event("compile_done", step=step + 1,
                                    compile_ms=round(compile_s * 1e3, 1))
                    if self._goodput is not None:
                        self._goodput.end_compile(compile_s)
                first_call = False
                step += 1
                self.step = step
                steps_since_log += 1
                health_state["step"] = step
                _progress()

                if (res.FAULT_INJECT_NAN_STEP and not nan_injected
                        and step == res.FAULT_INJECT_NAN_STEP):
                    # chaos hook: poison the state ONCE — every later loss
                    # is non-finite until the sentinel rolls back
                    nan_injected = True
                    log.warning("chaos: injecting NaN into params at step "
                                "%d (RESILIENCE.FAULT_INJECT_NAN_STEP)", step)
                    with torch.no_grad():
                        for t in self.model.state_dict().values():
                            if t.is_floating_point():
                                t.mul_(float("nan"))

                # profiler captures: start and stop at step boundaries
                if capture is None:
                    req = None
                    if profile_steps and self.rank == 0:
                        # --profile: global rank 0, after the first step,
                        # outside the trigger's guard rails
                        req = {"steps": profile_steps, "reason": "cli",
                               "from_trigger": False}
                        profile_steps = 0
                    elif profile_trigger is not None:
                        req = profile_trigger.take()
                        if req is not None:
                            req["from_trigger"] = True
                    if req is not None:
                        capture = self._start_capture(req, step)
                elif step >= capture["until"]:
                    capture = self._finish_capture(capture, profile_trigger,
                                                   step)

                log_step = step % log_period == 0 or step == total_steps
                ckpt_step = step % ckpt_every == 0 or step == total_steps
                period = int(res.NAN_CHECK_PERIOD)
                if (ckpt_step or (period > 0 and step % period == 0)
                        or (period == 0 and log_step)):
                    action = sentinel.observe(
                        step, float(metrics["total_loss"]))
                    if action == ROLLBACK:
                        t_rb = time.perf_counter()
                        good = self._rollback(sentinel, step, watchdog)
                        if self._goodput is not None:
                            self._goodput.credit(
                                "checkpoint_restore",
                                time.perf_counter() - t_rb, coarse_only=True)
                        _progress()     # recovery, not a hang
                        if prefetcher is not None:
                            prefetcher.extend(step - good)
                        step = good
                        health_state["step"] = step
                        t_last, steps_since_log = time.perf_counter(), 0
                        continue

                if log_step:
                    # where the host waits for the card on log steps
                    with telemetry.span("host_metrics", step=step):
                        row = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    dt = max(now - t_last, 1e-9)
                    row["images_per_sec"] = (batch["images"].shape[0]
                                             * self.world * steps_since_log
                                             / dt)
                    row["step_time_ms"] = dt * 1e3 / max(1, steps_since_log)
                    step_time_hist.observe(row["step_time_ms"])
                    if data_health is not None:
                        row.update({f"data/{k}": float(v) for k, v
                                    in data_health.scalars().items()})
                    if prefetcher is not None:
                        row["data/prefetch_wait_ms"] = \
                            prefetcher.wait_ms_ewma or 0.0
                    t_last, steps_since_log = now, 0
                    agg = None
                    if aggregate:
                        # a collective: every rank reaches this log step
                        hv = {k: row.get(f"data/{k}", 0.0)
                              for k in telemetry.HOST_AGG_KEYS}
                        hv["step_time_ms"] = row["step_time_ms"]
                        with telemetry.span("host_aggregate", step=step):
                            agg = telemetry.aggregate_host_scalars(hv)
                        telemetry.publish_aggregates(agg, registry)
                        row.update(agg)
                    if detector is not None:
                        self._observe_anomaly(detector, profile_trigger,
                                              row["step_time_ms"], agg, step)
                    if self._goodput is not None:
                        snap = self._goodput.publish(registry, steps=step)
                        row["goodput/ratio"] = snap["goodput_ratio"]
                        if goodput_bank_path:
                            self._goodput.bank(goodput_bank_path, steps=step)
                    self._log_hbm_peak(publish_hbm_gauges(self.device,
                                                          registry))
                    if self.writer:
                        self.writer.write_scalars(step, row)
                    log.info("step %d/%d loss=%.4f (%.2f img/s, %.1f ms)",
                             step, total_steps, row["total_loss"],
                             row["images_per_sec"], row["step_time_ms"])
                    row["step"] = step
                    logged.append(row)

                if sync_every and step % sync_every == 0:
                    assert_replicas_in_sync(self.model.state_dict(),
                                            self.generator.get_state())

                if ckpt_step:
                    if not sentinel.allows_save():
                        log.warning("skipping checkpoint at step %d: last "
                                    "observed total_loss is non-finite "
                                    "(divergence sentinel)", step)
                        telemetry.event("checkpoint_skipped", step=step,
                                        reason="non-finite loss observation")
                    else:
                        if watchdog:
                            watchdog.beat("checkpoint_save", step)
                        if self.ckpt.save(step, self.checkpoint_state()):
                            save_ms = self.ckpt.last_save["blocking_ms"]
                            if self.writer:
                                self.writer.write_scalars(step, {
                                    "checkpoint_save_ms": save_ms})
                            if self._goodput is not None:
                                # the blocking part only: the background
                                # write overlaps training
                                self._goodput.credit(
                                    "checkpoint_save", save_ms / 1e3,
                                    coarse_only=True)
                        _progress()     # a slow commit is not a hang
                if self.eval_fn and (step % eval_every == 0
                                     or step == total_steps):
                    if watchdog:
                        watchdog.beat("eval", step)
                    self._run_eval(step)
                    _progress()         # an eval pass is not a hang

                if preempt is not None and preempt.should_checkpoint(
                        step, res.PREEMPT_SYNC_PERIOD or log_period):
                    self._graceful_exit(preempt, metrics, step)
                if step >= total_steps:
                    break
                if watchdog:
                    watchdog.beat("next_batch", step)
        finally:
            if capture is not None:
                # the run ended inside the capture: close it so it lands
                self._finish_capture(capture, profile_trigger, step,
                                     truncated=True)
            if self._goodput is not None:
                # the segment's final ledger row, on every exit path
                try:
                    self._goodput.publish(registry, steps=step)
                    if goodput_bank_path:
                        self._goodput.bank(goodput_bank_path, steps=step,
                                           final=True)
                except Exception:  # noqa: BLE001 — observability only
                    log.exception("final goodput snapshot failed")
                telemetry.remove_event_sink(self._goodput.on_event)
                telemetry.install_span_sink(prev_span_sink)
                self._goodput = None
            if self.tracer is not None:
                self.tracer.flush()
                # later spans in this process must not land in this run
                if telemetry.get_tracer() is self.tracer:
                    telemetry.install_tracer(None)
            if watchdog:
                watchdog.stop()
            if preempt is not None:
                preempt.uninstall()
            if prefetcher is not None:
                prefetcher.close()
            if exporter is not None:
                # the endpoint dies with the loop it describes
                exporter.stop()
            # land the background write and the buffered rows; a failure
            # here is swallowed only while another exception propagates
            propagating = sys.exc_info()[0] is not None
            try:
                self.ckpt.wait()
                if self.writer:
                    self.writer.flush()
            except Exception:
                if not propagating:
                    raise
                log.exception("draining checkpoint/metrics state during "
                              "shutdown failed (keeping the original "
                              "exception)")
        return logged

    def _counted_step(self, batch: Dict[str, torch.Tensor],
                      priorities: Dict[str, torch.Tensor], step: int,
                      registry) -> Dict[str, object]:
        """The first step, run under the step counter, priced on the
        card's roofline (``profiling/predict.py``): publishes
        ``eksml_train_predicted_step_time_ms`` and logs the prediction,
        kept in ``last_prediction``.  The step itself is the real one and
        runs whatever the counting does: a failure to count or to price
        logs a warning and never ends training."""
        from eksml_tpu_torch.profiling import predict as predict_mod

        try:
            counter = predict_mod.train_counter(self.model, self.optimizer,
                                                batch, priorities)
        except Exception:  # noqa: BLE001 — observability only
            log.warning("predicted-step-time gauge unavailable",
                        exc_info=True)
            return self._step(batch, priorities, step)
        with counter:
            metrics = self._step(batch, priorities, step)
        try:
            if counter.error is not None:
                raise RuntimeError("the step counter failed") \
                    from counter.error
            counts = counter.counts(**predict_mod.train_meta(self.model,
                                                             batch))
            kind = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else None)
            pred = predict_mod.predict_for_step(
                counts, device_kind=kind,
                mesh_shape=dict(zip(self.plan.mesh_axes,
                                    self.plan.mesh_shape)),
                precision=str(self.cfg.TRAIN.PRECISION),
                num_slices=int(self.cfg.TPU.NUM_SLICES),
                strategy=self.plan.strategy)
            predict_mod.publish_predicted_gauge(pred, registry)
            self.last_prediction = pred
            self._hbm_peak_logged = False
            sec, comms, hbm = (pred["sections_ms"], pred["comms_ms"],
                               pred["hbm"])
            log.info(
                "predicted step time (%s roofline): %.2f ms (fwd %.2f / "
                "bwd %.2f / comms %.2f / optimizer %.2f; comms ici %.2f / "
                "dcn %.2f / exposed %.2f; peak HBM %.1f MB; %.3f TFLOP, "
                "%.3f of them REMAT's recompute)", pred["target"],
                pred["predicted_step_time_ms"], sec["fwd"], sec["bwd"],
                sec["comms"], sec["optimizer"], comms["ici_ms"],
                comms["dcn_ms"], comms["exposed_ms"],
                hbm.get("peak_hbm_bytes", 0) / 1e6,
                pred["totals"]["flops"] / 1e12,
                pred["recompute_flops"] / 1e12)
        except Exception:  # noqa: BLE001 — observability only
            log.warning("predicted-step-time gauge unavailable",
                        exc_info=True)
        return metrics

    def _log_hbm_peak(self, stats: Optional[Dict[str, int]]) -> None:
        """Once per prediction, at the first log step with allocator
        statistics: the predicted liveness peak against the measured
        one (the reference's ``_publish_hbm``)."""
        pred = self.last_prediction
        measured = (stats or {}).get("peak_bytes")
        if not measured or pred is None or self._hbm_peak_logged:
            return
        self._hbm_peak_logged = True
        predicted = pred["hbm"].get("peak_hbm_bytes", 0)
        log.info("hbm peak: predicted %.1f MB vs measured %.1f MB (x%.2f) "
                 "— memory-model calibration point", predicted / 1e6,
                 measured / 1e6, measured / max(predicted, 1))

    def _observe_anomaly(self, detector, trigger, step_time_ms: float,
                         agg: Optional[Dict[str, float]], step: int) -> None:
        """Feed one log interval to the anomaly detector; a persistent
        step-time regression or straggler requests the same guarded
        capture ``/debugz/profile`` uses.  ``agg`` comes off a
        collective, so every rank requests at the same step."""
        lag = spread = None
        if agg is not None:
            mean = agg.get("hosts/step_time_ms_mean", 0.0)
            if mean > 0:
                lag = agg.get("hosts/lagging")
                spread = agg.get("hosts/step_time_ms_max", 0.0) / mean
        reason = detector.observe(step_time_ms, lagging_host=lag,
                                  spread_ratio=spread)
        if reason is None or trigger is None:
            return
        ok, detail = trigger.request(
            steps=int(self._tracing["PROFILE_STEPS"]),
            reason=f"anomaly: {reason}")
        log.warning("telemetry anomaly at step %d: %s — profile capture %s "
                    "(%s)", step, reason, "accepted" if ok else "rejected",
                    detail)
        telemetry.event("anomaly_detected", step=step, reason=reason,
                        capture="accepted" if ok else detail)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_capture(self, req: Dict, step: int) -> Dict:
        """Begin a bounded ``torch.profiler`` capture (CPU and, on a
        card, CUDA activity) after step ``step``, with a span-ring
        marker.  A profiler that fails to start degrades to the span
        capture alone: a capture never takes down training."""
        # the trace covers whole steps: the card finishes the queued
        # work first (once per capture, never per step)
        self._sync()
        prof = None
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            if self.device.type == "cuda":
                primer = torch.zeros(1, device=self.device)
                for _ in range(CAPTURE_PRIMERS):
                    primer.add_(1)
        except Exception:  # noqa: BLE001 — observability is best-effort
            log.warning("torch.profiler capture failed to start — "
                        "continuing with span capture only", exc_info=True)
            prof = None
        reason = str(req.get("reason", "?"))
        if self.tracer is not None:
            self.tracer.instant("profile_capture_start", step=step,
                                reason=reason)
        telemetry.event("profile_capture", step=step, reason=reason,
                        steps=int(req["steps"]), profiler=prof is not None)
        log.info("profile capture started after step %d (%s): %d step(s) "
                 "into %s/profile", step, reason, int(req["steps"]),
                 self.logdir)
        return {"start": step, "until": step + int(req["steps"]),
                "profiler": prof, "reason": reason,
                "from_trigger": bool(req.get("from_trigger", False))}

    def _finish_capture(self, capture: Dict, trigger, step: int,
                        truncated: bool = False) -> None:
        """Close a capture: stop the profiler, write its Chrome trace
        (``profile/trace-step<first>-host<rank>.json``) and its
        attribution by model component (``profile/attribution.json`` on
        rank 0, ``attribution-host<rank>.json`` elsewhere;
        :func:`~eksml_tpu_torch.profiling.write_attribution_artifact`),
        flush the span ring and start the trigger's cooldown.  Records
        what it wrote in :attr:`last_capture` and returns None (the new
        capture state)."""
        prof = capture["profiler"]
        done = {"start_step": capture["start"], "end_step": step,
                "reason": capture["reason"], "truncated": bool(truncated),
                "profiler": prof is not None, "trace": None,
                "attribution": None, "table": None}
        if prof is not None:
            try:
                self._sync()
                prof.stop()
                out = os.path.join(self.logdir, "profile")
                os.makedirs(out, exist_ok=True)
                trace = os.path.join(
                    out, f"trace-step{capture['start'] + 1}"
                    f"-host{self.rank}.json")
                prof.export_chrome_trace(trace)
                attr = os.path.join(out, "attribution.json" if self.rank == 0
                                    else f"attribution-host{self.rank}.json")
                from eksml_tpu_torch.profiling import \
                    write_attribution_artifact

                payload = write_attribution_artifact(trace, attr, extra={
                    "steps": [capture["start"] + 1, step],
                    "reason": capture["reason"], "host": self.rank,
                    "device": str(self.device), "trace": trace})
                table = payload["component_table"]
                done.update(trace=trace, attribution=attr, table=table)
                if self.device.type == "cuda" and not table["device_events"]:
                    # the capture ran but saw no kernel: say so (its
                    # table then holds the host ops' time only)
                    log.warning("profiler capture of steps %d-%d saw no "
                                "device events", capture["start"] + 1, step)
                log.info("profiler trace%s of steps %d-%d written to %s; "
                         "%s time by component: %s",
                         " (truncated run)" if truncated else "",
                         capture["start"] + 1, step, trace, table["basis"],
                         json.dumps(table["component_pct"]))
            except Exception:  # noqa: BLE001 — shutdown must proceed
                log.warning("torch.profiler capture failed to stop or "
                            "write", exc_info=True)
        span_path = None
        if self.tracer is not None:
            self.tracer.instant("profile_capture_done", step=step,
                                reason=capture["reason"])
            span_path = self.tracer.flush()
        telemetry.event("profile_capture_done", step=step,
                        reason=capture["reason"], truncated=bool(truncated),
                        spans=span_path or "", trace=done["trace"] or "")
        if capture["from_trigger"] and trigger is not None:
            trigger.finish()
        self.last_capture = done
        return None

    def _rollback(self, sentinel: DivergenceSentinel, step: int,
                  watchdog=None) -> int:
        """Divergence recovery: restore the newest verified checkpoint
        into the live state and return its step.  The data iterator is
        NOT rewound: the window that fed the divergence is skipped.
        Raises ``DivergenceError`` when nothing is restorable or the
        rollback budget is spent."""
        if watchdog:
            watchdog.beat("rollback_restore", step)
        restored = self.ckpt.restore_with_fallback(
            self.load_checkpoint_state)
        if restored is None:
            raise sentinel.no_checkpoint_to_restore(step)
        good_step = restored[1]
        sentinel.register_rollback(step, good_step)
        telemetry.event("rollback", step=step, to_step=good_step,
                        first_bad_step=sentinel.first_bad_step)
        if self.writer:
            self.writer.write_scalars(
                good_step, {"resilience/rollback_from": float(step)})
        return good_step

    def _graceful_exit(self, preempt: PreemptionHandler,
                       metrics: Dict[str, Any], step: int) -> None:
        """SIGTERM: commit a forced checkpoint (unless this step is
        already committed or its loss is non-finite), flush the metrics
        and raise the resumable exit."""
        telemetry.default_registry().counter(
            "eksml_resilience_preemptions",
            "SIGTERM preemption signals observed").inc()
        telemetry.event("sigterm", step=step, signal_time=preempt.signal_time)
        self.ckpt.wait()
        # the coordinator's view of the commits decides for every rank
        if broadcast_object(self.ckpt.latest_step() == step):
            log.warning("preemption: step %d already committed; exiting "
                        "resumable (code %d)", step, preempt.exit_code)
        elif math.isfinite(float(metrics["total_loss"])):
            log.warning("preemption: forcing checkpoint at step %d", step)
            self.ckpt.save(step, self.checkpoint_state(), force=True)
            self.ckpt.wait()
            barrier()       # no rank exits before the coordinator committed
            log.warning("preemption: checkpoint at step %d committed; "
                        "exiting resumable (code %d)", step,
                        preempt.exit_code)
        else:
            log.warning("preemption: last loss non-finite — NOT committing "
                        "a poisoned checkpoint; exiting resumable (code %d)",
                        preempt.exit_code)
        if self.writer:
            self.writer.write_scalars(step, {"resilience/preempted": 1.0})
            self.writer.flush()
        telemetry.event("preempt_exit", step=step,
                        exit_code=preempt.exit_code)
        raise preempt.preempted(step)

    def eval_model(self) -> torch.nn.Module:
        """The module the eval predicts with: the inner module under DDP
        and plain training; under FSDP2 a local, unsharded replica built
        from the full state (the gather checkpoints use, a collective),
        so no FSDP hook fires inside the predict loop and the ranks'
        eval batch counts are free to differ (the reference localizes
        its params the same way, ``eksml_tpu/evalcoco/runner.py``)."""
        if not hasattr(self.model, "unshard"):
            return self.model
        replica = MaskRCNN.from_config(self.cfg).to(self.device)
        cast_for_storage(replica, self.cfg.TRAIN.PARAM_DTYPE)
        replica.load_state_dict(full_state_dict(self.model))
        return replica

    def _run_eval(self, step: int) -> None:
        """``eval_fn(model, step)`` on :meth:`eval_model`, its results
        written as ``val/*`` on rank 0.  A failed eval is logged and never
        stops training; ``eval_fn`` (``evalcoco.run_evaluation``) enters
        its one gather on every rank, the error path included."""
        telemetry.event("eval_start", step=step)
        t0 = time.perf_counter()
        ok = True
        try:
            with telemetry.span("eval", step=step):
                model = self.eval_model()
                with torch.no_grad():
                    results = self.eval_fn(model, step)
            del model
            if results and self.writer:
                self.writer.write_scalars(
                    step, {f"val/{k}": v for k, v in results.items()})
        except Exception:  # noqa: BLE001 — a failed eval never stops training
            ok = False
            log.exception("eval at step %d failed", step)
        finally:
            self.model.train()
            eval_s = time.perf_counter() - t0
            telemetry.event("eval_done", step=step, ok=ok,
                            eval_ms=round(eval_s * 1e3, 1))
            if self._goodput is not None:
                # coarse_only: with spans the eval span fed the meter
                self._goodput.credit("eval", eval_s, coarse_only=True)

    def close(self) -> None:
        """Land the last checkpoint, close the writer and recorder and
        uninstall the tracer (safe to call twice)."""
        self.ckpt.close()
        writer, self.writer = self.writer, None
        if writer:
            writer.close()
        tracer, self.tracer = self.tracer, None
        if tracer is not None and telemetry.get_tracer() is tracer:
            telemetry.install_tracer(None)
        recorder, self.recorder = self.recorder, None
        if recorder is not None:
            if telemetry.recorder.get() is recorder:
                telemetry.install(None)
            recorder.close()


# ---- CLI ------------------------------------------------------------


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m eksml_tpu_torch.train",
        description="Mask-RCNN trainer of the PyTorch/CUDA port")
    p.add_argument("--logdir", default=None,
                   help="run directory (default: config TRAIN.LOGDIR)")
    p.add_argument("--config", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides")
    p.add_argument("--load", type=int, default=None,
                   help="restore exactly this checkpoint step (default: "
                        "the newest verified one)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated data (default: the COCO "
                        "splits DATA.TRAIN under DATA.BASEDIR, with "
                        "periodic eval on DATA.VAL)")
    p.add_argument("--total-steps", type=int, default=None,
                   help="steps to train to (default: TRAIN.STEPS_PER_EPOCH "
                        "x TRAIN.MAX_EPOCHS)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="on rank 0, a torch.profiler capture of N steps "
                        "after the first, written with its attribution by "
                        "model component to <logdir>/profile")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without one)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """``python -m eksml_tpu_torch.train``: train on ``--device`` from the
    global config with ``--config`` overrides, resuming from the newest
    verified checkpoint in the logdir.

    Without ``--synthetic`` it reads the splits ``DATA.TRAIN`` under
    ``DATA.BASEDIR`` through ``CocoDataset`` (preflight by
    ``RESILIENCE.DATA.VALIDATE``), trains on the file-backed loader
    (quarantine ledger under the logdir, its health in the logged rows)
    and evaluates box and mask AP on ``DATA.VAL`` every
    ``TRAIN.EVAL_PERIOD`` epochs and at the last step (``val/*`` in
    ``metrics.jsonl``).  Exits 0 when done, and with
    ``RESILIENCE.PREEMPT_EXIT_CODE`` (77) after a SIGTERM's forced
    checkpoint (agreed across ranks).

    Launched as N processes with the JobSet env (``COORDINATOR_ADDRESS``,
    ``NUM_PROCESSES``, ``PROCESS_ID``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``; ``parallel/distributed.py``) it starts the
    process group, trains on ``cuda:LOCAL_RANK`` over its shard of the
    records, and tears the group down on exit."""
    logging.basicConfig(
        level=logging.INFO, force=True,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = parse_args(argv)

    from eksml_tpu_torch.config import config, config_from_env, finalize_configs
    from eksml_tpu_torch.data.coco import CocoDataset
    from eksml_tpu_torch.data.loader import DetectionLoader, SyntheticDataset
    from eksml_tpu_torch.ops.roi_align import KERNELS
    from eksml_tpu_torch.parallel.distributed import (initialize_from_env,
                                                      shutdown)

    config_from_env(config)
    config.freeze(False)
    if args.logdir:
        config.TRAIN.LOGDIR = args.logdir
    if args.synthetic:
        config.DATA.SYNTHETIC = True
    config.update_args(args.config)
    cfg = finalize_configs(is_training=True)

    started = not dist.is_initialized()
    initialize_from_env(cfg, device=args.device)
    started = started and dist.is_initialized()
    try:
        eval_fn = None
        if not cfg.DATA.SYNTHETIC:
            from eksml_tpu_torch._native import build_all
            from eksml_tpu_torch.evalcoco import make_eval_fn

            build_all()     # a collective: local rank 0 compiles
            eval_fn = make_eval_fn(cfg, device=args.device)
        trainer = Trainer(cfg, cfg.TRAIN.LOGDIR, device=args.device,
                          eval_fn=eval_fn)
    except BaseException:
        if started:
            shutdown()
        raise
    log.info("rank %d of %d on %s", trainer.rank, trainer.world,
             trainer.device)
    try:
        # inside the try: a strict preflight or a resumed ledger above the
        # breaker raises, and the trainer must still be closed
        if cfg.DATA.SYNTHETIC:
            records = SyntheticDataset(
                num_images=64, height=cfg.PREPROC.MAX_SIZE,
                width=cfg.PREPROC.MAX_SIZE,
                num_classes=cfg.DATA.NUM_CLASSES).records()
        else:
            records = []
            for split in cfg.DATA.TRAIN:
                records += CocoDataset(
                    cfg.DATA.BASEDIR, split,
                    validate=cfg.RESILIENCE.DATA.VALIDATE,
                    validate_sample=cfg.RESILIENCE.DATA.VALIDATE_SAMPLE,
                ).records()
        loader = DetectionLoader(records, cfg, cfg.TRAIN.BATCH_SIZE_PER_CHIP,
                                 num_hosts=trainer.world,
                                 host_id=trainer.rank, seed=cfg.TRAIN.SEED,
                                 with_masks=cfg.MODE_MASK,
                                 ledger_dir=cfg.TRAIN.LOGDIR,
                                 num_slices=int(cfg.TPU.NUM_SLICES))
        total_steps = (args.total_steps if args.total_steps is not None
                       else cfg.TRAIN.STEPS_PER_EPOCH * cfg.TRAIN.MAX_EPOCHS)
        start = 0
        if args.load is not None:
            start = trainer.restore_or_init(args.load)
        trainer.fit(loader.batches(None), total_steps, start_step=start,
                    data_health=loader.health, profile_steps=args.profile)
    except PreemptedError as e:
        log.warning("preempted at step %d: exiting with resumable code %d "
                    "(a relaunch auto-resumes)", e.step, e.exit_code)
        raise
    else:
        log.info("training complete at %d steps", total_steps)
    finally:
        propagating = sys.exc_info()[0] is not None
        try:
            trainer.close()
        except Exception:
            if not propagating:
                raise
            log.exception("closing the trainer failed during shutdown "
                          "(keeping the original exit status)")
        finally:
            if started:
                shutdown()
            log.info("ROIAlign kernel launches in this process: %s",
                     json.dumps(KERNELS.launch_counts()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
