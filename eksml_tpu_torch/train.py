"""Training of the port's Mask-RCNN: the optimizer, the one step builder
and a minimal trainer (``eksml_tpu/train.py``: ``lr_schedule``,
``_decay_mask``, ``make_optimizer``, ``Trainer._train_step``,
``make_synthetic_train_step``).

The optimizer is the reference's optax chain, step for step:
``clip_by_global_norm`` (only when ``TRAIN.GRADIENT_CLIP`` > 0), weight
decay on trainable kernels only, SGD with momentum, and the warmup plus
piecewise-constant learning rate rescaled by the global batch.  Optax's
momentum trace (``t = g + m·t``, update ``-lr·t``) equals
``torch.optim.SGD``'s buffer with no dampening, and its decayed weights
(``g + wd·p``) equal SGD's ``weight_decay``, so one SGD with two
parameter groups is the chain; the learning rate is set from the
schedule before each update.

``Trainer.fit`` steps over host batches; the config knobs it does not
read yet are listed in its docstring.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from eksml_tpu_torch.device import resolve_device
from eksml_tpu_torch.models import MaskRCNN

log = logging.getLogger("eksml_tpu_torch.train")

# host-side batch entries the model does not take
_HOST_ONLY = ("image_scale", "image_id")


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


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of squares."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """``optax.clip_by_global_norm`` in place, with the global ``norm``
    of ``grads`` given: unchanged below ``max_norm``, else each gradient
    becomes ``(g / norm) · max_norm`` (optax's expression; not
    ``clip_grad_norm_``, which adds 1e-6 to the norm)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_train_step(model: MaskRCNN, optimizer: torch.optim.Optimizer,
                    sched: Callable[[int], float], gradient_clip: float = 0.0):
    """The one training step: ``step(batch, priorities, step_index)`` →
    metrics (the losses, ``learning_rate`` and ``grad_norm``, as tensors
    on the model's device except the learning rate) after one update of
    ``model`` in place.  ``grad_norm`` is of the raw gradients, before
    clipping, as ``train.py:550``."""
    params = [p for group in optimizer.param_groups
              for p in group["params"]]

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
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if gradient_clip > 0:
            clip_by_global_norm_(grads, gradient_clip, norm)
        lr = sched(step_index)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        metrics: Dict[str, object] = {k: v.detach()
                                      for k, v in losses.items()}
        metrics["learning_rate"] = lr
        metrics["grad_norm"] = norm.detach()
        return metrics

    return step


class Trainer:
    """One process, one device.  ``init_state`` loads parameters (given,
    or ``convert.init_params`` from ``TRAIN.SEED``); ``fit`` draws each
    step's sampling priorities from a generator seeded with
    ``TRAIN.SEED`` and logs the step's metrics every
    ``TRAIN.LOG_PERIOD`` steps.

    Not read yet (ROADMAP.md Queue 1 item 3 and later): ``logdir`` is
    kept but nothing is written there (no checkpoints,
    ``TRAIN.CHECKPOINT_PERIOD``, no metrics writer or ``TELEMETRY.*``),
    ``TRAIN.EVAL_PERIOD``, ``TRAIN.STEPS_PER_EPOCH``/``MAX_EPOCHS``
    (``fit`` takes the step count), ``BACKBONE.WEIGHTS``,
    ``RESILIENCE.*`` (rollback, preemption, watchdog),
    ``TRAIN.SHARDING.*`` and more than one device (``TRAIN.NUM_CHIPS``
    only scales the learning rate), ``TRAIN.REMAT``,
    ``TRAIN.PARAM_DTYPE``, ``TRAIN.PREFETCH_TO_DEVICE``."""

    def __init__(self, cfg, logdir: str, device="cuda"):
        self.cfg = cfg
        self.logdir = logdir
        self.device = resolve_device(device)
        self.model = MaskRCNN.from_config(cfg).to(self.device)
        self.optimizer = None
        self.sched = None
        self._step = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(cfg.TRAIN.SEED))

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> MaskRCNN:
        """Load ``params`` (a ``state_dict``; seeded from ``TRAIN.SEED``
        when None) and build the optimizer; returns the model."""
        if params is None:
            from eksml_tpu_torch.convert import init_params

            params = init_params(self.cfg, torch.Generator().manual_seed(
                int(self.cfg.TRAIN.SEED)))
        self.model.load_state_dict(params)
        self.model.train()
        self.optimizer, self.sched = make_optimizer(self.model, self.cfg)
        self._step = make_train_step(self.model, self.optimizer, self.sched,
                                     float(self.cfg.TRAIN.GRADIENT_CLIP))
        return self.model

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items() if k not in _HOST_ONLY}

    def fit(self, batches: Iterator[Dict[str, np.ndarray]],
            total_steps: int, start_step: int = 0) -> List[Dict[str, float]]:
        """Run steps ``start_step .. total_steps - 1`` over ``batches``;
        returns the metrics logged in this call (one dict per logged
        step, with ``step`` and ``step_time_s``, the wall time per step
        since the previous log, which ends on the device's results)."""
        if self._step is None:
            self.init_state()
        period = max(1, int(self.cfg.TRAIN.LOG_PERIOD))
        logged = []
        t_prev, steps_since = time.perf_counter(), 0
        for step in range(start_step, total_steps):
            batch = self._to_device(next(batches))
            b, h, w, _ = batch["images"].shape
            g = batch["gt_boxes"].shape[1]
            priorities = self.model.make_priorities((b, h, w, g),
                                                    self.generator)
            metrics = self._step(batch, priorities, step)
            steps_since += 1
            if (step + 1) % period == 0 or step + 1 == total_steps:
                row = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                row["step"] = step + 1
                row["step_time_s"] = (now - t_prev) / steps_since
                t_prev, steps_since = now, 0
                if not all(math.isfinite(v) for v in row.values()):
                    log.warning("step %d: non-finite metrics %s", step + 1,
                                row)
                log.info("step %d: %s", step + 1, ", ".join(
                    f"{k} {v:.5g}" for k, v in row.items() if k != "step"))
                logged.append(row)
        return logged
