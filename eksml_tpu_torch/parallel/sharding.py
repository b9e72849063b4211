"""The sharding plan: ``TRAIN.SHARDING.*`` → the mesh and the wrapper the
model trains under (the port of ``eksml_tpu/parallel/sharding.py``:
``STRATEGIES``, ``EXCHANGES``, ``sharding_knobs``, ``plan_mesh``,
``ShardingPlan``, ``tree_bytes_per_device`` and
``publish_state_byte_gauges``).

The reference compiles one XLA program whose shardings the plan names;
the port wraps the module:

- ``replicated`` → ``DistributedDataParallel`` over the default group
  (the flat exchange at any slice count, as the reference's replicated
  mesh has no slice axis); ``TPU.ALLREDUCE_COMBINE_THRESHOLD_BYTES`` is
  DDP's bucket size (the HOROVOD_FUSION_THRESHOLD analogue).
- ``fsdp`` → FSDP2 ``fully_shard`` per ResNet stage, on the FPN, the
  RPN, the box head, the mask head, then the root, over the mesh's
  ``fsdp`` axis; when the mesh has replicas besides (a ``data`` axis
  > 1, or the hierarchical exchange's ``slice`` axis) that is HSDP: a
  2-D (replicate, shard) mesh, the shard group inside one node.

``plan_mesh`` keeps the reference's arithmetic and errors for every
strategy.  The ``tensor`` and ``2d`` strategies (DTensor on the FPN, RPN
and head convolutions) and custom ``TRAIN.SHARDING.RULES`` are not
ported: they raise ``NotImplementedError``, never a quiet replication.
Without a process group the plan runs the plain model, as the
reference runs a 1-device mesh.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from eksml_tpu_torch.config import (SHARDING_DEFAULTS,
                                    SHARDING_ITEM, STRATEGIES,
                                    knobs_with_defaults)
from eksml_tpu_torch.parallel.mesh import divisors as _divisors

log = logging.getLogger(__name__)

#: gradient-exchange layouts across slices (TRAIN.SHARDING.EXCHANGE)
EXCHANGES = ("flat", "hierarchical")

#: the parameter bytes of R50-FPN Mask-RCNN, which size the combine
#: threshold when TPU.ALLREDUCE_COMBINE_THRESHOLD_BYTES is 0 (the
#: reference's figure, eksml_tpu/train.py:319)
MODEL_PARAM_BYTES = 180 * 1024 * 1024


def sharding_knobs(cfg) -> Dict[str, Any]:
    """``TRAIN.SHARDING.*`` values over the canonical defaults."""
    return knobs_with_defaults(
        getattr(getattr(cfg, "TRAIN", None), "SHARDING", None),
        SHARDING_DEFAULTS)


def plan_mesh(cfg, n_devices: Optional[int] = None
              ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``TRAIN.SHARDING.*`` + ``TPU.MESH_*`` → ``(mesh_shape, axes)``,
    the reference's arithmetic and errors: ``replicated`` keeps the
    configured mesh; ``fsdp`` inserts the fsdp axis after ``data``,
    sized by ``FSDP_AXIS_SIZE`` (0 = every device of one slice);
    ``tensor`` sizes the ``model`` axis; ``2d`` both.  Every shard axis
    (and the ``2d`` product) must divide the per-slice device count;
    an explicit ``TPU.MESH_SHAPE`` wins but must name the axes the
    strategy shards over; ``EXCHANGE="hierarchical"`` at
    ``TPU.NUM_SLICES > 1`` adds a leading ``slice`` axis to the sharded
    strategies.  ``n_devices`` defaults to the process group's ranks."""
    knobs = sharding_knobs(cfg)
    strategy = str(knobs["STRATEGY"])
    if strategy not in STRATEGIES:
        raise ValueError(
            f"TRAIN.SHARDING.STRATEGY={strategy!r} is not one of "
            f"{STRATEGIES}")
    exchange = str(knobs.get("EXCHANGE", "flat"))
    if exchange not in EXCHANGES:
        raise ValueError(
            f"TRAIN.SHARDING.EXCHANGE={exchange!r} is not one of "
            f"{EXCHANGES}")
    shape = tuple(int(s) for s in cfg.TPU.MESH_SHAPE)
    axes = tuple(cfg.TPU.MESH_AXES)
    if strategy == "replicated":
        return shape, axes
    needs_fsdp = strategy in ("fsdp", "2d")
    needs_model = strategy in ("tensor", "2d")
    if needs_fsdp and "fsdp" not in axes:
        if shape:
            raise ValueError(
                f"TRAIN.SHARDING.STRATEGY={strategy} needs an 'fsdp' "
                f"mesh axis, but the explicit TPU.MESH_SHAPE={shape} /"
                f" TPU.MESH_AXES={axes} does not name one — add it "
                "(e.g. MESH_AXES=('data','fsdp','model')) or clear "
                "MESH_SHAPE to derive the mesh from the knobs")
        axes = axes[:1] + ("fsdp",) + axes[1:]
    if needs_model and "model" not in axes:
        if shape:
            raise ValueError(
                f"TRAIN.SHARDING.STRATEGY={strategy} needs a 'model' "
                f"mesh axis, but the explicit TPU.MESH_SHAPE={shape} /"
                f" TPU.MESH_AXES={axes} does not name one — add it "
                "(e.g. MESH_AXES=('data','fsdp','model')) or clear "
                "MESH_SHAPE to derive the mesh from the knobs")
        axes = axes + ("model",)
    if shape:
        return shape, axes
    if n_devices:
        n = n_devices
    else:
        from eksml_tpu_torch.parallel.distributed import process_count

        n = process_count()
    num_slices = max(1, int(getattr(cfg.TPU, "NUM_SLICES", 1)))
    if n % num_slices:
        raise ValueError(
            f"{n} device(s) do not split into TPU.NUM_SLICES="
            f"{num_slices}")
    per_slice = n // num_slices
    m = 1
    if needs_model:
        m = int(knobs["MODEL_AXIS_SIZE"])
        if m == 0 and strategy == "tensor":
            m = per_slice
        if m < 1 or per_slice % m:
            raise ValueError(
                f"TRAIN.SHARDING.MODEL_AXIS_SIZE={m} is invalid for "
                f"{n} device(s) in {num_slices} slice(s) ({per_slice} "
                f"per slice): the model axis must divide the per-slice"
                f" device count so weight shards never straddle a DCN "
                f"hop (and the 2d strategy needs it set explicitly, "
                f"> 0); valid sizes here: {_divisors(per_slice)}")
    f = 1
    if needs_fsdp:
        f = int(knobs["FSDP_AXIS_SIZE"]) or per_slice // m
        if f < 1 or per_slice % f:
            raise ValueError(
                f"TRAIN.SHARDING.FSDP_AXIS_SIZE={f} is invalid for {n} "
                f"device(s) in {num_slices} slice(s) ({per_slice} per "
                f"slice): the fsdp axis must divide the per-slice device "
                f"count so parameter shards never straddle a DCN hop; "
                f"valid sizes here: {_divisors(per_slice)}")
    if per_slice % (f * m):
        raise ValueError(
            f"TRAIN.SHARDING.FSDP_AXIS_SIZE={f} x "
            f"TRAIN.SHARDING.MODEL_AXIS_SIZE={m} = {f * m} does not "
            f"divide the per-slice device count ({per_slice}): a 2d "
            f"shard group must fit inside one slice so its collectives "
            f"never straddle a DCN hop; the axis product must be one "
            f"of {_divisors(per_slice)}")
    if exchange == "hierarchical" and num_slices > 1:
        axes = ("slice",) + tuple(a for a in axes if a != "slice")
        return (num_slices,) + tuple(
            per_slice // (f * m) if a == "data"
            else f if a == "fsdp"
            else m if a == "model" else 1
            for a in axes[1:]), axes
    return tuple(n // (f * m) if a == "data"
                 else f if a == "fsdp"
                 else m if a == "model" else 1
                 for a in axes), axes


def _refuse_unported(strategy: str) -> None:
    if strategy in ("tensor", "2d"):
        raise NotImplementedError(
            f"TRAIN.SHARDING.STRATEGY={strategy!r}: tensor parallelism "
            "(DTensor on the FPN, RPN and head convolutions) is not ported "
            f"yet ({SHARDING_ITEM}); use 'replicated' or 'fsdp'")


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t``: the local shard of a DTensor, ``t``
    itself otherwise."""
    return t.to_local() if hasattr(t, "to_local") else t


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes_per_device(tree) -> int:
    """Bytes this rank holds of a nested dict/list of tensors: a
    DTensor's local shard, a plain tensor whole."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(tree))


def publish_state_byte_gauges(params, opt_state) -> Tuple[int, int]:
    """Per-device parameter and optimizer-state bytes → the
    ``eksml_train_param_bytes`` / ``eksml_train_opt_state_bytes``
    gauges.  Returns ``(param_bytes, opt_bytes)``."""
    from eksml_tpu_torch import telemetry

    pb = tree_bytes_per_device(params)
    ob = tree_bytes_per_device(opt_state)
    registry = telemetry.default_registry()
    registry.gauge(
        "eksml_train_param_bytes",
        "per-device parameter bytes under the active sharding "
        "plan").set(float(pb))
    registry.gauge(
        "eksml_train_opt_state_bytes",
        "per-device optimizer-state bytes under the active "
        "sharding plan").set(float(ob))
    return pb, ob


def combine_threshold_bytes(cfg) -> int:
    """``TPU.ALLREDUCE_COMBINE_THRESHOLD_BYTES``, or sized from the
    model's bytes when 0 (the reference's rule)."""
    threshold = int(cfg.TPU.ALLREDUCE_COMBINE_THRESHOLD_BYTES)
    if threshold == 0:
        from eksml_tpu_torch.parallel.collectives import \
            recommend_combine_threshold

        threshold = recommend_combine_threshold(
            MODEL_PARAM_BYTES, max(1, int(cfg.TRAIN.NUM_CHIPS)))
    return threshold


class ShardingPlan:
    """Strategy + mesh → the module the step trains.

    ``mesh`` is the ``DeviceMesh`` of the live process group, or
    ``None`` without one (the plain model, a 1-device plan);
    ``mesh_shape`` / ``mesh_axes`` describe it either way (the
    checkpoint's topology descriptor records them)."""

    def __init__(self, strategy: str, mesh=None,
                 mesh_shape: Sequence[int] = (1, 1),
                 mesh_axes: Sequence[str] = ("data", "model"),
                 exchange: str = "flat",
                 bucket_bytes: int = 64 * 1024 * 1024):
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown sharding strategy {strategy!r}; valid: "
                f"{STRATEGIES} (TRAIN.SHARDING.STRATEGY)")
        _refuse_unported(strategy)
        if exchange not in EXCHANGES:
            raise ValueError(
                f"unknown gradient exchange {exchange!r}; valid: "
                f"{EXCHANGES} (TRAIN.SHARDING.EXCHANGE)")
        self.strategy = strategy
        self.mesh = mesh
        self.exchange = exchange
        self.bucket_bytes = int(bucket_bytes)
        if mesh is not None:
            mesh_shape = tuple(mesh.mesh.shape)
            mesh_axes = tuple(mesh.mesh_dim_names)
        self.mesh_shape = tuple(int(s) for s in mesh_shape)
        self.mesh_axes = tuple(str(a) for a in mesh_axes)
        sizes = dict(zip(self.mesh_axes, self.mesh_shape))
        if strategy == "fsdp" and "fsdp" not in sizes:
            raise ValueError(
                f"sharding strategy 'fsdp' needs an 'fsdp' mesh axis; "
                f"this mesh has {self.mesh_axes} — build it via "
                "plan_mesh(cfg)")
        self.axis_size = int(sizes.get("fsdp", 1))
        self.model_axis_size = int(sizes.get("model", 1))
        self.slice_axis_size = int(sizes.get("slice", 1))
        #: the process group the gradient shards split over (the global
        #: norm sums its local squares there); None: gradients are whole
        self.norm_group = None

    @classmethod
    def from_config(cls, cfg, mesh=None) -> "ShardingPlan":
        """The plan of ``TRAIN.SHARDING.*``.  With a process group up and
        no ``mesh`` given, builds the mesh (a collective: every rank
        calls it) on the group's device type."""
        from eksml_tpu_torch.parallel.distributed import collective_device
        from eksml_tpu_torch.parallel.mesh import (build_mesh,
                                                   check_topology,
                                                   mesh_shape_for)

        k = sharding_knobs(cfg)
        if tuple(k["RULES"] or ()):
            raise NotImplementedError(
                "TRAIN.SHARDING.RULES: custom partition rules are not "
                f"ported yet ({SHARDING_ITEM}); leave RULES=() for the "
                "strategy's default layout")
        strategy = str(k["STRATEGY"])
        _refuse_unported(strategy)      # before any mesh is built
        check_topology(str(getattr(cfg.TPU, "TOPOLOGY", "") or ""))
        num_slices = max(1, int(getattr(cfg.TPU, "NUM_SLICES", 1)))
        shape, axes = plan_mesh(cfg)
        if mesh is None and dist.is_initialized():
            mesh = build_mesh(shape, axes, num_slices,
                              collective_device().type)
        elif mesh is None:
            shape, axes = mesh_shape_for(shape, axes, 1)
        return cls(strategy, mesh, shape, axes,
                   exchange=str(k.get("EXCHANGE", "flat")),
                   bucket_bytes=combine_threshold_bytes(cfg))

    # -- the wrapper ---------------------------------------------------

    def _fsdp_mesh(self):
        """The 1-D shard mesh, or the 2-D (replicate, shard) HSDP mesh
        when other axes hold replicas."""
        from torch.distributed.device_mesh import DeviceMesh

        rep = [a for a, s in zip(self.mesh_axes, self.mesh_shape)
               if a != "fsdp" and s > 1]
        if not rep:
            return self.mesh["fsdp"]
        if len(rep) == 1:
            return self.mesh[(rep[0], "fsdp")]
        # replicas over several axes (slice and data): their product is
        # the replicate dim; slice-major rank order keeps each shard
        # group inside one slice
        return DeviceMesh(self.mesh.device_type,
                          self.mesh.mesh.reshape(-1, self.axis_size),
                          mesh_dim_names=("replicate", "fsdp"))

    def wrap(self, model: nn.Module) -> nn.Module:
        """The module the step calls: ``model`` itself without a group,
        DDP around it under ``replicated``, ``model`` sharded in place
        under ``fsdp`` (its parameters become DTensors; load weights
        before wrapping)."""
        if self.mesh is None:
            return model
        if self.strategy == "replicated":
            from torch.nn.parallel import DistributedDataParallel

            dev = next(model.parameters()).device
            return DistributedDataParallel(
                model, device_ids=[dev.index] if dev.type == "cuda" else None,
                bucket_cap_mb=self.bucket_bytes / 2 ** 20,
                # FrozenBN statistics never change: nothing to broadcast
                broadcast_buffers=False)
        from torch.distributed.fsdp import fully_shard

        mesh = self._fsdp_mesh()
        units = [[getattr(model.backbone, n) for n in names]
                 for names in model.backbone.stage_names]
        units += [getattr(model, n) for n in
                  ("fpn", "rpn", "fastrcnn", "cascade0", "cascade1",
                   "cascade2", "maskrcnn")
                  if hasattr(model, n)]
        for unit in units:
            fully_shard(unit, mesh=mesh)
        fully_shard(model, mesh=mesh)
        self.norm_group = mesh.get_group("fsdp")
        return model

    # -- introspection -------------------------------------------------

    def explain(self, model: nn.Module, title: str = "parameters") -> str:
        """How each parameter and buffer lies on this rank, with its
        per-device bytes."""
        rows = []
        for name, t in model.state_dict().items():
            placement = (str(tuple(t.placements)) if hasattr(t, "placements")
                         else "replicated")
            local = _local(t)
            rows.append((name, placement,
                         local.numel() * local.element_size()))
        width = max((len(r[0]) for r in rows), default=4)
        out = [f"sharding plan '{self.strategy}' over mesh "
               f"{dict(zip(self.mesh_axes, self.mesh_shape))} — {title} "
               f"({len(rows)} tensors):"]
        for name, placement, b in rows:
            out.append(f"  {name:<{width}}  {placement:<24} "
                       f"{b / 2 ** 20:8.2f} MiB/dev")
        return "\n".join(out)

    def describe(self) -> str:
        """One-line summary for logs (the reference's strings)."""
        extra = (f", slices={self.slice_axis_size}, "
                 f"exchange={self.exchange}"
                 if self.slice_axis_size > 1 else "")
        if self.strategy == "fsdp":
            return f"fsdp(axis={self.axis_size}, rules=1{extra})"
        return self.strategy
