"""The sharding plan: ``TRAIN.SHARDING.*`` → the mesh, the partition
rules, and the wrapper the model trains under (the port of
``eksml_tpu/parallel/sharding.py``).

The reference compiles one XLA program whose shardings the plan names;
the port places the module's parameters and wraps it.  Under every
strategy each rank trains on its own images and the forward runs on
whole weights: the strategies change only where parameters and
optimizer state are *stored*, so the losses and the updated parameters
equal the ``replicated`` run's.

- **Partition-rule engine** (the reference's ``TENSOR_TARGETS``,
  ``DEFAULT_RULES``, ``validate_rules``, ``_match_leaf`` and
  ``match_partition_rules``, copied under their names): an ordered list
  of ``(regex, action)`` rules matched with ``re.search`` against the
  ``/``-joined Flax path of each parameter (``convert.flax_path``:
  ``fpn.lateral_2.weight`` is ``fpn/lateral_2/kernel``); the first match
  wins, the last rule must be a catch-all, scalars and one-element
  leaves never shard.  An action is ``replicated``, ``fsdp``,
  ``tensor``, ``2d`` or a literal spec tuple.  The spec is computed in
  the Flax dim order (a literal spec names Flax dims), then mapped onto
  the port's dims (``convert.flax_dims``): the same config gives the
  same logical layout in both packages.
- ``replicated`` → ``DistributedDataParallel`` over the default group;
  ``TPU.ALLREDUCE_COMBINE_THRESHOLD_BYTES`` is DDP's bucket size.
- ``fsdp`` (default rules) → FSDP2 ``fully_shard`` per ResNet stage, on
  the FPN, the RPN, the box head, the mask head, then the root, over the
  mesh's ``fsdp`` axis, each parameter sharded on the dim the rules give
  it (``shard_placement_fn``); when the mesh has replicas besides (a
  ``data`` axis > 1, or the hierarchical exchange's ``slice`` axis)
  that is HSDP.  A leaf the reference replicates because no dim divides
  (or a one-element leaf) is FSDP2's padded dim-0 shard here.
- ``tensor``, ``2d``, and custom ``TRAIN.SHARDING.RULES`` under
  ``fsdp`` → every parameter becomes a DTensor on the plan's whole
  ``DeviceMesh`` with the placements its spec names (``Replicate`` on
  every other mesh axis).  Reading a parameter as a module attribute
  gives the whole weight (``_Whole``: an all-gather of the shards),
  whose backward is the mean over **all** ranks reduced onto the
  parameter's placements (reduce-scatter over its shard axes,
  all-reduce over the rest), so each rank's optimizer updates its
  shards.  Weights are placed from the whole tensor every rank holds
  (``init_params`` or a ``state_dict``): no RNG runs per shard.

Gradients are reduced in the storage dtype (``TRAIN.PARAM_DTYPE``):
under bf16 storage DDP all-reduces bf16 buckets, FSDP2 reduce-scatters
bf16, and ``_Whole`` divides and reduces the bf16 gradient.

Deliberate differences from the reference: the port's optimizer state
follows its parameter (no ``0/trace/...`` momentum paths to match), and
FrozenBN statistics are buffers, which no strategy shards.  ``plan_mesh``
keeps the reference's arithmetic and errors for every strategy.
Without a process group the plan runs the plain model, as the reference
runs a 1-device mesh.
"""

from __future__ import annotations

import logging
import math
import re
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from eksml_tpu_torch.config import (SHARDING_DEFAULTS, STRATEGIES,
                                    knobs_with_defaults)
from eksml_tpu_torch.convert import flax_dims, flax_path
from eksml_tpu_torch.parallel.mesh import divisors as _divisors

log = logging.getLogger(__name__)

#: gradient-exchange layouts across slices (TRAIN.SHARDING.EXCHANGE)
EXCHANGES = ("flat", "hierarchical")

#: the parameter bytes of R50-FPN Mask-RCNN, which size the combine
#: threshold when TPU.ALLREDUCE_COMBINE_THRESHOLD_BYTES is 0 (the
#: reference's figure, eksml_tpu/train.py:319)
MODEL_PARAM_BYTES = 180 * 1024 * 1024


#: rule actions (besides a literal spec tuple)
REPLICATED = "replicated"
FSDP_AUTO = "fsdp"
TENSOR_AUTO = "tensor"   # model axis on the output-feature (last) dim
TWOD_AUTO = "2d"         # model on output features + fsdp elsewhere

#: the tensor-parallel weight targets: FPN lateral/output convs, the
#: shared RPN conv, the box-head fc6/fc7 matmuls (plain and cascade),
#: and the mask-head fcn/deconv stack.  Flax Conv/Dense kernels keep
#: output features LAST, which is the dim the auto actions shard.
TENSOR_TARGETS = (
    r"(fpn/(lateral|posthoc)_\d+"
    r"|rpn/conv0"
    r"|(fastrcnn|cascade\d*)/(fc6|fc7)"
    r"|maskrcnn/(fcn\d+|deconv))/kernel$")

#: strategy-default rule sets (TRAIN.SHARDING.RULES=() selects these)
DEFAULT_RULES: Dict[str, Tuple[Tuple[str, Any], ...]] = {
    "replicated": ((r".*", REPLICATED),),
    "fsdp": ((r".*", FSDP_AUTO),),
    "tensor": (
        (TENSOR_TARGETS, TENSOR_AUTO),
        (r".*", REPLICATED),
    ),
    "2d": (
        (TENSOR_TARGETS, TWOD_AUTO),
        (r".*", FSDP_AUTO),
    ),
}

# two probes approximating "matches any path": a last rule that misses
# either is not a catch-all
_CATCHALL_PROBES = ("zz9/plural/z/alpha", "leaf")

#: a spec: one entry per leading dim (trailing whole dims dropped), each
#: None, a mesh axis name, or a tuple of axis names (major first)
Spec = Tuple[Any, ...]


def validate_rules(rules) -> Tuple[Tuple[str, Any], ...]:
    """Normalize + validate an ordered rule list.

    Each rule is ``(pattern, action)`` with action one of
    ``"replicated"``, ``"fsdp"``, ``"tensor"``, ``"2d"``, or a tuple
    of spec entries (``None`` / axis name / tuple of axis names).  The
    last rule must be a catch-all — every leaf must be *claimed*, never
    defaulted."""
    try:
        rules = tuple(
            (str(p), a if isinstance(a, str) else tuple(a))
            for p, a in rules)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"partition rules must be (pattern, action) pairs, got "
            f"{rules!r}") from e
    if not rules:
        raise ValueError(
            "partition rules are empty — need at least a catch-all "
            "like ('.*', 'replicated')")
    for pat, action in rules:
        try:
            re.compile(pat)
        except re.error as e:
            raise ValueError(
                f"partition rule pattern {pat!r} is not a valid "
                f"regex: {e}") from e
        if isinstance(action, str):
            if action not in (REPLICATED, FSDP_AUTO, TENSOR_AUTO,
                              TWOD_AUTO):
                raise ValueError(
                    f"partition rule {pat!r}: string action must be "
                    f"'replicated', 'fsdp', 'tensor' or '2d', got "
                    f"{action!r}")
        else:
            for entry in action:
                ok = entry is None or isinstance(entry, str) or (
                    isinstance(entry, tuple)
                    and all(isinstance(x, str) for x in entry))
                if not ok:
                    raise ValueError(
                        f"partition rule {pat!r}: spec entry "
                        f"{entry!r} must be None, an axis name, or a "
                        "tuple of axis names")
    last = rules[-1][0]
    if not all(re.search(last, probe) for probe in _CATCHALL_PROBES):
        raise ValueError(
            f"partition rules must end with a catch-all pattern that "
            f"claims every remaining leaf (e.g. ('.*', 'replicated')); "
            f"the last rule {last!r} does not match everything")
    return rules


def _auto_axis_dim(shape: Tuple[int, ...], axis_size: int,
                   exclude: Tuple[int, ...] = ()) -> Optional[int]:
    """Index of the largest dim divisible by ``axis_size`` (ties →
    lowest index), skipping ``exclude``; None when nothing divides
    (caller replicates that axis)."""
    order = sorted((i for i in range(len(shape)) if i not in exclude),
                   key=lambda i: (-shape[i], i))
    for i in order:
        if shape[i] >= axis_size and shape[i] % axis_size == 0:
            return i
    return None


def _spec_from_entries(entries: List[Any]) -> Spec:
    # trailing Nones dropped: ('fsdp',) is the canonical form
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _match_leaf(path: str, leaf, rules, mesh_axes: Dict[str, int],
                fsdp_axis: str, model_axis: str) -> Tuple[Spec, str]:
    """→ (spec, why) for one leaf in its Flax layout.  ``why`` names the
    rule (or guard) that claimed it — the explain() payload."""
    shape = tuple(getattr(leaf, "shape", ()))
    fsdp_size = int(mesh_axes.get(fsdp_axis, 1))
    model_size = int(mesh_axes.get(model_axis, 1))
    if len(shape) == 0 or math.prod(shape) == 1:
        return (), "(scalar)"
    for pat, action in rules:
        if re.search(pat, path) is None:
            continue
        if action == REPLICATED:
            return (), pat
        if action == FSDP_AUTO:
            dim = _auto_axis_dim(shape, fsdp_size)
            if dim is None:
                return (), f"{pat} (no dim divisible by " \
                           f"{fsdp_axis}={fsdp_size}; replicated)"
            entries: List[Any] = [None] * len(shape)
            entries[dim] = fsdp_axis
            return _spec_from_entries(entries), pat
        if action in (TENSOR_AUTO, TWOD_AUTO):
            # output features are LAST in Flax Conv/Dense kernels
            entries = [None] * len(shape)
            last = len(shape) - 1
            if shape[last] >= model_size and shape[last] % model_size == 0:
                entries[last] = model_axis
            if action == TWOD_AUTO:
                dim = _auto_axis_dim(
                    shape, fsdp_size,
                    exclude=(last,) if entries[last] else ())
                if dim is not None:
                    entries[dim] = fsdp_axis
            if all(e is None for e in entries):
                return (), (f"{pat} (no dim divisible by "
                            f"{model_axis}={model_size}"
                            + (f"/{fsdp_axis}={fsdp_size}"
                               if action == TWOD_AUTO else "")
                            + "; replicated)")
            return _spec_from_entries(entries), pat
        # literal spec tuple
        if len(action) > len(shape):
            raise ValueError(
                f"partition rule {pat!r} spec {action!r} has "
                f"{len(action)} entries but {path!r} has rank "
                f"{len(shape)} (shape {shape})")
        for dim, entry in enumerate(action):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            div = 1
            for a in axes:
                if a not in mesh_axes:
                    raise ValueError(
                        f"partition rule {pat!r} names mesh axis "
                        f"{a!r} but the mesh has axes "
                        f"{tuple(mesh_axes)}")
                div *= mesh_axes[a]
            if shape[dim] % div:
                raise ValueError(
                    f"partition rule {pat!r}: {path!r} dim {dim} "
                    f"(size {shape[dim]}) does not divide over "
                    f"{entry!r} (axis size {div})")
        return tuple(action), pat
    raise ValueError(
        f"no partition rule matched leaf {path!r} — the rule list "
        "must end with a catch-all like ('.*', 'replicated')")


def match_partition_rules(rules, tree, mesh_axes: Dict[str, int],
                          fsdp_axis: str = "fsdp",
                          model_axis: str = "model") -> Dict[str, Spec]:
    """``{path: spec}`` of a flat ``{flax path: leaf}`` mapping from
    ordered rules (first match wins); ``mesh_axes`` maps each mesh axis
    to its size.  Raises on an unclaimed leaf; pre-validate with
    :func:`validate_rules` for the friendlier catch-all error."""
    return {path: _match_leaf(path, leaf, rules, mesh_axes, fsdp_axis,
                              model_axis)[0]
            for path, leaf in tree.items()}


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


@dataclass(frozen=True)
class Layout:
    """Where one of the port's tensors lies under a plan.  ``spec`` and
    ``why`` are the rule engine's, in the Flax dims; ``dims`` gives, for
    each of the port's dims, the mesh axes it is split over (``()``:
    whole); ``local_shape`` is what each rank allocates for it (under
    default ``fsdp``, where the rules replicate a leaf, FSDP2's dim-0 shard
    padded to ``ceil(dim / fsdp)``; each rank holds its ``torch.chunk`` of
    the dim in it)."""

    path: str
    spec: Spec
    why: str
    dims: Tuple[Tuple[str, ...], ...]
    local_shape: Tuple[int, ...]


def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's part of ``full`` under ``placements`` on ``mesh``
    (DTensor's order: each mesh dim splits what the dims before it
    left, as ``torch.chunk`` does, trailing ranks possibly empty)."""
    coord = mesh.get_coordinate()
    for i, placement in enumerate(placements):
        if placement.is_shard():
            chunks = torch.chunk(full, mesh.size(i), dim=placement.dim)
            full = (chunks[coord[i]] if coord[i] < len(chunks)
                    else full.narrow(placement.dim, 0, 0))
    return full


class _Whole(torch.autograd.Function):
    """A parameter's local shard → the whole weight (an all-gather over
    its shard axes).  The backward is the mean of every rank's gradient
    of the whole weight, reduced onto the parameter's placements:
    divided by the world size, then summed by a reduce-scatter over the
    shard axes and an all-reduce over the others (a DTensor ``Partial``
    redistributed), so each rank gets its shard of the global mean."""

    @staticmethod
    def forward(ctx, local, mesh, placements):
        from torch.distributed.tensor import DTensor

        ctx.mesh, ctx.placements = mesh, placements
        if not any(p.is_shard() for p in placements):
            return local.view_as(local)
        return DTensor.from_local(local, mesh, placements,
                                  run_check=False).full_tensor()

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial

        mesh, placements = ctx.mesh, ctx.placements
        n = mesh.size()
        if n == 1:
            return grad, None, None
        grad = grad / n
        if not any(p.is_shard() for p in placements):
            # every rank holds the whole parameter: one all-reduce
            grad = grad.contiguous()
            dist.all_reduce(grad)
            return grad, None, None
        partial = DTensor.from_local(grad, mesh, [Partial()] * mesh.ndim,
                                     run_check=False)
        return partial.redistribute(mesh, placements).to_local(), None, None


def _whole_param(p: torch.Tensor) -> torch.Tensor:
    return _Whole.apply(p.to_local(), p.device_mesh, tuple(p.placements))


_GATHERING: Dict[Tuple[type, Tuple[str, ...]], type] = {}


def _gathering_class(cls: type, names: Tuple[str, ...]) -> type:
    """``cls`` with a property per parameter name that reads the whole
    weight (:func:`_whole_param`) wherever the model reads the
    attribute: its own forward, a parent's ``child.weight``, and
    REMAT's recompute alike.  ``named_parameters``, ``state_dict`` and
    the optimizer keep the DTensor in ``_parameters``."""
    key = (cls, names)
    if key not in _GATHERING:
        props = {n: property(lambda self, n=n: _whole_param(
            self._parameters[n])) for n in names}
        _GATHERING[key] = type(cls.__name__, (cls,), props)
    return _GATHERING[key]


class ShardingPlan:
    """Strategy + rules + mesh → where each parameter lies and the
    module the step trains.

    ``mesh`` is the ``DeviceMesh`` of the live process group, or
    ``None`` without one (the plain model, a 1-device plan);
    ``mesh_shape`` / ``mesh_axes`` describe it either way (the
    checkpoint's topology descriptor records them, and :meth:`layout`
    reads them, so a plan without a group still says where each
    parameter would lie)."""

    def __init__(self, strategy: str, mesh=None,
                 mesh_shape: Sequence[int] = (1, 1),
                 mesh_axes: Sequence[str] = ("data", "model"),
                 exchange: str = "flat",
                 bucket_bytes: int = 64 * 1024 * 1024, rules=()):
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown sharding strategy {strategy!r}; valid: "
                f"{STRATEGIES} (TRAIN.SHARDING.STRATEGY)")
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
        for needs, axis, which in ((("fsdp", "2d"), "fsdp", "an"),
                                   (("tensor", "2d"), "model", "a")):
            if strategy in needs and axis not in sizes:
                raise ValueError(
                    f"sharding strategy {strategy!r} needs {which} "
                    f"{axis!r} mesh axis; this mesh has {self.mesh_axes}"
                    " — build it via plan_mesh(cfg)")
        self.axis_size = int(sizes.get("fsdp", 1))
        self.model_axis_size = int(sizes.get("model", 1))
        self.slice_axis_size = int(sizes.get("slice", 1))
        #: custom TRAIN.SHARDING.RULES given (else the strategy's own)
        self.custom_rules = bool(tuple(rules or ()))
        self.rules = validate_rules(rules or DEFAULT_RULES[strategy])

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
        rules = tuple(tuple(r) for r in (k["RULES"] or ()))
        strategy = str(k["STRATEGY"])
        if rules:       # before any mesh is built
            validate_rules(rules)
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
                   bucket_bytes=combine_threshold_bytes(cfg), rules=rules)

    # -- placement -----------------------------------------------------

    @property
    def uses_fsdp2(self) -> bool:
        """Default ``fsdp`` runs under FSDP2; ``tensor``, ``2d`` and
        custom rules under ``fsdp`` place DTensors themselves."""
        return self.strategy == "fsdp" and not self.custom_rules

    def layout(self, name: str, shape: Sequence[int],
               parameter: bool = True) -> Layout:
        """Where the port's tensor ``name`` of ``shape`` lies: the rules
        match its Flax path and place its Flax dims, then the spec is
        mapped onto the port's dims.  Buffers (``parameter=False``, the
        FrozenBN statistics) and every tensor under ``replicated`` stay
        whole."""
        shape = tuple(int(d) for d in shape)
        path = flax_path(name)
        whole = tuple(() for _ in shape)
        if self.strategy == "replicated" or not parameter:
            why = "(strategy: replicated)" if parameter else "(buffer)"
            return Layout(path, (), why, whole, shape)
        perm = flax_dims(name, len(shape))
        flax_shape = [0] * len(shape)
        for i, d in enumerate(perm):
            flax_shape[d] = shape[i]
        flax_shape = tuple(flax_shape)
        sizes = dict(zip(self.mesh_axes, self.mesh_shape))
        spec, why = _match_leaf(path, SimpleNamespace(shape=flax_shape),
                                self.rules, sizes, "fsdp", "model")
        entries = list(spec) + [None] * (len(shape) - len(spec))
        dims = tuple(() if entries[d] is None else
                     ((entries[d],) if isinstance(entries[d], str)
                      else tuple(entries[d])) for d in perm)
        used = [a for axes in dims for a in axes]
        if len(used) != len(set(used)):
            raise ValueError(
                f"partition rule {why!r} puts a mesh axis on two dims of "
                f"{path!r}: {spec!r}")
        if self.uses_fsdp2:
            # FSDP2 shards one dim over the fsdp axis: the rules' dim, or
            # its padded dim 0 where the rules replicate the leaf
            f = self.axis_size
            dim = next((i for i, axes in enumerate(dims) if axes), 0)
            local = list(shape)
            if shape:
                local[dim] = -(-shape[dim] // f)
            dims = tuple(("fsdp",) if i == dim else ()
                         for i in range(len(shape)))
            return Layout(path, spec, why, dims, tuple(local))
        local = tuple(d // math.prod(sizes[a] for a in axes)
                      for d, axes in zip(shape, dims))
        return Layout(path, spec, why, dims, local)

    def placements(self, layout: Layout):
        """The DTensor placements of ``layout`` on the plan's mesh: each
        mesh axis of size > 1 that splits a dim is ``Shard(dim)`` (axes
        of one dim split in mesh order), every other ``Replicate``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis, size in zip(self.mesh_axes, self.mesh_shape):
            dim = next((i for i, axes in enumerate(layout.dims)
                        if axis in axes), None)
            out.append(Shard(dim) if dim is not None and size > 1
                       else Replicate())
        return tuple(out)

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
        otherwise (its parameters become DTensors; load weights before
        wrapping)."""
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
        if not self.uses_fsdp2:
            return self._place(model)
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        dims = {}
        for name, p in model.named_parameters():
            lay = self.layout(name, p.shape)
            dims[id(p)] = Shard(next(i for i, axes in enumerate(lay.dims)
                                     if axes)) if p.dim() else None

        def placement(p):
            return dims.get(id(p))

        mesh = self._fsdp_mesh()
        units = [[getattr(model.backbone, n) for n in names]
                 for names in model.backbone.stage_names]
        units += [getattr(model, n) for n in
                  ("fpn", "rpn", "fastrcnn", "cascade0", "cascade1",
                   "cascade2", "maskrcnn")
                  if hasattr(model, n)]
        for unit in units:
            fully_shard(unit, mesh=mesh, shard_placement_fn=placement)
        fully_shard(model, mesh=mesh, shard_placement_fn=placement)
        return model

    @torch.no_grad()
    def _place(self, model: nn.Module) -> nn.Module:
        """Every parameter of ``model`` → a DTensor on the plan's mesh
        holding this rank's part of the whole tensor, and each module
        that owns one reads its whole weight (:func:`_gathering_class`)."""
        from torch.distributed.tensor import DTensor

        for prefix, module in model.named_modules():
            names = tuple(n for n, p in module._parameters.items()
                          if p is not None)
            if not names:
                continue
            for n in names:
                p = module._parameters[n]
                full = f"{prefix}.{n}" if prefix else n
                placements = self.placements(self.layout(full, p.shape))
                local = local_chunk(p.detach(), self.mesh,
                                    placements).contiguous().clone()
                module._parameters[n] = nn.Parameter(
                    DTensor.from_local(local, self.mesh, placements,
                                       run_check=False),
                    requires_grad=p.requires_grad)
            module.__class__ = _gathering_class(type(module), names)
        return model

    # -- introspection -------------------------------------------------

    def explain(self, model: nn.Module, title: str = "parameters") -> str:
        """Which rule claimed each tensor of ``model``: its Flax path, its
        spec in the Flax dims, the port's dims that mesh axes of size > 1
        split (``replicated``: none), its bytes per device, and the rule
        (the reference's ``explain``)."""
        params = {n for n, _ in model.named_parameters()}
        sizes = dict(zip(self.mesh_axes, self.mesh_shape))
        rows = []
        for name, t in model.state_dict().items():
            lay = self.layout(name, t.shape, name in params)
            split = ",".join(
                f"{d}:{'*'.join(a for a in axes if sizes[a] > 1)}"
                for d, axes in enumerate(lay.dims)
                if any(sizes[a] > 1 for a in axes))
            nbytes = math.prod(lay.local_shape) * t.element_size()
            rows.append((lay.path, str(lay.spec), split or "replicated",
                         nbytes, lay.why))
        width = max((len(r[0]) for r in rows), default=4)
        out = [f"sharding plan '{self.strategy}' over mesh "
               f"{dict(zip(self.mesh_axes, self.mesh_shape))} — {title} "
               f"({len(rows)} tensors):"]
        for path, spec, split, b, why in rows:
            out.append(f"  {path:<{width}}  {spec:<24} {split:<12} "
                       f"{b / 2 ** 20:8.2f} MiB/dev  <- {why}")
        return "\n".join(out)

    def describe(self) -> str:
        """One-line summary for logs (the reference's strings)."""
        extra = (f", slices={self.slice_axis_size}, "
                 f"exchange={self.exchange}"
                 if self.slice_axis_size > 1 else "")
        if self.strategy == "fsdp":
            return (f"fsdp(axis={self.axis_size}, "
                    f"rules={len(self.rules)}{extra})")
        if self.strategy == "tensor":
            return (f"tensor(model={self.model_axis_size}, "
                    f"rules={len(self.rules)}{extra})")
        if self.strategy == "2d":
            return (f"2d(fsdp={self.axis_size}, "
                    f"model={self.model_axis_size}, "
                    f"rules={len(self.rules)}{extra})")
        return self.strategy
