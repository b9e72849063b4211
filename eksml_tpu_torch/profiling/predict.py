"""The H100 roofline of the port's step: counted operations → predicted
step time in ms (the counterpart of ``eksml_tpu/profiling/predict.py``).

The reference lowers its train step ahead of time and prices XLA's
compiled HLO.  The port has no HLO, so it counts the step it actually
runs: :func:`count_train_step` and :func:`count_predict_step` run one
real step under :class:`StepCounter`, a ``TorchDispatchMode`` that
records, for every aten operation dispatched on the step's device:

- its FLOPs: ``torch.utils.flop_counter``'s formulas for convolutions and
  matrix products (a multiply-add is 2), otherwise one per output
  element, as the reference's ``_modeled_flops``;
- its bytes: each input and output storage once (the smaller of the
  storage and the elements the operation's tensors span), nothing for a
  view or an ``empty``;
- its dtype, and its component: the reference's ``SCOPE_RULES`` over the
  ``named_scope`` names open on its thread (``profiling/scopes.py``).
  A backward operation takes ``transpose(<path>)`` of the forward
  operation that made its autograd node, found by the node's sequence
  number (the join ``profiling/attribution.py`` makes in a capture), so
  ``backbone`` becomes ``backbone-bwd``.  REMAT's recompute runs in the
  backward too: it is tallied there and also apart
  (``recompute_flops``);
- each storage's allocation and release, for the liveness peak of
  ``profiling/memory.py`` (:func:`analyze_memory`).

The ROIAlign kernels launch through ctypes, out of the dispatcher's
sight; their wrappers hand each call to the counter
(``scopes.counted_call``), which counts it once from the closed form the
kernel phase's bounds use (:func:`bytes_and_ops`) and none of the
operations inside, so the count is the same on the CPU (plain versions)
and on the card.  Collectives are priced once, from the plan
(:func:`plan_collectives`: DDP's reducer calls NCCL from C++ and is never
dispatched), never from what the counter sees.

:func:`predict_from_counts` prices every operation at ``max(flops /
peak, bytes / hbm)``: convolutions and matrix products in bfloat16 at
the tensor cores' 989e12 FLOP/s, in float32 (TF32 off, ``device.py``)
and everything else at 67e12; the ROIAlign calls as ``bound_of``.  It
returns the keys of the reference's ``predict_from_hlo``.
:func:`predict_for_step` is the one pricing path of the trainer's gauge
(``eksml_train_predicted_step_time_ms``) and of ``tools/bench.py``.

The pure parts (collective pricing, the comparison and the calibration)
are the reference's functions, copied.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import json
import logging
import math
import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from eksml_tpu_torch.profiling import scopes
from eksml_tpu_torch.profiling.attribution import resolve_component

log = logging.getLogger(__name__)

#: the gauge Trainer.fit publishes at the first step — ONE definition for
#: trainer and tests
PREDICTED_GAUGE = "eksml_train_predicted_step_time_ms"

# Spec table of the roofline terms, from the NVIDIA H100 SXM5 data sheet
# (dense, at the 700 W limit).  bfloat16 is the tensor cores' peak;
# float32 is the CUDA cores' FFMA peak, because the port runs true
# float32 (TF32 off, device.py).  The link keys keep the reference's
# names: "ici" is NVLink 4 inside a node (900 GB/s per GPU, 450 GB/s each
# way), "dcn" the network between nodes, here a p5.48xlarge's 3200 Gbps
# of EFA shared by its 8 GPUs (400 Gbps = 50 GB/s per GPU).
CHIP_SPECS: Dict[str, Dict[str, Any]] = {
    "h100": {
        "peak_flops": {"bfloat16": 989e12, "float16": 989e12,
                       "float32": 67e12},
        "hbm_bytes_per_sec": 3.35e12,
        "ici_bytes_per_sec": 450e9,
        "dcn_bytes_per_sec": 50e9,
        "hbm_bytes": 80e9,
    },
}

# torch.cuda.get_device_name() → spec name.  Only the SXM part: the PCIe
# and NVL parts have other peaks, and an unmapped name resolves to None.
DEVICE_KIND_TO_TARGET = {
    "NVIDIA H100 80GB HBM3": "h100",
}

DEFAULT_TARGET = "h100"

# the data-sheet rates the kernel phase's bounds and the ROIAlign calls
# of the roofline are priced at
HBM_BYTES_PER_S = CHIP_SPECS["h100"]["hbm_bytes_per_sec"]
F32_FLOPS_PER_S = CHIP_SPECS["h100"]["peak_flops"]["float32"]


def load_json(path: str) -> Optional[Dict]:
    """Swallow-errors JSON loader (a missing or truncated artifact reads
    as absent, never a crash)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def chip_spec(target: str) -> Dict[str, Any]:
    if target not in CHIP_SPECS:
        raise ValueError(
            f"unknown target {target!r}; known: {sorted(CHIP_SPECS)}")
    return CHIP_SPECS[target]


def target_for_device_kind(kind: Optional[str]) -> Optional[str]:
    return DEVICE_KIND_TO_TARGET.get(kind or "")


# ---- collective pricing (the reference's functions) ----------------


def _ring_factor(opcode: str, k: int) -> float:
    """Fraction of the payload each link carries in a ring schedule of
    ``k`` participants.  k=1 → 0 (no traffic)."""
    if k <= 1:
        return 0.0
    if opcode.startswith("all-reduce"):
        return 2.0 * (k - 1) / k
    if opcode.startswith("collective-permute"):
        return 1.0
    # all-gather / reduce-scatter / all-to-all
    return float(k - 1) / k


def hierarchical_allreduce_split(nbytes: float, k: int,
                                 slice_devices: int,
                                 ici: float, dcn: float
                                 ) -> Tuple[float, float]:
    """The three-phase hierarchical all-reduce price split by link:
    → (ici_seconds, dcn_seconds)."""
    per = max(1, int(slice_devices))
    s = max(1, int(k) // per)
    rs = nbytes * _ring_factor("reduce-scatter", per) / ici
    ar = (nbytes / per) * _ring_factor("all-reduce", s) / dcn
    ag = nbytes * _ring_factor("all-gather", per) / ici
    return rs + ag, ar


def hierarchical_allreduce_seconds(nbytes: float, k: int,
                                   slice_devices: int,
                                   ici: float, dcn: float) -> float:
    """Three-phase price of one cross-node gradient all-reduce:
    reduce-scatter inside a node, all-reduce of the 1/per-sized partials
    across nodes, all-gather back inside the node."""
    ici_s, dcn_s = hierarchical_allreduce_split(
        nbytes, k, slice_devices, ici, dcn)
    return ici_s + dcn_s


def _group_topology(groups, slice_devices
                    ) -> Tuple[str, int, int, int]:
    """Exact groups → (link, k, ns, per): ``ici`` when every group stays
    within one node (``device // slice_devices``), ``dcn`` when groups
    straddle nodes with one device per node, ``mixed`` otherwise."""
    k = max((len(g) for g in groups), default=1)
    if not slice_devices or int(slice_devices) <= 0:
        return "ici", k, 1, k
    per_slice = int(slice_devices)
    ns, max_per, straddles = 1, 1, False
    for g in groups:
        counts: Dict[int, int] = {}
        for d in g:
            s = int(d) // per_slice
            counts[s] = counts.get(s, 0) + 1
        if counts:
            ns = max(ns, len(counts))
            max_per = max(max_per, max(counts.values()))
        if len(counts) > 1:
            straddles = True
    if not straddles:
        return "ici", k, 1, k
    if max_per == 1:
        return "dcn", k, ns, 1
    return "mixed", k, ns, max(1, k // ns)


def price_collective(opcode: str, nbytes: float, groups,
                     slice_devices: Optional[int],
                     ici: float, dcn: float,
                     exchange: str = "flat"
                     ) -> Tuple[float, float, float, str, int]:
    """ONE collective's exact-group price →
    (seconds, ici_seconds, dcn_seconds, link, group_size)."""
    link, k, ns, per = _group_topology(groups, slice_devices)
    if link == "ici":
        t = nbytes * _ring_factor(opcode, k) / ici
        return t, t, 0.0, link, k
    if link == "dcn":
        t = nbytes * _ring_factor(opcode, k) / dcn
        return t, 0.0, t, link, k
    if exchange == "hierarchical":
        if opcode.startswith("all-reduce"):
            ici_s, dcn_s = hierarchical_allreduce_split(
                nbytes, k, per, ici, dcn)
        else:
            ici_s = nbytes * _ring_factor(opcode, per) / ici
            dcn_s = (nbytes / per) * _ring_factor(opcode, ns) / dcn
        return ici_s + dcn_s, ici_s, dcn_s, link, k
    t = nbytes * _ring_factor(opcode, k) / dcn
    return t, 0.0, t, link, k


def comm_sizes_for_mesh(mesh_shape: Dict[str, int]) -> Dict[str, int]:
    """Sharding-plan mesh → per-collective participant counts."""
    fsdp = int(mesh_shape.get("fsdp", 1))
    data = int(mesh_shape.get("data", 1))
    model = int(mesh_shape.get("model", 1))
    slices = int(mesh_shape.get("slice", 1))
    return {
        "all-gather": fsdp * model,
        "reduce-scatter": fsdp * model,
        "all-reduce": data * fsdp * model * slices,
        "collective-permute": 2,
        "all-to-all": max(data * fsdp * model * slices, 1),
    }


def section_of(component: str) -> str:
    """Component → fwd/bwd/comms/optimizer bucket (the headline split).
    Unresolved "other" cost rides fwd."""
    if component == "allreduce":
        return "comms"
    if component == "optimizer":
        return "optimizer"
    if component.endswith("-bwd"):
        return "bwd"
    return "fwd"


# ---- the ROIAlign kernels' closed form ------------------------------


def fpn_levels(rois: np.ndarray, n_levels: int) -> np.ndarray:
    """Level index (0 = P2) of each ROI of ``rois`` [..., 4] by the
    kernels' FPN rule over ``n_levels`` levels."""
    from eksml_tpu_torch.ops.roi_align import assign_fpn_levels

    lv = assign_fpn_levels(torch.from_numpy(rois.reshape(-1, 4)),
                           max_level=1 + n_levels).numpy() - 2
    return lv.reshape(rois.shape[:-1])


def roi_footprint(roi: np.ndarray, out_size: int, sampling: int, hw,
                  stride: int):
    """(rows, columns) of one ROI on its level's map of size ``hw`` =
    (H, W) at ``stride``: the map rows and columns that a tap of nonzero
    weight of its samples reaches inside the map, sorted, each at most
    2·out·s long, in the kernels' float32 arithmetic.  The backward
    changes exactly the pixels rows × columns; the footprint design
    issues one reduction per such pixel and channel group."""
    x1, y1, x2, y2 = np.asarray(roi, np.float32) * np.float32(1.0 / stride)
    frac = ((np.arange(sampling, dtype=np.float32) + np.float32(0.5))
            / np.float32(sampling))
    grid = (np.arange(out_size, dtype=np.float32)[:, None]
            + frac[None, :]).reshape(-1)

    def axis(lo, hi, n):
        size = max(hi - lo, np.float32(1e-4)) / np.float32(out_size)
        v = (lo - np.float32(0.5)) + grid * size
        v0 = np.floor(v)
        w1 = v - v0
        w0 = np.float32(1.0) - w1
        pix = np.concatenate([v0[w0 != 0], (v0 + 1)[w1 != 0]])
        return np.unique(pix[(pix >= 0) & (pix <= n - 1)]).astype(np.int64)

    return axis(y1, y2, hw[0]), axis(x1, x2, hw[1])


def footprints(rois: np.ndarray, out_size: int, sampling: int, sizes,
               strides):
    """(image, level index, rows, columns) of every ROI of ``rois``
    [B, N, 4] on the levels ``sizes`` [(H, W), ...] at ``strides``."""
    levels = fpn_levels(rois, len(strides))
    return [(bi, lv, *roi_footprint(rois[bi, ri], out_size, sampling,
                                    sizes[lv], strides[lv]))
            for bi in range(rois.shape[0]) for ri in range(rois.shape[1])
            for lv in [levels[bi, ri]]]


def touched_pixels(rois: np.ndarray, out_size: int, sampling: int,
                   sizes, strides) -> int:
    """Map pixels (per channel) that the taps of a multilevel ROIAlign
    call on ``rois`` [B, N, 4] touch with nonzero weight at least once,
    counted on this data; the levels are ``sizes`` [(H, W), ...] at
    ``strides``."""
    touched = [[np.zeros(hw, bool) for hw in sizes]
               for _ in range(rois.shape[0])]
    for bi, lv, rows, cols in footprints(rois, out_size, sampling, sizes,
                                         strides):
        touched[bi][lv][np.ix_(rows, cols)] = True
    return sum(int(t.sum()) for per_b in touched for t in per_b)


def bytes_and_ops(rois: np.ndarray, out_size: int, sampling: int,
                  esize: int, backward: bool = False, *, sizes, strides,
                  channels: int):
    """Least bytes and the operations (a multiply and an add per tap per
    channel) of one multilevel ROIAlign call on ``rois`` [B, N, 4] over
    levels ``sizes`` [(H, W), ...] at ``strides`` with ``channels``
    channels.  Forward: each map pixel the taps touch, read once, plus
    the output written once, in the map's dtype.  Backward: the output
    gradient read once in its dtype, plus each touched accumulator pixel
    read and written once in float32."""
    b, n = rois.shape[:2]
    pixels = touched_pixels(rois, out_size, sampling, sizes, strides)
    out_elems = b * n * out_size * out_size * channels
    if backward:
        nbytes = out_elems * esize + pixels * channels * 4 * 2
    else:
        nbytes = pixels * channels * esize + out_elems * esize
    ops = out_elems * sampling * sampling * 4 * 2
    return nbytes, ops


def bound_of(nbytes: int, ops: int):
    """(bound ms, what bounds it) on the data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_cost(kind: str, args: Sequence, result) -> Tuple[int, int]:
    """(bytes, operations) of one call of a hand-written kernel's wrapper
    with ``args`` that returned ``result``: the kernel phase's closed
    form."""
    if kind == "copy_to_global":
        return 2 * result.numel() * result.element_size(), 0
    if kind == "roi_align_fwd":
        feats, rois, strides, out_size, sampling = args[:5]
        esize, chan = feats[0].element_size(), feats[0].shape[-1]
        levels, backward = feats, False
    elif kind == "roi_align_bwd":
        levels, rois, g, strides, out_size, sampling = args[:6]
        esize, chan, backward = g.element_size(), g.shape[-1], True
    else:
        raise ValueError(f"no closed form for kernel {kind!r}")
    rois_np = rois.detach().float().cpu().numpy()
    return bytes_and_ops(rois_np, out_size, sampling, esize, backward,
                         sizes=[tuple(t.shape[1:3]) for t in levels],
                         strides=tuple(strides), channels=int(chan))


# ---- the counting pass ----------------------------------------------

#: op kinds of a record: a convolution or matrix product (priced at the
#: tensor cores in bfloat16), a hand-written kernel's call, any other
#: operation, a copy between devices, a collective (priced from the plan
#: instead)
MATMUL, KERNEL, OP, TRANSFER, COLLECTIVE = (
    "matmul", "kernel", "op", "transfer", "collective")
_EMPTY_OPS = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                        "new_empty_strided"))
_NO_NODE_SEQ = 1 << 63
# (outputs, arguments) left out of an op's count by position: the CPU
# kernel's scratch buffer of log_sigmoid, which the CUDA kernel leaves
# empty (the count models the card, and is the same on both devices)
_HOST_SCRATCH = {
    "aten.log_sigmoid_forward.default": ((1,), ()),
    "aten.log_sigmoid_forward.output": ((1,), ()),
    "aten.log_sigmoid_backward.default": ((), (2,)),
    "aten.log_sigmoid_backward.grad_input": ((), (2,)),
}
try:
    from torch.utils.flop_counter import flop_registry as _FLOP_REGISTRY
except ImportError:  # pragma: no cover — every supported torch has it
    _FLOP_REGISTRY = {}


class OpRecord:
    """One counted operation."""

    __slots__ = ("name", "kind", "component", "dtype", "flops", "bytes",
                 "backward", "recompute")

    def __init__(self, name, kind, component, dtype, flops, nbytes,
                 backward, recompute):
        self.name = name
        self.kind = kind
        self.component = component
        self.dtype = dtype
        self.flops = flops
        self.bytes = nbytes
        self.backward = backward
        self.recompute = recompute


class Allocation:
    """One storage a counted operation created: its bytes, the index of
    the operation that made it and of the first operation after its
    release (None: alive at the end)."""

    __slots__ = ("nbytes", "op_index", "freed_at", "component", "op",
                 "shape", "dtype", "ref")

    def __init__(self, nbytes, op_index, component, op, shape, dtype):
        self.nbytes = nbytes
        self.op_index = op_index
        self.freed_at = None
        self.component = component
        self.op = op
        self.shape = shape
        self.dtype = dtype
        self.ref = None


class StepCounts:
    """What one counted step did: ``ops`` (:class:`OpRecord`),
    ``allocations`` (:class:`Allocation`), ``resident`` (bytes by label
    of the storages that existed before the step: ``params``,
    ``optimizer``, ``batch``, ``resident`` for the rest), ``timeline``
    (bytes the step had allocated and not released, right after each
    operation), and ``meta`` (the step's geometry and state bytes)."""

    def __init__(self, ops, allocations, resident, timeline, meta):
        self.ops: List[OpRecord] = ops
        self.allocations: List[Allocation] = allocations
        self.resident: Dict[str, int] = resident
        self.timeline: List[int] = timeline
        self.meta: Dict[str, Any] = meta

    def flops(self, component: Optional[str] = None,
              kinds: Optional[Sequence[str]] = None,
              recompute: Optional[bool] = None) -> int:
        """FLOPs summed over the ops of ``component`` (None: all), of
        ``kinds`` (None: all), recomputed or not (None: both)."""
        return sum(o.flops for o in self.ops
                   if (component is None or o.component == component)
                   and (kinds is None or o.kind in kinds)
                   and (recompute is None or o.recompute == recompute))

    def by_component(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for o in self.ops:
            row = out.setdefault(o.component, {"flops": 0, "bytes": 0,
                                               "ops": 0})
            row["flops"] += o.flops
            row["bytes"] += o.bytes
            row["ops"] += 1
        return out

    def kernel_calls(self) -> List[OpRecord]:
        return [o for o in self.ops if o.kind == KERNEL]


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in nested lists, tuples and dicts, in order."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


class StepCounter(TorchDispatchMode):
    """Counts every aten operation of the step run inside it on
    ``device`` (see the module docstring).  ``resident`` labels the
    tensors that exist before the step (``{"params": [...],
    "optimizer": [...], "batch": [...]}``).  Bookkeeping never ends the
    step: its first failure is kept in ``error`` and counting stops."""

    def __init__(self, device, resident: Optional[Dict[str, Sequence]]
                 = None, model: Optional[torch.nn.Module] = None):
        super().__init__()
        self.device = torch.device(device)
        # a parameter's storage → its top-level module's name, which is
        # the model's scope name (the path of its gradient's accumulation)
        self._param_scopes: Dict[int, str] = {}
        if model is not None:
            for name, p in model.named_parameters():
                self._param_scopes[p.untyped_storage()._cdata] = \
                    name.split(".")[0]
        self.ops: List[OpRecord] = []
        self.allocations: List[Allocation] = []
        self.timeline: List[int] = []
        self.error = None
        self._live: Dict[int, Allocation] = {}
        # storages that exist before the step: key → (label, bytes)
        self._resident: Dict[int, Tuple[str, int]] = {}
        for label, tensors in (resident or {}).items():
            for t in tensors:
                if isinstance(t, torch.Tensor) and self._on_device(t):
                    st = t.untyped_storage()
                    if st.nbytes() and st._cdata not in self._resident:
                        self._resident[st._cdata] = (label, int(st.nbytes()))
        self._live_bytes = 0
        self._suspend = 0
        self._lock = threading.RLock()
        # (sequence number, scope path) at each scope change of the
        # step's thread: a node numbered n was made under the last path
        # logged at a number <= n
        self._seq_keys: List[int] = []
        self._seq_paths: List[str] = []
        self._last_node: Dict[int, Any] = {}
        self._components: Dict[str, str] = {}
        self._view_ops: Dict[Any, bool] = {}
        self._composites: Dict[Any, bool] = {}
        self._thread = None
        self._prev_counter = None
        self._depth = 0

    # -- mode ----------------------------------------------------------

    def __enter__(self):
        if not self._depth:
            self._thread = threading.get_ident()
            self._prev_counter = scopes.set_counter(self)
            self.on_scope()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                scopes.set_counter(self._prev_counter)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (self._suspend == 0 and torch.is_inference_mode_enabled()
                and self._composite(func)):
            # under inference_mode composite ops arrive whole: count
            # their decomposition (elsewhere they never arrive whole, and
            # the ops that do run as dispatched)
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._suspend == 0 and self.error is None:
            try:
                self._record(func, args, kwargs, out)
            except Exception as e:  # noqa: BLE001 — never end the step
                self._fail(e)
        return out

    def _fail(self, e: BaseException) -> None:
        self.error = e
        log.warning("step counter stopped counting", exc_info=e)

    # -- hooks from profiling/scopes.py --------------------------------

    def on_scope(self) -> None:
        """A scope opened or closed: the autograd nodes made from here on
        this (the step's) thread belong to the new path."""
        if threading.get_ident() != self._thread \
                or torch._C._current_graph_task_id() != -1:
            return
        self._seq_keys.append(torch._C._autograd._get_sequence_nr())
        self._seq_paths.append(scopes.scope_path())

    @contextlib.contextmanager
    def suspended(self):
        """Operations inside are not counted."""
        self._suspend += 1
        try:
            yield
        finally:
            self._suspend -= 1

    def opaque_call(self, kind: str, fn, args: Sequence):
        """``fn(*args)`` counted as one call of the hand-written kernel
        ``kind`` (:func:`kernel_cost`), none of its operations."""
        with self.suspended():
            result = fn(*args)
        if self._suspend == 0 and self.error is None:
            try:
                with self.suspended():
                    nbytes, ops = kernel_cost(kind, args, result)
                ins = _tensors(args)
                dtype = next((t.dtype for t in ins if t.is_floating_point()
                              and t.dim() > 3), torch.float32)
                self._add(kind, KERNEL, dtype, int(ops), int(nbytes), ins,
                          _tensors(result))
            except Exception as e:  # noqa: BLE001 — never end the step
                self._fail(e)
        return result

    # -- recording -----------------------------------------------------

    def _on_device(self, t: torch.Tensor) -> bool:
        d = t.device
        return d.type == self.device.type and (
            self.device.index is None or d.index in (None, self.device.index))

    def _composite(self, func) -> bool:
        """``func`` has a composite decomposition and no FLOP formula."""
        got = self._composites.get(func)
        if got is None:
            got = (func.overloadpacket not in _FLOP_REGISTRY
                   and func.has_kernel_for_dispatch_key(
                       torch._C.DispatchKey.CompositeImplicitAutograd))
            self._composites[func] = got
        return got

    def _is_view(self, func) -> bool:
        got = self._view_ops.get(func)
        if got is None:
            rets = func._schema.returns
            got = bool(rets) and all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in rets)
            self._view_ops[func] = got
        return got

    def _path(self) -> Tuple[str, bool, bool]:
        """(scope path, backward, recompute) of the operation running
        now on this thread."""
        ident = threading.get_ident()
        node = torch._C._current_autograd_node()
        if node is None and torch._C._current_graph_task_id() != -1:
            node = self._last_node.get(ident)
        if node is None:
            return scopes.scope_path(), False, False
        self._last_node[ident] = node
        seq = node._sequence_nr()
        fwd = ""
        if seq < _NO_NODE_SEQ:
            i = bisect.bisect_right(self._seq_keys, seq) - 1
            if i >= 0:
                fwd = self._seq_paths[i]
        elif hasattr(node, "variable"):
            # AccumulateGrad: the parameter's module (its layout copy)
            fwd = self._param_scopes.get(
                node.variable.untyped_storage()._cdata, "")
        inner = scopes.scope_path()
        path = f"transpose({fwd})" + (f"/{inner}" if inner else "")
        return path, True, scopes.in_recompute()

    def _component(self, path: str) -> str:
        comp = self._components.get(path)
        if comp is None:
            comp = resolve_component(path) or "other"
            self._components[path] = comp
        return comp

    def _record(self, func, args, kwargs, out) -> None:
        name = str(func)
        scratch = _HOST_SCRATCH.get(name)
        if scratch is None:
            ins, outs = _tensors((args, kwargs)), _tensors(out)
        else:
            ins = _tensors(([a for i, a in enumerate(args)
                             if i not in scratch[1]], kwargs))
            outs = _tensors([o for i, o in enumerate(out)
                             if i not in scratch[0]])
        dev_ins = [t for t in ins if self._on_device(t)]
        dev_outs = [t for t in outs if self._on_device(t)]
        if not dev_ins and not dev_outs:
            return      # host work of a step on another device
        packet = func.overloadpacket
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = COLLECTIVE
        elif len(dev_ins) + len(dev_outs) < len(ins) + len(outs):
            kind = TRANSFER
        else:
            kind = MATMUL if packet in _FLOP_REGISTRY else OP
        flops = nbytes = 0
        if kind != COLLECTIVE and not self._is_view(func) \
                and packet.__name__ not in _EMPTY_OPS:
            if kind == MATMUL:
                flops = int(_FLOP_REGISTRY[packet](*args, **kwargs,
                                                   out_val=out))
            elif kind == OP:
                # an in-place op without a result (the _foreach_*_ ops)
                # produces the arguments it writes
                flops = sum(t.numel() for t in
                            (dev_outs or self._written(func, args)))
            nbytes = self._bytes(dev_ins + dev_outs)
        src = dev_ins if kind == MATMUL and dev_ins else (dev_outs or dev_ins)
        dtype = src[0].dtype
        self._add(name, kind, dtype, flops, nbytes, dev_ins, dev_outs)

    def _written(self, func, args) -> List[torch.Tensor]:
        """The device tensors among ``args`` that ``func`` writes in place."""
        return [t for a, arg in zip(func._schema.arguments, args)
                if a.alias_info is not None and a.alias_info.is_write
                for t in _tensors(arg) if self._on_device(t)]

    @staticmethod
    def _bytes(tensors: Sequence[torch.Tensor]) -> int:
        """Each storage once: the smaller of its size and the elements
        of its distinct views among ``tensors``."""
        spans: Dict[int, List[int]] = {}
        views = set()
        for t in tensors:
            st = t.untyped_storage()
            view = (st._cdata, t.storage_offset(), tuple(t.shape),
                    t.stride())
            if view in views:
                continue
            views.add(view)
            rec = spans.setdefault(st._cdata, [int(st.nbytes()), 0])
            rec[1] += t.numel() * t.element_size()
        return sum(min(total, span) for total, span in spans.values())

    def _add(self, name, kind, dtype, flops, nbytes, ins, outs) -> None:
        path, backward, recompute = self._path()
        comp = self._component(path)
        with self._lock:
            index = len(self.ops)
            self.ops.append(OpRecord(name, kind, comp, str(dtype).replace(
                "torch.", ""), flops, nbytes, backward, recompute))
            for t in ins:
                if self._on_device(t):
                    self._see_input(t)
            for t in outs:
                if self._on_device(t):
                    self._see_output(t, index, comp, name)
            self.timeline.append(self._live_bytes)

    def _see_input(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._resident:
            return
        if st.nbytes():
            self._resident[key] = ("resident", int(st.nbytes()))

    def _see_output(self, t: torch.Tensor, index: int, comp: str,
                    name: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        nbytes = int(st.nbytes())
        if key in self._live or key in self._resident or not nbytes:
            return
        alloc = Allocation(nbytes, index, comp, name, tuple(t.shape),
                           str(t.dtype).replace("torch.", ""))
        alloc.ref = weakref.ref(st, self._freed(key))
        self._live[key] = alloc
        self.allocations.append(alloc)
        self._live_bytes += nbytes

    def _freed(self, key: int):
        def callback(_ref):
            with self._lock:
                alloc = self._live.pop(key, None)
                if alloc is not None:
                    alloc.freed_at = len(self.ops)
                    self._live_bytes -= alloc.nbytes
        return callback

    def counts(self, **meta) -> StepCounts:
        """The counted step (call after the mode has exited)."""
        with self._lock:
            resident: Dict[str, int] = {}
            for label, nbytes in self._resident.values():
                resident[label] = resident.get(label, 0) + nbytes
            allocs = list(self.allocations)
            for a in allocs:
                a.ref = None
            meta = dict(meta)
            meta.setdefault("device", str(self.device))
            if self.error is not None:
                meta["error"] = repr(self.error)
            return StepCounts(list(self.ops), allocs, resident,
                              list(self.timeline), meta)


def _state_tensors(optimizer) -> List[torch.Tensor]:
    if optimizer is None:
        return []
    return [v for state in optimizer.state.values() for v in state.values()
            if isinstance(v, torch.Tensor)]


def _counter_for(model: torch.nn.Module, optimizer, batch) -> StepCounter:
    params = list(model.parameters()) + list(model.buffers())
    return StepCounter(
        params[0].device if params else "cpu",
        {"params": params, "optimizer": _state_tensors(optimizer),
         "batch": _tensors(batch)}, model=model)


def train_counter(model: torch.nn.Module, optimizer,
                  batch: Dict[str, torch.Tensor],
                  priorities: Dict[str, torch.Tensor]) -> StepCounter:
    """The counter of one training step of ``model`` (unwrapped) on
    ``batch``: the parameters, the optimizer's state and the batch are
    its resident storages."""
    return _counter_for(model, optimizer, (batch, priorities))


def train_meta(model: torch.nn.Module, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, Any]:
    """The geometry and state bytes a training step's counts carry (the
    plan's collectives are priced from them): ``target_*_bytes`` are the
    parameters the ``tensor`` and ``2d`` plans split over the model axis
    (``sharding.TENSOR_TARGETS``)."""
    import re

    from eksml_tpu_torch.convert import flax_path
    from eksml_tpu_torch.parallel.sharding import TENSOR_TARGETS

    def nbytes(p):
        return p.numel() * p.element_size()

    params = list(model.named_parameters())
    targets = [p for n, p in params
               if re.search(TENSOR_TARGETS, flax_path(n))]
    return {"kind": "train", "batch_size": int(batch["images"].shape[0]),
            "canvas": list(batch["images"].shape[1:3]),
            "grad_bytes": sum(nbytes(p) for _, p in params
                              if p.requires_grad),
            "param_bytes": sum(nbytes(p) for _, p in params),
            "target_grad_bytes": sum(nbytes(p) for p in targets
                                     if p.requires_grad),
            "target_param_bytes": sum(nbytes(p) for p in targets)}


def count_train_step(step, batch: Dict[str, torch.Tensor],
                     priorities: Dict[str, torch.Tensor], step_index: int,
                     model: torch.nn.Module, optimizer=None, **meta
                     ) -> Tuple[Any, StepCounts]:
    """Run ``step(batch, priorities, step_index)`` (``train.make_train_step``)
    once, counted: → (its metrics, :class:`StepCounts`).  The step is
    the real one: the counter only watches."""
    counter = train_counter(model, optimizer, batch, priorities)
    with counter:
        metrics = step(batch, priorities, step_index)
    return metrics, counter.counts(**train_meta(model, batch), **meta)


def count_predict_step(model: torch.nn.Module, images: torch.Tensor,
                       image_hw: torch.Tensor, **meta
                       ) -> Tuple[Any, StepCounts]:
    """One counted ``model.predict(images, image_hw)`` without autograd:
    → (its outputs, :class:`StepCounts`)."""
    counter = _counter_for(model, None, (images, image_hw))
    with torch.no_grad(), counter:
        outputs = model.predict(images, image_hw)
    return outputs, counter.counts(
        kind="predict", batch_size=int(images.shape[0]),
        canvas=list(images.shape[1:3]), grad_bytes=0,
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()), **meta)


# ---- pricing ---------------------------------------------------------


def plan_collectives(meta: Dict[str, Any], mesh_shape: Dict[str, int],
                     strategy: str = "replicated"
                     ) -> List[Tuple[str, int, int]]:
    """The step's collectives from its plan, as (opcode, payload bytes,
    participants): ``replicated`` (DDP) all-reduces the gradients over
    every rank; ``fsdp`` (FSDP2) all-gathers the parameters and
    reduce-scatters the gradients over its shard group; ``tensor``
    does that for the model-axis targets over ``model`` and
    all-reduces the other gradients; ``2d`` does it for the targets over
    ``fsdp x model`` and for the other leaves over ``fsdp``.  Where the
    mesh holds replicas of a shard group, each shard is then
    all-reduced, priced over every rank as the reference's
    ``comm_sizes_for_mesh`` counts an all-reduce.  A predict step has
    none."""
    grads = int(meta.get("grad_bytes", 0))
    if meta.get("kind") != "train" or not grads:
        return []
    sizes = comm_sizes_for_mesh(mesh_shape)
    ranks = max(1, sizes["all-reduce"])
    f = max(1, int(mesh_shape.get("fsdp", 1)))
    m = max(1, int(mesh_shape.get("model", 1)))
    params = int(meta.get("param_bytes", 0))
    t_grads = int(meta.get("target_grad_bytes", 0))
    t_params = int(meta.get("target_param_bytes", 0))

    def sharded(p_bytes, g_bytes, k):
        out = [("all-gather", p_bytes, k), ("reduce-scatter", g_bytes, k)]
        if ranks > k:
            out.append(("all-reduce", g_bytes // k, ranks))
        return out

    if strategy == "fsdp":
        return sharded(params, grads, f)
    if strategy == "tensor":
        return sharded(t_params, t_grads, m) + [
            ("all-reduce", grads - t_grads, ranks)]
    if strategy == "2d":
        return (sharded(t_params, t_grads, f * m)
                + sharded(params - t_params, grads - t_grads, f))
    return [("all-reduce", grads, ranks)]


def predict_from_counts(counts: StepCounts, target: str = DEFAULT_TARGET,
                        precision: str = "float32",
                        mesh_shape: Optional[Dict[str, int]] = None,
                        strategy: str = "replicated",
                        slice_devices: Optional[int] = None,
                        exchange: str = "flat") -> Dict[str, Any]:
    """Counted step → predicted step time on ``target``, with the keys of
    the reference's ``predict_from_hlo`` (``predicted_step_time_ms``,
    ``sections_ms``, ``components_ms``, ``component_costs``,
    ``comms_ms``, ``collectives``, ``totals``, ``comm_sizes``, ``hbm``)
    and the port's own: ``model_flops`` (without REMAT's recompute),
    ``recompute_flops``, ``ops``, ``kernels`` (the hand-written kernels'
    calls) and ``other_bytes_pct`` (the share of bytes no scope names)."""
    from eksml_tpu_torch.profiling.memory import analyze_memory

    spec = chip_spec(target)
    peaks = spec["peak_flops"]
    f32_peak = float(peaks["float32"])
    hbm = float(spec["hbm_bytes_per_sec"])
    ici = float(spec["ici_bytes_per_sec"])
    dcn = float(spec["dcn_bytes_per_sec"])
    mesh_shape = dict(mesh_shape or {})
    comm_sizes = comm_sizes_for_mesh(mesh_shape)

    comp_sec: Dict[str, float] = {}
    comp_costs: Dict[str, Dict[str, float]] = {}
    totals = {"flops": 0.0, "hbm_bytes": 0.0, "collective_bytes": 0.0}
    kernels: Dict[str, Dict[str, float]] = {}
    recompute = 0
    for o in counts.ops:
        if o.kind == COLLECTIVE:
            continue
        peak = (float(peaks.get(o.dtype, f32_peak)) if o.kind == MATMUL
                else f32_peak)
        t = max(o.flops / peak, o.bytes / hbm)
        comp_sec[o.component] = comp_sec.get(o.component, 0.0) + t
        row = comp_costs.setdefault(o.component, {
            "flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0,
            "ici_ms": 0.0, "dcn_ms": 0.0})
        row["flops"] += o.flops
        row["bytes"] += o.bytes
        totals["flops"] += o.flops
        totals["hbm_bytes"] += o.bytes
        if o.recompute:
            recompute += o.flops
        if o.kind == KERNEL:
            k = kernels.setdefault(o.name, {"launches": 0, "bytes": 0,
                                            "ops": 0, "ms": 0.0})
            k["launches"] += 1
            k["bytes"] += o.bytes
            k["ops"] += o.flops
            k["ms"] += t * 1e3

    ledger: List[Dict[str, Any]] = []
    for opcode, nbytes, k in plan_collectives(counts.meta, mesh_shape,
                                              strategy):
        groups = (tuple(range(max(1, k))),)
        t, ici_s, dcn_s, link, k = price_collective(
            opcode, nbytes, groups, slice_devices, ici, dcn,
            exchange=exchange)
        comp = "allreduce"
        row = comp_costs.setdefault(comp, {
            "flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0,
            "ici_ms": 0.0, "dcn_ms": 0.0})
        row["collective_bytes"] += nbytes
        row["ici_ms"] += ici_s * 1e3
        row["dcn_ms"] += dcn_s * 1e3
        totals["collective_bytes"] += nbytes
        comp_sec[comp] = comp_sec.get(comp, 0.0) + t
        # nothing overlaps: every collective is priced fully exposed
        ledger.append({
            "name": f"{strategy}:{opcode}", "opcode": opcode,
            "component": comp, "bytes": int(nbytes), "group_size": k,
            "num_groups": 1, "link": link, "groups_source": "plan",
            "predicted_ms": t * 1e3, "ici_ms": ici_s * 1e3,
            "dcn_ms": dcn_s * 1e3, "overlap_ms": 0.0,
            "exposed_ms": t * 1e3})

    comms_ms = {"ici_ms": 0.0, "dcn_ms": 0.0, "exposed_ms": 0.0,
                "exposed_dcn_ms": 0.0}
    for lrow in ledger:
        comms_ms["ici_ms"] += lrow["ici_ms"]
        comms_ms["dcn_ms"] += lrow["dcn_ms"]
        comms_ms["exposed_ms"] += lrow["exposed_ms"]
        comms_ms["exposed_dcn_ms"] += lrow["dcn_ms"]
    sections_ms = {"fwd": 0.0, "bwd": 0.0, "comms": 0.0, "optimizer": 0.0}
    for comp, t in comp_sec.items():
        sections_ms[section_of(comp)] += t * 1e3
    total_ms = sum(comp_sec.values()) * 1e3
    all_bytes = sum(r["bytes"] for r in comp_costs.values()) or 1.0

    hbm_rec = analyze_memory(counts)
    capacity = float(spec["hbm_bytes"])
    peak_bytes = hbm_rec.get("peak_hbm_bytes", 0)
    hbm_rec["capacity"] = {
        "hbm_bytes": int(capacity),
        "headroom_bytes": int(capacity - peak_bytes),
        "utilization_pct": 100.0 * peak_bytes / capacity,
        "fits": bool(peak_bytes <= capacity),
    }
    return {
        "target": target,
        "precision": precision,
        "predicted_step_time_ms": total_ms,
        "sections_ms": sections_ms,
        "components_ms": {c: t * 1e3 for c, t in
                          sorted(comp_sec.items(), key=lambda kv: -kv[1])},
        "component_costs": comp_costs,
        "comms_ms": comms_ms,
        "collectives": ledger,
        "totals": totals,
        "comm_sizes": comm_sizes,
        "hbm": hbm_rec,
        "model_flops": totals["flops"] - recompute,
        "recompute_flops": recompute,
        "ops": len(counts.ops),
        "kernels": kernels,
        "other_bytes_pct": 100.0 * comp_costs.get("other", {}).get(
            "bytes", 0.0) / all_bytes,
        "meta": dict(counts.meta),
    }


def predict_for_step(counts: StepCounts, device_kind: Optional[str] = None,
                     mesh_shape: Optional[Dict[str, int]] = None,
                     precision: str = "float32", num_slices: int = 1,
                     exchange: str = "flat", strategy: str = "replicated"
                     ) -> Dict[str, Any]:
    """ONE pricing entry point for a counted step, shared by the trainer's
    gauge and ``tools/bench.py``: the target from the device name
    (``torch.cuda.get_device_name``; an unmapped name, the CPU included,
    prices as the H100), the collectives' participants from the mesh,
    the devices per node from ``num_slices``."""
    target = target_for_device_kind(device_kind) or DEFAULT_TARGET
    mesh_shape = dict(mesh_shape or {})
    slice_devices = None
    if num_slices and int(num_slices) > 1:
        total = 1
        for v in mesh_shape.values():
            total *= int(v)
        slice_devices = max(1, total // int(num_slices))
    pred = predict_from_counts(counts, target=target, precision=precision,
                               mesh_shape=mesh_shape, strategy=strategy,
                               slice_devices=slice_devices,
                               exchange=exchange)
    pred["device_kind"] = device_kind
    return pred


# ---- prediction comparison (the gate's FAIL logic) ------------------


def compare_predictions(fresh: Dict[str, Any], base: Dict[str, Any],
                        max_regress_pct: float = 10.0,
                        min_share_pct: float = 5.0
                        ) -> Tuple[bool, Dict[str, Any]]:
    """(ok, verdict) for one fresh-vs-banked prediction pair: FAILs on a
    total regression beyond ``max_regress_pct``, or on a component
    holding ≥``min_share_pct`` of the baseline regressing beyond 2× the
    bound."""
    ft = float(fresh["predicted_step_time_ms"])
    bt = float(base["predicted_step_time_ms"])
    verdict: Dict[str, Any] = {
        "fresh_ms": round(ft, 3), "baseline_ms": round(bt, 3),
        "max_regress_pct": max_regress_pct,
    }
    if bt <= 0:
        verdict["error"] = "baseline prediction is <= 0 ms — rebank it"
        return False, verdict
    total_pct = (ft / bt - 1.0) * 100.0
    verdict["total_regress_pct"] = round(total_pct, 2)

    fc = fresh.get("components_ms", {})
    bc = base.get("components_ms", {})
    diffs = []
    for comp in sorted(set(fc) | set(bc)):
        b = float(bc.get(comp, 0.0))
        f = float(fc.get(comp, 0.0))
        share = 100.0 * max(b, f) / bt
        if share < 1.0:
            continue
        pct = ((f / b - 1.0) * 100.0) if b > 0 else None
        diffs.append({"component": comp,
                      "baseline_ms": round(b, 3),
                      "fresh_ms": round(f, 3),
                      "share_pct": round(share, 1),
                      "regress_pct": (round(pct, 1)
                                      if pct is not None else "new")})
    diffs.sort(key=lambda d: -(d["fresh_ms"] - d["baseline_ms"]))
    verdict["components"] = diffs

    def _worst() -> str:
        for d in diffs:
            if d["fresh_ms"] > d["baseline_ms"]:
                delta = d["regress_pct"]
                delta = (f"+{delta}%" if isinstance(delta, float)
                         else "new")
                return (f"{d['component']} predicted {delta} "
                        f"({d['baseline_ms']}ms -> {d['fresh_ms']}ms)")
        return "no single component regressed (uniform drift)"

    if total_pct > max_regress_pct:
        verdict["error"] = (
            f"predicted step time regressed {total_pct:+.1f}% "
            f"({bt:.2f}ms -> {ft:.2f}ms); worst component: {_worst()}")
        return False, verdict
    for d in diffs:
        b, f = d["baseline_ms"], d["fresh_ms"]
        if b <= 0:
            if f > 0 and d["share_pct"] >= min_share_pct:
                verdict["error"] = (
                    f"new component {d['component']} predicted "
                    f"{f}ms ({d['share_pct']}% of the step) while "
                    f"the total moved only {total_pct:+.1f}% — a "
                    "masked regression")
                return False, verdict
            continue
        if (d["share_pct"] >= min_share_pct
                and (f / b - 1.0) * 100.0 > 2.0 * max_regress_pct):
            verdict["error"] = (
                f"component {d['component']} predicted "
                f"{(f / b - 1) * 100:+.1f}% ({b}ms -> {f}ms, "
                f"{d['share_pct']}% of the step) while the total "
                f"moved only {total_pct:+.1f}% — a masked regression")
            return False, verdict
    return True, verdict


# ---- calibration against banked measurements -------------------------

def calibration_points(artifacts_dir: str) -> List[Dict]:
    """Pair banked measurements with their predictions: every
    ``bench_rung_*.json`` that carries its own ``predicted_step_time_ms``
    (``tools/bench.py --out``).  The reference also pins TPU records
    against banked smoke-width predictions; the port has none."""
    points: List[Dict] = []
    for path in sorted(glob.glob(os.path.join(artifacts_dir,
                                              "bench_rung_*.json"))):
        rec = load_json(path)
        if not rec:
            continue
        measured = rec.get("step_time_ms")
        predicted = rec.get("predicted_step_time_ms")
        if (measured and measured > 0 and predicted and predicted > 0
                and rec.get("status") != "error"
                and not rec.get("forward_only")):
            points.append({
                "rung": rec.get("operating_point", os.path.basename(path)),
                "measured_ms": float(measured),
                "measured_source": os.path.basename(path),
                "predicted_ms": float(predicted),
                "predicted_source": "embedded",
                "fit_group": "measured",
            })
    return points


def calibrate(points: List[Dict]) -> Dict[str, Any]:
    """Fit one scale factor per rung (measured / predicted); report how
    far they spread from their group's geometric mean
    (``model_error_pct``)."""
    out: Dict[str, Any] = {"n_points": len(points), "points": []}
    usable = [p for p in points
              if p["predicted_ms"] > 0 and p["measured_ms"] > 0]
    if not usable:
        out["note"] = ("no calibration points — bank predictions for "
                       "the measured rungs (tools/perf_gate.py "
                       "--update-baseline) or land a hardware round")
        out["scale"] = None
        out["model_error_pct"] = None
        return out
    groups: Dict[str, List[Dict]] = {}
    for p in usable:
        groups.setdefault(p.get("fit_group", "smoke"), []).append(p)
    out["scales"] = {}
    errs = []
    for gname in sorted(groups):
        gpts = groups[gname]
        scales = [p["measured_ms"] / p["predicted_ms"] for p in gpts]
        common = math.exp(sum(math.log(s) for s in scales) / len(scales))
        out["scales"][gname] = round(common, 2)
        for p, s in zip(gpts, scales):
            err = (s / common - 1.0) * 100.0
            errs.append(abs(err))
            out["points"].append({
                **{k: p[k] for k in ("rung", "measured_ms",
                                     "predicted_ms", "measured_source")},
                "fit_group": gname,
                "scale": round(s, 2),
                "deviation_pct": round(err, 2),
            })
    out["scale"] = out["scales"].get(
        "smoke", next(iter(out["scales"].values())))
    out["model_error_pct"] = round(max(errs), 2)
    if len(usable) < 2:
        out["note"] = ("single calibration point: scale is exact by "
                       "construction; model error needs >=2 rungs")
    return out


#: per-link communication gauges published next to PREDICTED_GAUGE —
#: prediction comms_ms key → (gauge name, help)
PREDICTED_COMMS_GAUGES = {
    "ici_ms": ("eksml_train_predicted_comms_ici_ms",
               "roofline-predicted per-step collective time on the "
               "links inside a node (NVLink)"),
    "dcn_ms": ("eksml_train_predicted_comms_dcn_ms",
               "roofline-predicted per-step collective time on the "
               "links between nodes"),
    "exposed_ms": ("eksml_train_predicted_comms_exposed_ms",
                   "predicted collective time not hidden behind "
                   "compute (every collective, as priced)"),
}


def publish_predicted_gauge(pred: Dict[str, Any], registry=None) -> None:
    """Set the ``eksml_train_predicted_step_time_ms`` gauge — plus the
    per-link communication gauges when the prediction carries them —
    from a prediction."""
    if registry is None:
        from eksml_tpu_torch.telemetry.registry import default_registry

        registry = default_registry()
    registry.gauge(
        PREDICTED_GAUGE,
        "roofline-predicted step time for this run's first training step "
        "on the target card (eksml_tpu_torch/profiling/predict.py)"
    ).set(float(pred["predicted_step_time_ms"]))
    comms = pred.get("comms_ms")
    if comms:
        for key, (name, help_text) in PREDICTED_COMMS_GAUGES.items():
            registry.gauge(name, help_text).set(float(comms.get(key, 0.0)))
