"""Device time by model component, from a ``torch.profiler`` capture (the
port of ``eksml_tpu/profiling/attribution.py``).

The reference names every HLO instruction by the ``jax.named_scope`` and
flax module path in its ``op_name`` metadata.  The port opens
``torch.profiler.record_function`` ranges under the same names
(:func:`eksml_tpu_torch.profiling.scopes.named_scope`: the model's
top-level modules ``backbone``, ``fpn``, ``rpn``, ``fastrcnn`` /
``cascade<i>``, ``maskrcnn`` and the scopes ``roi_align``, ``nms``,
``rpn_nms``, ``matching``, ``sampling``, ``rpn_loss``, ``input_norm``,
``mask_targets``, ``frcnn_loss``, ``mask_loss``, ``optimizer``), and a
capture's Chrome trace (``profile.export_chrome_trace``) holds them as
``user_annotation`` events.  :class:`TraceAttribution` reads that trace:

- every device event (kernels, memcpy, memset) is joined to the host
  event that launched it: its CUDA runtime (or driver) call with the
  same ``correlation`` and the innermost host range around that call
  on its thread, else the host event with the same ``External id``;
- the launch's path is the ``/``-joined names of the ranges around it,
  outermost first, resolved by :func:`resolve_component` under the
  reference's :data:`SCOPE_RULES` (first rule that matches, as in the
  reference: ``mask_targets/roi_align`` is ``roi-fwd``);
- a launch inside the autograd engine (an
  ``autograd::engine::evaluate_function:`` op) takes the path of the
  forward op that made its graph node, found by the node's
  ``Sequence number`` (the latest forward op with that number before
  the backward op), wrapped as ``transpose(<path>)``: the reference's
  spelling of the backward, so ``backbone`` becomes ``backbone-bwd``
  and ``roi_align`` ``roi-bwd``, and the rules that do not split the
  backward keep their name;
- NCCL kernels go to ``allreduce``, whatever their scope;
- host ops (``cpu_op``) get the same path and component and are
  counted by their self time, which is what a CPU-only capture has.

:meth:`TraceAttribution.component_table` gives each component's share
of the device time (or, without device events, of the host ops' self
time) with the unresolved remainder as a bounded ``other`` bucket;
:func:`write_attribution_artifact` banks it with the kernel map as
``<logdir>/profile/attribution.json``.  Stdlib only.
"""

from __future__ import annotations

import bisect
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

# Collective opcodes → the "allreduce" component regardless of scope
# (the reference's XLA spelling; the port's NCCL kernels map to it by
# name, :func:`is_collective_kernel`).
_COLLECTIVE_OPS = frozenset((
    "all-reduce", "reduce-scatter", "all-gather", "collective-permute",
    "all-to-all", "all-reduce-start", "all-gather-start",
    "collective-permute-start", "reduce-scatter-start",
    "all-to-all-start",
))


def is_collective_opcode(opcode: str) -> bool:
    """True for inter-device collective opcodes."""
    return opcode in _COLLECTIVE_OPS


def is_collective_kernel(name: str) -> bool:
    """True for NCCL's device kernels (``ncclKernel_*``,
    ``ncclDevKernel_*``)."""
    return name.lower().startswith("nccl")


# op_name scope → component.  First match wins; searched on the
# lowercased path.  ``bwd_split=True`` components get a "-bwd" suffix
# when the path shows a transpose context (the backward pass).  Scope
# segments may be wrapped in transform labels, so boundaries accept
# parens as well as path separators.  The scope side of this contract
# is the set of named_scope ranges in models/*, ops/* and train.py —
# keep the two in sync (tests/test_torch_profiling.py checks it).
SCOPE_RULES: Tuple[Tuple[str, str, bool], ...] = (
    # (component, path regex, bwd_split)
    ("optimizer", r"(^|[/(])optimizer($|[/)])", False),
    ("roi", r"(^|[/(])roi_align($|[/)])", True),
    ("rpn-nms", r"(^|[/(])(rpn_nms|nms)($|[/)])", False),
    ("matching", r"(^|[/(])matching($|[/)])", False),
    ("sampling", r"(^|[/(])sampling($|[/)])", False),
    ("loss", r"(^|[/(])(loss|rpn_loss|frcnn_loss|mask_loss)($|[/)])",
     False),
    ("input-norm", r"(^|[/(])input_norm($|[/)])", False),
    ("fpn-conv", r"(^|[/(])fpn($|[/)])", True),
    ("backbone", r"(^|[/(])backbone($|[/)])", True),
    ("rpn-head", r"(^|[/(])rpn($|[/)])", True),
    ("box-head", r"(^|[/(])(fastrcnn|cascade\d*)($|[/)])", True),
    ("mask-head", r"(^|[/(])maskrcnn($|[/)])", True),
    ("mask-targets", r"(^|[/(])mask_targets($|[/)])", False),
)
_SCOPE_RULES_C = tuple((comp, re.compile(pat), bwd)
                       for comp, pat, bwd in SCOPE_RULES)


def resolve_component(op_name: str, opcode: str = "") -> Optional[str]:
    """op_name path (+ opcode) → component name, or None (the
    reference's function, unchanged)."""
    if opcode in _COLLECTIVE_OPS:
        return "allreduce"
    if not op_name:
        return None
    path = op_name.lower()
    is_bwd = "transpose(" in path
    # the ROOT module's transform labels — jvp(MaskRCNN),
    # transpose(jvp(MaskRCNN)) — would otherwise collide with the mask
    # HEAD module (flax name "maskrcnn"); strip the wrapped class name
    path = path.replace("jvp(maskrcnn)", "jvp()")
    for comp, pat, bwd_split in _SCOPE_RULES_C:
        if pat.search(path):
            if comp == "roi":
                return "roi-bwd" if is_bwd else "roi-fwd"
            if bwd_split and is_bwd:
                return comp + "-bwd"
            return comp
    return None


#: the name prefix of the autograd engine's op around each backward node
BACKWARD_OP_PREFIX = "autograd::engine::evaluate_function:"
_HOST_CATS = frozenset(("cpu_op", "user_annotation"))
_DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
_LAUNCH_CATS = frozenset(("cuda_runtime", "cuda_driver"))
OTHER = "other"


class _Host:
    """One host range of the trace (an op or a ``record_function``)."""

    __slots__ = ("name", "cat", "ts", "end", "args", "parent", "thread",
                 "child_us", "backward", "component", "path")

    def __init__(self, ev: Dict, thread):
        self.name = str(ev.get("name", ""))
        self.cat = ev.get("cat")
        self.ts = float(ev.get("ts", 0.0))
        self.end = self.ts + float(ev.get("dur", 0.0))
        self.args = ev.get("args") or {}
        self.thread = thread
        self.parent: Optional[_Host] = None
        self.child_us = 0.0
        self.backward = self.name.startswith(BACKWARD_OP_PREFIX)
        self.component: Optional[str] = None
        self.path: Optional[str] = None


def load_trace(trace) -> Dict:
    """A Chrome-trace document: ``trace`` itself (a dict), or the JSON
    at path ``trace``."""
    if isinstance(trace, dict):
        return trace
    with open(trace) as f:
        return json.load(f)


class TraceAttribution:
    """A capture's device and host time by component (see the module
    docstring for the rules)."""

    def __init__(self, trace):
        doc = load_trace(trace)
        events = doc.get("traceEvents", []) if isinstance(doc, dict) \
            else doc
        hosts: List[_Host] = []
        launches: Dict[Any, Tuple[Any, float]] = {}
        device: List[Dict] = []
        for ev in events:
            if not isinstance(ev, dict) or ev.get("ph") != "X":
                continue
            cat = ev.get("cat")
            thread = (ev.get("pid"), ev.get("tid"))
            if cat in _HOST_CATS:
                hosts.append(_Host(ev, thread))
            elif cat in _LAUNCH_CATS:
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (thread, float(ev.get("ts", 0.0)))
            elif cat in _DEVICE_CATS:
                device.append(ev)
        self._threads: Dict[Any, List[_Host]] = {}
        for h in hosts:
            self._threads.setdefault(h.thread, []).append(h)
        self._starts: Dict[Any, List[float]] = {}
        for thread, evs in self._threads.items():
            # outer ranges first when two start together
            evs.sort(key=lambda h: (h.ts, -(h.end - h.ts)))
            stack: List[_Host] = []
            for h in evs:
                while stack and stack[-1].end < h.ts:
                    stack.pop()
                if stack and h.end <= stack[-1].end:
                    h.parent = stack[-1]
                    stack[-1].child_us += h.end - h.ts
                stack.append(h)
            self._starts[thread] = [h.ts for h in evs]
        self._by_external: Dict[Any, _Host] = {}
        # forward ops by sequence number (the op that made each autograd
        # node; a backward op names its node's number)
        self._forward: Dict[Any, List[_Host]] = {}
        for h in hosts:
            ext = h.args.get("External id")
            if ext is not None:
                self._by_external.setdefault(ext, h)
            seq = h.args.get("Sequence number")
            if (h.cat == "cpu_op" and seq is not None and not h.backward
                    and not h.args.get("Fwd thread id")
                    and self._backward_of(h) is None):
                self._forward.setdefault(seq, []).append(h)
        self.hosts = hosts
        self._launches = launches
        # device event → (name, component, µs)
        self.device: List[Tuple[str, str, float]] = []
        self.unlinked = 0
        for ev in device:
            name = str(ev.get("name", ""))
            dur = float(ev.get("dur", 0.0))
            if is_collective_kernel(name):
                self.device.append((name, "allreduce", dur))
                continue
            host = self._launcher(ev.get("args") or {})
            if host is None:
                self.unlinked += 1
                comp = OTHER
            else:
                comp = self.component_of(host)
            self.device.append((name, comp, dur))

    # -- joins ---------------------------------------------------------

    def _launcher(self, args: Dict) -> Optional[_Host]:
        """The host range that launched a device event: the innermost
        range around its runtime call, else the event with its
        ``External id``."""
        site = self._launches.get(args.get("correlation"))
        if site is not None:
            host = self.innermost_at(*site)
            if host is not None:
                return host
        return self._by_external.get(args.get("External id"))

    def innermost_at(self, thread, ts: float) -> Optional[_Host]:
        """The innermost host range on ``thread`` that holds time
        ``ts``."""
        evs = self._threads.get(thread)
        if not evs:
            return None
        i = bisect.bisect_right(self._starts[thread], ts) - 1
        if i < 0:
            return None
        h: Optional[_Host] = evs[i]
        while h is not None and h.end < ts:
            h = h.parent
        return h

    @staticmethod
    def _backward_of(h: _Host) -> Optional[_Host]:
        while h is not None:
            if h.backward:
                return h
            h = h.parent
        return None

    def _forward_op(self, bwd: _Host) -> Optional[_Host]:
        seq = bwd.args.get("Sequence number")
        best = None
        for f in self._forward.get(seq, ()):
            if f.ts <= bwd.ts and (best is None or f.ts >= best.ts):
                best = f
        return best

    @staticmethod
    def _scopes(h: Optional[_Host], stop: Optional[_Host] = None
                ) -> List[str]:
        names: List[str] = []
        while h is not None and h is not stop:
            if h.cat == "user_annotation":
                names.append(h.name)
            h = h.parent
        return names[::-1]

    def path_of(self, h: _Host) -> str:
        """The scope path of host range ``h``: its enclosing
        ``record_function`` names, or, inside the autograd engine,
        ``transpose(<forward op's path>)`` and the ranges inside the
        backward op."""
        if h.path is None:
            bwd = self._backward_of(h)
            if bwd is None:
                h.path = "/".join(self._scopes(h))
            else:
                fwd = self._forward_op(bwd)
                inner = self._scopes(h, stop=bwd)
                h.path = "/".join(
                    [f"transpose({self.path_of(fwd) if fwd else ''})"]
                    + inner)
        return h.path

    def component_of(self, h: _Host) -> str:
        if h.component is None:
            h.component = resolve_component(self.path_of(h)) or OTHER
        return h.component

    # -- tables --------------------------------------------------------

    def kernel_map(self) -> Dict[str, Dict[str, float]]:
        """Device event name → {component: device ms}."""
        out: Dict[str, Dict[str, float]] = {}
        for name, comp, dur in self.device:
            by = out.setdefault(name, {})
            by[comp] = by.get(comp, 0.0) + dur / 1e3
        return {k: {c: round(v, 6) for c, v in by.items()}
                for k, by in out.items()}

    def host_ms(self) -> Dict[str, float]:
        """Host ops' self time (ms) by component."""
        out: Dict[str, float] = {}
        for h in self.hosts:
            if h.cat != "cpu_op":
                continue
            self_us = max(0.0, (h.end - h.ts) - h.child_us)
            comp = self.component_of(h)
            out[comp] = out.get(comp, 0.0) + self_us / 1e3
        return out

    def device_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for _, comp, dur in self.device:
            out[comp] = out.get(comp, 0.0) + dur / 1e3
        return out

    def component_table(self, top_n: int = 10) -> Dict[str, Any]:
        """Each component's share (%) of the device time, ``other`` the
        unresolved rest, the ``top_n`` device events by time with their
        component, and the same table of the host ops' self time
        (``host``).  Without device events (a CPU capture) the shares
        are the host's."""
        dev = self.device_ms()
        host = self.host_ms()
        basis = dev if dev else host

        def pct(ms: Dict[str, float]) -> Dict[str, float]:
            total = sum(ms.values()) or 1.0
            return {k: round(100.0 * v / total, 2)
                    for k, v in sorted(ms.items(), key=lambda kv: -kv[1])}

        table = pct(basis)
        by_kernel: Dict[Tuple[str, str], List[float]] = {}
        for name, comp, dur in self.device:
            rec = by_kernel.setdefault((name, comp), [0.0, 0])
            rec[0] += dur / 1e3
            rec[1] += 1
        total_dev = sum(dev.values()) or 1.0
        top = [{"name": n, "component": c, "ms": round(ms, 4),
                "pct": round(100.0 * ms / total_dev, 2), "count": cnt}
               for (n, c), (ms, cnt) in sorted(by_kernel.items(),
                                               key=lambda kv: -kv[1][0])
               [:top_n]]
        host_pct = pct(host)
        return {
            "basis": "device" if dev else "host",
            "component_pct": table,
            "component_ms": {k: round(v, 4) for k, v in basis.items()},
            "other_pct": table.get(OTHER, 0.0),
            "device_total_ms": round(sum(dev.values()), 4),
            "device_events": len(self.device),
            "unlinked_device_events": self.unlinked,
            "top_kernels": top,
            "host": {"component_pct": host_pct,
                     "other_pct": host_pct.get(OTHER, 0.0),
                     "total_ms": round(sum(host.values()), 4)},
        }


def component_table(trace, top_n: int = 10) -> Dict[str, Any]:
    return TraceAttribution(trace).component_table(top_n)


def write_attribution_artifact(trace, path: str,
                               extra: Optional[dict] = None) -> dict:
    """Bank ``{"map", "component_table", ...}`` as ONE json artifact,
    written then renamed: ``map`` is device event name → {component:
    ms}, ``component_table`` is :meth:`TraceAttribution.component_table`."""
    attr = TraceAttribution(trace)
    payload = {"map": attr.kernel_map(),
               "component_table": attr.component_table()}
    if extra:
        payload.update(extra)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return payload
