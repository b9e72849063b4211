"""Checkpoints of the port's trainer: ``torch.save`` files under the
reference's directory contract ``<logdir>/checkpoints/<step>/``, with
the API of ``eksml_tpu/utils/checkpoint.py`` (which wraps Orbax):
``save(step, state, force)``, ``latest_step``, ``all_steps``,
``restore``, ``restore_with_fallback``, ``wait`` and ``close``.

What a step holds: one file, ``state.pt``, of the dict the trainer
hands in (``{"step", "model": state_dict, "optimizer": state_dict,
"generator": the priority generator's get_state()}``), read back with
``torch.load(weights_only=True)``.

Save.  ``torch.optim.SGD`` updates the parameters and momentum buffers
IN PLACE, so a writer holding references to the live tensors would
write a mixture of steps.  :meth:`save` therefore copies every tensor
to host memory before it returns (CUDA tensors through pinned buffers,
one synchronize); that copy is the blocking part, the reference's
``checkpoint_save_ms``.  Only the file write overlaps the next steps:
one background thread writes ``.tmp-<step>-<random>/state.pt``, fsyncs
it, renames the directory to ``<step>`` (the commit) and only then
writes the step's integrity and topology manifests
(``resilience/integrity.py``).  Saves are serialized: a save first
waits for the previous write.  The newest ``max_to_keep`` steps stay.

Restore.  :meth:`restore_with_fallback` walks back from the newest
step that verifies against its manifest; a step that fails to load and
had no readable manifest is quarantined (renamed out of the digit
namespace), while a VERIFIED step that fails to load raises — that
points at a systematic problem (a changed model or optimizer), and
quarantining would destroy every good checkpoint one by one.  A step
saved on another topology (``parallel/topology.py``: another world size,
strategy or card) restores after the difference is logged, unless
``elastic`` is off.

Under a process group a step is still one file of whole tensors, with
the same keys at any world size or strategy.  Every rank builds the
state (under FSDP2 :func:`full_state_dict` and :func:`full_optimizer_state`
all-gather each shard), only the coordinator writes the step and its
manifests, and a restore is a collective: every rank drains its writes
and passes a barrier, the coordinator alone walks, verifies, quarantines
and reads, the chosen step (or the coordinator's error) is broadcast,
and ``load_into`` runs on every rank with the state on the coordinator
and ``None`` elsewhere (:func:`load_full_state` broadcasts it from
there into each rank's live tensors and shards).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from eksml_tpu_torch import telemetry
from eksml_tpu_torch.parallel import topology as topo_mod
from eksml_tpu_torch.parallel.distributed import (barrier, broadcast_object,
                                                  is_coordinator)
from eksml_tpu_torch.resilience import integrity

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def snapshot_to_host(obj: Any) -> Any:
    """A copy of ``obj`` (nested dicts, lists and tuples of tensors and
    plain values) whose tensors all lie in host memory and share no
    storage with the originals.  CUDA tensors go through pinned buffers
    with one synchronize at the end."""
    cuda = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cpu":
                return x.clone()
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            cuda.append(x.device)
            return host
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    out = walk(obj)
    for dev in set(cuda):
        torch.cuda.synchronize(dev)
    return out


def tensor_bytes(obj: Any) -> int:
    """Bytes of every tensor in a nested state."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (an all-gather), ``t`` otherwise."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def full_state_dict(module: torch.nn.Module) -> dict:
    """``module.state_dict()`` with whole tensors (under FSDP2 a
    collective: every rank gathers every shard, in one order)."""
    return {k: _whole(v) for k, v in module.state_dict().items()}


def full_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` (parameters numbered, as PyTorch saves
    it) with whole tensors (a collective under FSDP2)."""
    sd = optimizer.state_dict()
    return {"state": {i: {k: _whole(v) if isinstance(v, torch.Tensor) else v
                          for k, v in s.items()}
                      for i, s in sd["state"].items()},
            "param_groups": sd["param_groups"]}


def _local_chunk(full: torch.Tensor, dt) -> torch.Tensor:
    """This rank's part of ``full`` under the placements of the DTensor
    ``dt`` (FSDP2 shards split as ``torch.chunk`` does, trailing ranks
    possibly empty)."""
    coord = dt.device_mesh.get_coordinate()
    for i, placement in enumerate(dt.placements):
        if placement.is_shard():
            chunks = torch.chunk(full, dt.device_mesh.size(i),
                                 dim=placement.dim)
            full = (chunks[coord[i]] if coord[i] < len(chunks)
                    else full.narrow(placement.dim, 0, 0))
    return full


@torch.no_grad()
def _broadcast_into(live: torch.Tensor, saved: Optional[torch.Tensor]
                    ) -> None:
    """Rank 0's ``saved`` (whole) into ``live`` on every rank: the whole
    tensor is broadcast, each rank keeps its part."""
    local = live.to_local() if hasattr(live, "to_local") else live
    full = torch.empty(live.shape, dtype=live.dtype, device=local.device)
    if saved is not None:
        full.copy_(saved)
    dist.broadcast(full, 0)
    local.copy_(_local_chunk(full, live) if hasattr(live, "to_local")
                else full)


def load_full_state(module: torch.nn.Module, model_sd: Optional[dict],
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    optim_sd: Optional[dict] = None) -> None:
    """Rank 0's whole ``model_sd`` and, with ``optimizer``, ``optim_sd``
    (a :func:`full_state_dict` / :func:`full_optimizer_state` read back;
    ignored, and may be ``None``, on the other ranks) into every rank's
    live module and optimizer, each rank keeping its shards (optimizer
    state tensors are shaped like their parameters, as SGD's momentum).
    A collective; the caller checked names and shapes on rank 0 first."""
    for name, live in module.state_dict().items():
        _broadcast_into(live, model_sd[name] if model_sd is not None
                        else None)
    if optimizer is None:
        return
    meta = None
    if optim_sd is not None:
        meta = {
            "state": {i: {k: (("tensor", tuple(v.shape))
                              if isinstance(v, torch.Tensor) else
                              ("value", v)) for k, v in s.items()}
                      for i, s in optim_sd["state"].items()},
            "groups": [{k: v for k, v in g.items() if k != "params"}
                       for g in optim_sd["param_groups"]]}
    meta = broadcast_object(meta)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    optimizer.state.clear()
    for i, entries in meta["state"].items():
        p = params[i]
        st = {}
        for k, (kind, value) in entries.items():
            if kind == "tensor":
                if value != tuple(p.shape):
                    raise ValueError(
                        f"optimizer state {i}.{k} is {value}, not shaped "
                        f"like its parameter {tuple(p.shape)}")
                st[k] = torch.empty_like(p)
                _broadcast_into(st[k], optim_sd["state"][i][k]
                                if optim_sd is not None else None)
            else:
                st[k] = value
        optimizer.state[p] = st
    for group, saved in zip(optimizer.param_groups, meta["groups"]):
        group.update(saved)


class CheckpointManager:
    """``<logdir>/checkpoints/<step>/state.pt`` with integrity manifests.

    ``topology``: the current launch's descriptor
    (``parallel/topology.current_topology``), persisted next to each
    step's integrity manifest and compared at restore time; ``None``
    (readers that never cross topologies) disables both.
    ``elastic``: ``RESILIENCE.ELASTIC_RESUME`` — restore a step saved on
    another topology (logged) instead of refusing it.

    After a save, ``last_save`` holds ``blocking_ms`` (the host copy)
    and ``bytes``; once the background write finished, ``write_ms`` (the
    file write, fsync and commit).  ``last_restore_ms`` is the whole
    walk of the last :meth:`restore_with_fallback`."""

    def __init__(self, logdir: str, max_to_keep: int = 5,
                 digest: bool = False, topology: Optional[dict] = None,
                 elastic: bool = True):
        self.directory = os.path.join(os.path.abspath(logdir), "checkpoints")
        self.max_to_keep = max(1, int(max_to_keep))
        self.digest = bool(digest)
        self.topology = (topo_mod.normalize(topology)
                         if topology is not None else None)
        self.elastic = bool(elastic)
        self.last_save: dict = {}
        self.last_restore_ms: Optional[float] = None
        self._writer: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None

    # -- save ----------------------------------------------------------

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Snapshot ``state`` to host memory and commit it as ``step`` in
        the background.  Returns False (nothing written) when ``step`` is
        already committed, unless ``force``, which rewrites it, and on
        every rank but the coordinator, which alone writes."""
        if not is_coordinator():
            return False
        t0 = time.perf_counter()
        # the span is the step loop's blocking part (host copy); the
        # background write is not in it
        with telemetry.span("checkpoint_save", step=step):
            self._drain()
            if not force and step in self.all_steps():
                return False
            snap = snapshot_to_host(state)
        blocking_ms = (time.perf_counter() - t0) * 1e3
        self.last_save = {"step": int(step), "blocking_ms": blocking_ms,
                          "bytes": tensor_bytes(snap)}
        if self._writer is None:
            self._writer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="eksml-checkpoint")
        self._pending = self._writer.submit(self._write, int(step), snap)
        telemetry.default_registry().counter(
            "eksml_checkpoint_saves", "checkpoint commits started").inc()
        telemetry.default_registry().histogram(
            "eksml_checkpoint_save_ms",
            "step-loop blocking time of a checkpoint save (host copy)"
        ).observe(blocking_ms)
        telemetry.event("checkpoint_save", step=step, forced=bool(force),
                        save_ms=round(blocking_ms, 1))
        return True

    def _write(self, step: int, snap: Any) -> None:
        """Background: write, fsync, commit by rename, then manifests."""
        t0 = time.perf_counter()
        os.makedirs(self.directory, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
        # the file lies in a fresh temporary directory: the os.replace of
        # that directory below is the atomic commit
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:  # eksml-lint: disable=atomic-write
            torch.save(snap, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):           # a forced rewrite
            old = f"{tmp}.old"
            os.replace(final, old)
            shutil.rmtree(old, ignore_errors=True)
        os.replace(tmp, final)              # the commit
        dfd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        if self.topology is not None:
            integrity.write_topology_manifest(self.directory, step,
                                              self.topology)
        integrity.write_manifest(self.directory, step, digest=self.digest)
        steps = self.all_steps()
        for old_step in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old_step)),
                          ignore_errors=True)
        integrity.prune_manifests(self.directory,
                                  steps[-self.max_to_keep:])
        self.last_save["write_ms"] = (time.perf_counter() - t0) * 1e3

    def _drain(self) -> None:
        """Wait for the in-flight write; re-raise its failure."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    # -- discovery -----------------------------------------------------

    def all_steps(self) -> List[int]:
        """Committed steps (digit directories), ascending."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore -------------------------------------------------------

    def restore(self, step: Optional[int] = None,
                mmap: bool = False) -> Optional[Any]:
        """The saved state of ``step`` (default: the latest) on the CPU,
        or None when nothing is committed.  ``mmap``: map the file
        (copy-on-write) instead of reading it, so that only the tensors
        the caller touches are read."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self.directory, str(step), STATE_FILE)
        with telemetry.span("checkpoint_restore", step=step):
            return torch.load(path, map_location="cpu", weights_only=True,
                              mmap=mmap)

    def restore_with_fallback(
            self, load_into: Optional[Callable[[Any], None]] = None
    ) -> Optional[Tuple[Any, int]]:
        """Restore the newest step that passes integrity verification,
        loads, and (when given) is accepted by ``load_into(state)``;
        walk back through older steps on failure.  Returns ``(state,
        step)``, or None when no step is restorable (start fresh).

        A step fails corruption-style (quarantined, walk back) when it
        fails verification, or fails to load without a readable manifest
        to prove it whole.  A step that verified intact against its
        manifest and still fails raises: a systematic mismatch.

        Under a process group this is a collective (module docstring):
        the coordinator walks and reads, ``load_into`` runs on every rank
        (``None`` for the state off the coordinator, which is also what
        they return), and a failure on the coordinator raises on all."""
        self.wait()
        if not dist.is_initialized():
            return self._walk(load_into)
        barrier()       # every rank's view of the commits is the same
        found, err = None, None
        if is_coordinator():
            try:
                found = self._walk(None)
            except Exception as e:  # noqa: BLE001 — re-raised on every rank
                err = f"{type(e).__name__}: {e}"
        step, err = broadcast_object(
            (found[1] if found is not None else None, err))
        if err is not None:
            raise RuntimeError(
                f"checkpoint restore failed on the coordinator: {err}")
        if step is None:
            return None
        state = found[0] if found is not None else None
        if load_into is not None:
            load_into(state)
        return state, step

    def _walk(self, load_into) -> Optional[Tuple[Any, int]]:
        """The newest step that verifies, loads and is accepted by
        ``load_into`` (walking back), read by this process alone."""
        t0 = time.perf_counter()
        tried = set()
        while True:
            step = self._newest_verified()
            if step is None:
                return None
            if step in tried:
                # quarantine could not move the step aside (read-only
                # or stale filesystem): stop instead of looping
                raise RuntimeError(
                    f"checkpoint step {step} keeps failing restore and "
                    "could not be quarantined — giving up instead of "
                    "looping. Inspect/remove "
                    f"{os.path.join(self.directory, str(step))} manually.")
            tried.add(step)
            saved_topo = integrity.read_topology_manifest(self.directory,
                                                          step)
            mismatch = bool(self.topology is not None
                            and saved_topo is not None
                            and not topo_mod.compatible(saved_topo,
                                                        self.topology))
            if mismatch and not self.elastic:
                raise RuntimeError(
                    f"checkpoint step {step} was saved on a different "
                    f"topology than this launch "
                    f"({topo_mod.diff(saved_topo, self.topology)}) and "
                    "RESILIENCE.ELASTIC_RESUME is off. Set it to True to "
                    "restore across the change, or relaunch on the saved "
                    f"topology ({topo_mod.describe(saved_topo)}).")
            try:
                state = self.restore(step)
                if load_into is not None:
                    load_into(state)
            except Exception as e:  # noqa: BLE001 — the walk-back decides
                err = e
            else:
                self.last_restore_ms = (time.perf_counter() - t0) * 1e3
                telemetry.default_registry().counter(
                    "eksml_checkpoint_restores",
                    "checkpoint restores completed").inc()
                telemetry.event("checkpoint_restore", step=step,
                                restore_ms=round(self.last_restore_ms, 1))
                if mismatch:
                    d = topo_mod.diff(saved_topo, self.topology)
                    log.warning("checkpoint step %d restored across a "
                                "topology change (%s)", step, d)
                    telemetry.event("checkpoint_topology_changed",
                                    step=step, diff=d)
                return state, step
            if integrity.manifest_readable(self.directory, step):
                raise RuntimeError(
                    f"checkpoint step {step} verified intact against its "
                    f"integrity manifest but failed to load ({err!r}): a "
                    "systematic restore failure (changed model or "
                    "optimizer structure) — refusing to quarantine "
                    "verified checkpoints. Fix the mismatch or restore an "
                    "explicit step.") from err
            log.warning("checkpoint restore of step %d failed (%r) — "
                        "falling back to an earlier step", step, err)
            telemetry.default_registry().counter(
                "eksml_checkpoint_fallbacks",
                "checkpoint integrity walk-backs").inc()
            telemetry.event("checkpoint_fallback", step=step,
                            error=repr(err))
            self._quarantine(step)

    def _newest_verified(self) -> Optional[int]:
        """Newest step that passes :func:`integrity.verify_step`;
        quarantines every newer one that fails."""
        for s in reversed(self.all_steps()):
            ok, reason = integrity.verify_step(self.directory, s)
            if ok:
                log.info("checkpoint integrity: %s", reason)
                return s
            log.warning("checkpoint integrity: %s — falling back to an "
                        "earlier step", reason)
            self._quarantine(s)
        return None

    def _quarantine(self, step: int) -> None:
        integrity.quarantine_step(self.directory, step)
        telemetry.event("checkpoint_quarantined", step=step)

    # -- lifecycle -----------------------------------------------------

    def wait(self) -> None:
        """Land the in-flight write (re-raising its failure)."""
        self._drain()

    def close(self) -> None:
        self.wait()
        if self._writer is not None:
            self._writer.shutdown(wait=True)
            self._writer = None
