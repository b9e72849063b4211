"""Process groups from the JobSet environment (the port of
``eksml_tpu/parallel/distributed.py``).

The reference runs one process per TPU host and rendezvouses through
``jax.distributed.initialize``; the port runs one process per GPU and
rendezvouses through ``torch.distributed.init_process_group``.  The
JobSet env contract stays the reference's, with two additions for the
processes of one host:

  COORDINATOR_ADDRESS  host:port of replica 0's rank 0
  NUM_PROCESSES        host processes (pods) across ALL slices
  PROCESS_ID           this pod's index (single-slice form), or
  SLICE_INDEX +        the Multislice form: SLICE_INDEX ·
  PROCS_PER_SLICE +      PROCS_PER_SLICE + JOB_COMPLETION_INDEX
  JOB_COMPLETION_INDEX   (slice-major, as the reference)
  LOCAL_RANK           this process's GPU on its host (default 0)
  LOCAL_WORLD_SIZE     processes per host (default 1)

The global rank is ``host_rank · LOCAL_WORLD_SIZE + LOCAL_RANK``, the
world size ``NUM_PROCESSES · LOCAL_WORLD_SIZE`` and the device
``cuda:LOCAL_RANK``.  A slice (``TPU.NUM_SLICES``) maps to a node: one
NVLink domain, with the inter-node network as the DCN hop.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def _rank_from_env(env: Mapping[str, str]) -> int:
    """Global HOST rank from the JobSet env (the reference's function,
    unchanged).

    Single-slice: ``PROCESS_ID`` (the completion index) is the rank.
    Multislice: each slice is its own replicated Job, so pods carry a
    per-slice completion index plus the Job's slice index — the global
    rank is ``SLICE_INDEX · PROCS_PER_SLICE + JOB_COMPLETION_INDEX``
    (slice-major, matching build_mesh's slice-major device order)."""
    if "PROCESS_ID" in env:
        return int(env["PROCESS_ID"])
    if "SLICE_INDEX" in env:
        # Fail fast on a partial Multislice env: silently falling
        # through to the bare per-slice completion index would collide
        # ranks across slices at rendezvous — a hang at initialize(),
        # hours later, with no pointer to the bad chart.
        if "PROCS_PER_SLICE" not in env:
            raise RuntimeError(
                "SLICE_INDEX is set but PROCS_PER_SLICE is not: the "
                "Multislice rank is SLICE_INDEX*PROCS_PER_SLICE + "
                "JOB_COMPLETION_INDEX; a partial env would collide "
                "ranks across slices. Fix the JobSet template env.")
        return (int(env["SLICE_INDEX"]) * int(env["PROCS_PER_SLICE"])
                + int(env.get("JOB_COMPLETION_INDEX", "0")))
    return int(env.get("JOB_COMPLETION_INDEX", "0"))


def local_rank(env: Optional[Mapping[str, str]] = None) -> int:
    """This process's GPU on its host (``LOCAL_RANK``, default 0)."""
    return int((os.environ if env is None else env).get("LOCAL_RANK", "0"))


def local_world_size(env: Optional[Mapping[str, str]] = None) -> int:
    """Processes per host (``LOCAL_WORLD_SIZE``, default 1)."""
    return int((os.environ if env is None else env).get(
        "LOCAL_WORLD_SIZE", "1"))


def world_and_rank(num_processes: int, host_rank: int,
                   env: Optional[Mapping[str, str]] = None):
    """``(world_size, rank)`` of this process: ``NUM_PROCESSES ·
    LOCAL_WORLD_SIZE`` and ``host_rank · LOCAL_WORLD_SIZE + LOCAL_RANK``."""
    per_host, lr = local_world_size(env), local_rank(env)
    if not 0 <= lr < per_host:
        raise ValueError(f"LOCAL_RANK={lr} is outside LOCAL_WORLD_SIZE="
                         f"{per_host}")
    return int(num_processes) * per_host, int(host_rank) * per_host + lr


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU; raises where
    the backend cannot serve the device (never a silent switch)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} needs the NCCL backend, but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "for a gloo group on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch build has no NCCL backend; "
                               "a CUDA run does not fall back to gloo")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {str(dev)!r}")


def _check_backend(device) -> None:
    want = backend_for(device)
    have = str(dist.get_backend()).lower()
    if want not in have:
        raise RuntimeError(
            f"the process group already initialised uses the {have!r} "
            f"backend, but device {str(torch.device(device))!r} needs "
            f"{want!r}")


def _shutdown_partial_init() -> None:
    """Best-effort teardown between rendezvous retries: a failed
    ``init_process_group`` can leave a half-built default group that
    makes the next attempt fail with 'already initialized'."""
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — nothing usable was built
            log.debug("teardown of a partial process group failed",
                      exc_info=True)


def initialize_from_env(cfg=None, device="cuda") -> bool:
    """Start the default process group when the env names more than one
    rank and a coordinator address; otherwise do nothing.  Idempotent,
    and accepts a group the caller initialised (its backend must fit
    ``device``).  Returns whether a group is up.

    ``cfg`` supplies ``TPU.COORDINATOR_ADDRESS``, ``TPU.NUM_PROCESSES``,
    ``TPU.PROCESS_ID`` (``config_from_env`` fills them from the env) and
    the retry policy ``RESILIENCE.INIT_RETRIES`` / ``INIT_BACKOFF_SEC``;
    without it the env is read directly.  ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` always come from the env.  JobSet pods start in
    any order, so the rendezvous is retried with exponential backoff,
    tearing down between attempts, and exhaustion raises one actionable
    error."""
    if dist.is_initialized():
        _check_backend(device)
        return True
    if cfg is not None:
        coord = cfg.TPU.COORDINATOR_ADDRESS
        nproc = int(cfg.TPU.NUM_PROCESSES)
        host = int(cfg.TPU.PROCESS_ID)
        retries = int(cfg.RESILIENCE.INIT_RETRIES)
        backoff = float(cfg.RESILIENCE.INIT_BACKOFF_SEC)
    else:
        coord = os.environ.get("COORDINATOR_ADDRESS", "")
        nproc = int(os.environ.get("NUM_PROCESSES", "1"))
        host = _rank_from_env(os.environ)
        # one source of truth for the retry policy: the RESILIENCE
        # defaults (env can still override per pod)
        from eksml_tpu_torch.config import config as defaults

        retries = int(os.environ.get("EKSML_INIT_RETRIES",
                                     defaults.RESILIENCE.INIT_RETRIES))
        backoff = float(os.environ.get("EKSML_INIT_BACKOFF_SEC",
                                       defaults.RESILIENCE.INIT_BACKOFF_SEC))
    world, rank = world_and_rank(nproc, host)
    if world <= 1 or not coord:
        log.info("single-process run (world size %d)", world)
        return False
    backend = backend_for(device)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
        kwargs["device_id"] = torch.device("cuda", local_rank())
    log.info("torch.distributed.init_process_group(%s, tcp://%s, "
             "world_size=%d, rank=%d)", backend, coord, world, rank)

    from eksml_tpu_torch.resilience.retry import retry_call

    try:
        retry_call(
            lambda: dist.init_process_group(
                backend, init_method=f"tcp://{coord}", world_size=world,
                rank=rank, **kwargs),
            attempts=retries, backoff_sec=backoff,
            describe=f"distributed rendezvous with {coord}",
            cleanup=_shutdown_partial_init)
    except RuntimeError as e:
        raise RuntimeError(
            f"could not rendezvous with the coordinator at {coord} "
            f"(rank={rank}, world_size={world}): {e}. Check that the "
            "JobSet headless Service resolves, that the replica-0 pod is "
            "Running, and that COORDINATOR_ADDRESS / NUM_PROCESSES / "
            "PROCESS_ID (or the Multislice SLICE_INDEX / PROCS_PER_SLICE "
            "/ JOB_COMPLETION_INDEX) and LOCAL_RANK / LOCAL_WORLD_SIZE "
            "match the chart's rendering for every pod.") from e
    return True


def shutdown() -> None:
    """Tear the default group down (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """Ranks in the run (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's global rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on rank 0, which owns the metrics, the checkpoint writes and
    the restore's walk — the role the reference's launcher pod had."""
    return process_index() == 0


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current CUDA device under NCCL, the CPU under gloo."""
    if dist.is_initialized() and "nccl" in str(dist.get_backend()).lower():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_object(obj):
    """``obj`` from rank 0 on every rank (identity without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=collective_device())
    return box[0]


def barrier() -> None:
    """Every rank waits for all (no-op without a group)."""
    if dist.is_initialized():
        if "nccl" in str(dist.get_backend()).lower():
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
