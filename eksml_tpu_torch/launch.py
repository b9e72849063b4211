"""``python -m eksml_tpu_torch.launch``: the ranks of one pod, one process
per GPU.

The reference runs one process per TPU host, which owns the host's chips.
The port runs one process per GPU, so the GPU training chart's container
runs this launcher, and it starts ``--nproc-per-node`` copies of ``python3
-m <module> <args>``.  Each copy gets the pod's env (the JobSet contract of
``parallel/distributed.py``: ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``) plus ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK=r``, so its
global rank is ``PROCESS_ID x nproc + r`` and its device ``cuda:r``.

- Each rank's output goes to the launcher's stdout, every line prefixed
  ``[rank r]``; a drain thread per rank keeps its pipe from filling up.
- SIGTERM (kubelet's, at a pod deletion or a preemption) and SIGINT go to
  every rank process, and the launcher waits for them: the trainer takes
  its forced checkpoint and exits ``RESILIENCE.PREEMPT_EXIT_CODE``.  A
  rank still running ``--stop-budget`` seconds after the signal is
  SIGKILLed; the chart sets the budget below its
  ``terminationGracePeriodSeconds``.
- When a rank ends on its own, the job has ended: a failed rank stops the
  others at once; after a clean exit the others get ``FINISH_GRACE_S``
  seconds to finish on their own first (ranks leave the last collective
  together, but one may still be writing its checkpoint).
- The launcher exits with :func:`job_exit_code` of the ranks: 77 only
  when every rank exited 77 (the podFailurePolicy then restarts the job
  without spending a restart), 0 only when every rank exited 0, else the
  failing rank's code (``128 + n`` for a rank killed by signal n).

Not ``torchrun``: its agent turns a rank's 77 into its own 1, and it runs a
second rendezvous beside the JobSet env's.

Usage::

    python3 -m eksml_tpu_torch.launch --nproc-per-node 8 \\
        eksml_tpu_torch.train --logdir /efs/run --config ...
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import BinaryIO, List, Mapping, Optional, Sequence

log = logging.getLogger("eksml_tpu_torch.launch")

#: seconds the other ranks get to end on their own after one exits 0
FINISH_GRACE_S = 120.0


def job_exit_code(codes: Sequence[Optional[int]],
                  preempt_code: int) -> Optional[int]:
    """One exit code for the ranks of one job.

    Every rank agrees on a preemption (the forced checkpoint is taken at
    the same step on all of them), so the job is resumable only if EVERY
    rank exited ``preempt_code``, and done only if every rank exited 0.
    Anything else is a failure: the first rank's code that is neither
    (a crash, or a signal's negative code), else 1 for a mix of 0 and
    ``preempt_code``.  Rank 0 alone proves nothing."""
    if not codes:
        return None
    if all(c == preempt_code for c in codes):
        return preempt_code
    if all(c == 0 for c in codes):
        return 0
    for c in codes:
        if c not in (0, preempt_code):
            return c if c is not None else 1
    return 1


def _drain(pipe: BinaryIO, prefix: bytes, out: BinaryIO,
           lock: threading.Lock) -> None:
    """Copy ``pipe`` to ``out`` line by line, each line after ``prefix``."""
    with pipe:
        for line in iter(pipe.readline, b""):
            with lock:
                out.write(prefix + line)
                out.flush()


class RankGroup:
    """The rank processes of one job on this host: started together,
    stopped together, every one reaped.

    ``start`` runs one process of ``cmd`` per env; each writes to its own
    log file, or with no files to this process's stdout behind a ``[rank
    r]`` prefix.  ``stop`` is the forced-checkpoint path:
    SIGTERM to every running rank, SIGKILL to one still running
    ``stop_budget`` seconds later.  ``poll`` ends the job once a rank has
    ended on its own (after ``finish_grace`` seconds when every rank that
    ended exited 0)."""

    def __init__(self, stop_budget: float = 600.0, preempt_exit_code: int = 77,
                 finish_grace: float = 0.0):
        self.stop_budget = float(stop_budget)
        self.preempt_exit_code = int(preempt_exit_code)
        self.finish_grace = float(finish_grace)
        # the ranks' exit codes at the last stop, and when its SIGTERM went
        self.last_exit_codes: List[Optional[int]] = []
        self.last_sigterm_t: Optional[float] = None
        self._procs: List[subprocess.Popen] = []
        self._drains: List[threading.Thread] = []
        self._first_end: Optional[float] = None
        self._out_lock = threading.Lock()

    def start(self, cmd: Sequence[str], envs: Sequence[Mapping[str, str]],
              logs: Optional[Sequence[str]] = None,
              cwd: Optional[str] = None) -> None:
        if self.running:
            raise RuntimeError("start while the previous ranks run")
        self._procs, self._drains, self._first_end = [], [], None
        for rank, env in enumerate(envs):
            if logs is not None:
                with open(logs[rank], "a") as logf:  # the child keeps the fd
                    self._procs.append(subprocess.Popen(
                        list(cmd), env=dict(env), cwd=cwd, stdout=logf,
                        stderr=subprocess.STDOUT))
                continue
            proc = subprocess.Popen(list(cmd), env=dict(env), cwd=cwd,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            drain = threading.Thread(
                target=_drain, name=f"rank{rank}-output", daemon=True,
                args=(proc.stdout, f"[rank {rank}] ".encode(),
                      sys.stdout.buffer, self._out_lock))
            drain.start()
            self._procs.append(proc)
            self._drains.append(drain)

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    @property
    def running(self) -> bool:
        return any(p.poll() is None for p in self._procs)

    def poll(self) -> Optional[int]:
        """None while every rank runs (or before start).  Once a rank has
        ended on its own the job has ended: the rest are stopped
        (:meth:`stop`) and the job's exit code is answered."""
        if not self._procs:
            return None
        ended = [c for c in (p.poll() for p in self._procs) if c is not None]
        if not ended:
            return None
        if len(ended) < len(self._procs) and self.finish_grace > 0 and \
                all(c == 0 for c in ended):
            now = time.monotonic()
            if self._first_end is None:
                self._first_end = now
            if now - self._first_end < self.finish_grace:
                return None
        return self.stop()

    def stop(self, budget: Optional[float] = None) -> Optional[int]:
        """SIGTERM every running rank, then wait.  A rank still running past
        ``budget`` seconds (default ``stop_budget``) is SIGKILLed; every
        rank is reaped.  Returns :func:`job_exit_code` of the ranks (None
        before any start); ``last_exit_codes`` keeps each rank's."""
        if not self._procs:
            return None
        budget = self.stop_budget if budget is None else float(budget)
        self.last_sigterm_t = time.time()
        for p in self._procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + budget
        for p in self._procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        late = [p for p in self._procs if p.poll() is None]
        if late:
            log.warning("%d rank(s) ignored SIGTERM for %.0fs: SIGKILL",
                        len(late), budget)
            for p in late:
                p.kill()
        for p in self._procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        # the ranks' last lines (a child of a rank may hold its pipe open)
        for t in self._drains:
            t.join(timeout=5)
        self.last_exit_codes = [p.poll() for p in self._procs]
        self._procs, self._drains = [], []
        return job_exit_code(self.last_exit_codes, self.preempt_exit_code)


def rank_envs(nproc: int, base: Optional[Mapping[str, str]] = None):
    """The env of each of ``nproc`` local ranks: ``base`` (default: this
    process's) plus ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK``."""
    base = dict(os.environ if base is None else base)
    return [dict(base, LOCAL_WORLD_SIZE=str(nproc), LOCAL_RANK=str(r))
            for r in range(nproc)]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python3 -m eksml_tpu_torch.launch",
        description=__doc__.splitlines()[0])
    p.add_argument("--nproc-per-node", type=int, required=True,
                   help="ranks on this node, one per GPU")
    p.add_argument("--stop-budget", type=float, default=270.0,
                   help="seconds a rank may take after SIGTERM before "
                        "SIGKILL (keep below the pod's "
                        "terminationGracePeriodSeconds)")
    p.add_argument("--preempt-exit-code", type=int, default=77,
                   help="the ranks' resumable exit code "
                        "(RESILIENCE.PREEMPT_EXIT_CODE)")
    p.add_argument("module", help="the module each rank runs with -m")
    p.add_argument("args", nargs=argparse.REMAINDER,
                   help="the module's arguments")
    args = p.parse_args(argv)
    if args.nproc_per_node < 1:
        p.error("--nproc-per-node must be at least 1")
    return args


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = parse_args(argv)
    stop = threading.Event()
    got: List[int] = []

    def _on_signal(signum, frame):  # noqa: ARG001 — signal API
        got.append(signum)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    group = RankGroup(stop_budget=args.stop_budget,
                      preempt_exit_code=args.preempt_exit_code,
                      finish_grace=FINISH_GRACE_S)
    cmd = [sys.executable, "-m", args.module] + list(args.args)
    group.start(cmd, rank_envs(args.nproc_per_node))
    log.info("started %d rank(s) of python -m %s: pids %s",
             args.nproc_per_node, args.module, group.pids)
    rc = None
    # a timed wait: the handler runs only when the main thread runs
    while rc is None and not stop.wait(timeout=0.2):
        rc = group.poll()
    if rc is None:
        log.info("signal %d: stopping every rank (SIGKILL after %.0f s)",
                 got[0], args.stop_budget)
        rc = group.stop()
    log.info("ranks exited %s: job exit code %s", group.last_exit_codes, rc)
    return 128 - rc if rc < 0 else rc


if __name__ == "__main__":
    sys.exit(main())
