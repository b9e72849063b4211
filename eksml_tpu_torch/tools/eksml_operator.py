"""Elastic autoscaling operator: actuate the pure scale policy (the port
of ``tools/eksml_operator.py``).

One tick = read capacity from a pluggable provider → scrape the
trainer's ``/metrics`` for health (goodput ratio, badput buckets,
preemption and straggler series) → one ``decide()``
(``resilience/autoscale.py``) → actuate.  Every transition goes through
the forced-checkpoint path the trainer already proves: SIGTERM → every
rank checkpoints at the same step boundary (the preemption agreement)
and exits ``RESILIENCE.PREEMPT_EXIT_CODE`` (77) → relaunch at the
decided topology → elastic resume reshards the restore.  The operator
never stops a trainer any other way, short of SIGKILL past
``--stop-budget``.

Two actuation modes:

- ``--mode local``: the operator owns the ranks of one ``python -m
  eksml_tpu_torch.train`` job, one process per GPU, formed into a group
  by the JobSet env (``LocalTrainerActuator``).  ``--device cuda`` (the
  default) puts rank r on ``cuda:r`` and refuses a rung with more ranks
  than visible cards; ``--device cpu`` runs the ranks as a gloo group on
  the CPU (the tests' and the CPU rehearsal's way).
- ``--mode kubectl``: in-cluster; the transition is a JobSet annotation
  patch (the decided topology) plus a graceful pod deletion: kubelet
  delivers the SIGTERM, the chart's podFailurePolicy maps exit 77 to a
  restart, and the relaunch resumes elastically.  The serve fleet scales
  through ``kubectl scale`` off the scraped ``eksml_serve_queue_depth``
  (the active half of the serve chart's HPA).

Capacity providers: ``--capacity-file`` (JSON ``{"available_chips": N,
"preemption_forecast": 0.x}``), ``--capacity-env``
(``EKSML_AVAILABLE_CHIPS``), or kubectl (the ``--capacity-resource``
allocatable of Ready nodes, ``nvidia.com/gpu`` by default).  A torn or
missing signal is a recorded hold, never a crash.

``--promote`` runs the canary promotion controller instead: each tick
shadow-replays a recorded request bank at the stable and the canary
serving tracks (``serve_loadtest.replay_shadow``), rolls the canary back
at the first breached gate and promotes its step to the stable track
after ``CANARY_PROMOTE_STREAK`` clean scores.

Evidence trail:

- flight events → ``<logdir>/events-hostop.jsonl`` (operator) and
  ``events-hostcd.jsonl`` (promotion controller);
- ``eksml_autoscale_*`` / ``eksml_serve_canary_*`` series on the
  operator's own ``/metrics`` (port 0 → ``telemetry-operator.port`` /
  ``telemetry-promoter.port``), preregistered at start;
- every decision banked to ``<logdir>/autoscale-host<i>.jsonl``, every
  canary verdict to ``canary-host0.jsonl``.

Usage::

    python -m eksml_tpu_torch.tools.eksml_operator --logdir /efs/run1 \\
        --mode kubectl --jobset maskrcnn --namespace kubeflow \\
        --config RESILIENCE.AUTOSCALE.CHIP_OPTIONS="(8,16)"
    python -m eksml_tpu_torch.tools.eksml_operator --logdir /tmp/run \\
        --mode local --capacity-file /tmp/capacity.json --device cpu \\
        --synthetic --global-batch 2 --config \\
        RESILIENCE.AUTOSCALE.CHIP_OPTIONS="(1,2)"
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import signal
import socket
import subprocess
import sys
import time
from dataclasses import asdict, replace
from typing import Dict, List, Optional, Sequence, Tuple

from eksml_tpu_torch.config import (RESILIENCE_AUTOSCALE_DEFAULTS,
                                    SHARDING_DEFAULTS, config,
                                    knobs_with_defaults)
from eksml_tpu_torch.resilience.autoscale import (ACTIONS, CapacitySignal,
                                                  HealthSignal, PolicyParams,
                                                  PolicyState, ScaleDecision,
                                                  Topology, decide,
                                                  serve_replicas,
                                                  topology_ladder)
from eksml_tpu_torch.telemetry.exporter import TelemetryExporter
from eksml_tpu_torch.telemetry.recorder import FlightRecorder
from eksml_tpu_torch.telemetry.registry import MetricRegistry
from eksml_tpu_torch.tools import serve_loadtest

log = logging.getLogger("eksml_operator")

#: the repository root: the trainer ranks start here (``python -m``)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the operator's flight events land in their own per-"host" file: the
# goodput ledger keeps reading the trainer's events-host0.jsonl, and two
# processes never append to one file
OPERATOR_HOST = "op"

#: JobSet env names that would give a rank another identity than the
#: actuator's LOCAL_RANK (``parallel/distributed.py``)
_RANK_ENV = ("PROCESS_ID", "SLICE_INDEX", "PROCS_PER_SLICE",
             "JOB_COMPLETION_INDEX")


# ---------------------------------------------------------------------
# capacity providers (pluggable; every failure degrades to None)
# ---------------------------------------------------------------------


class FileCapacityProvider:
    """JSON file stub: the local/dev signal and a capacity wave's source.
    ``{"available_chips": 8, "preemption_forecast": 0.1}``."""

    def __init__(self, path: str):
        self.path = path

    def read(self) -> Optional[CapacitySignal]:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            return CapacitySignal(
                int(doc["available_chips"]),
                float(doc.get("preemption_forecast", 0.0)))
        except (OSError, ValueError, TypeError, KeyError):
            return None  # torn mid-rewrite or absent: a recorded hold


class EnvCapacityProvider:
    """``EKSML_AVAILABLE_CHIPS`` / ``EKSML_PREEMPTION_FORECAST``."""

    def __init__(self, var: str = "EKSML_AVAILABLE_CHIPS",
                 forecast_var: str = "EKSML_PREEMPTION_FORECAST"):
        self.var, self.forecast_var = var, forecast_var

    def read(self) -> Optional[CapacitySignal]:
        raw = os.environ.get(self.var)
        if raw is None:
            return None
        try:
            return CapacitySignal(
                int(raw),
                float(os.environ.get(self.forecast_var, "0") or 0))
        except ValueError:
            return None


class KubectlCapacityProvider:
    """Sum the ``resource`` allocatable of Ready nodes (optionally
    filtered by a label selector): the in-cluster signal.  No forecast:
    node pools do not publish one."""

    def __init__(self, resource: str = "nvidia.com/gpu",
                 selector: str = "", kubectl: str = "kubectl",
                 timeout: float = 30.0):
        self.resource = resource
        self.selector = selector
        self.kubectl = kubectl
        self.timeout = timeout

    def command(self) -> List[str]:
        cmd = [self.kubectl, "get", "nodes", "-o", "json"]
        if self.selector:
            cmd += ["-l", self.selector]
        return cmd

    @staticmethod
    def _node_ready(node: Dict) -> bool:
        for cond in node.get("status", {}).get("conditions", []):
            if cond.get("type") == "Ready":
                return cond.get("status") == "True"
        return False

    def parse(self, doc: Dict) -> Optional[CapacitySignal]:
        total = 0
        for node in doc.get("items", []):
            if not self._node_ready(node):
                continue
            alloc = node.get("status", {}).get("allocatable", {})
            try:
                total += int(alloc.get(self.resource, 0))
            except (TypeError, ValueError):
                continue
        return CapacitySignal(total)

    def read(self) -> Optional[CapacitySignal]:
        try:
            out = subprocess.run(
                self.command(), capture_output=True, text=True,
                timeout=self.timeout, check=False)
            if out.returncode != 0:
                return None
            return self.parse(json.loads(out.stdout))
        except (OSError, subprocess.TimeoutExpired,
                json.JSONDecodeError):
            return None


# ---------------------------------------------------------------------
# /metrics scrape → HealthSignal
# ---------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_openmetrics(text: str
                      ) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Exposition text → ``{name: [(labels, value), ...]}``: just enough
    parser for the operator's own scrapes."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labels_raw, value_raw = m.groups()
        try:
            value = float(value_raw)
        except ValueError:
            continue
        labels = {k: v for k, v in _LABEL_RE.findall(labels_raw or "")}
        out.setdefault(name, []).append((labels, value))
    return out


def health_from_metrics(
        families: Dict[str, List[Tuple[Dict[str, str], float]]]
) -> HealthSignal:
    """The trainer's series the policy reads, tolerant of partial
    exposition (a trainer without the goodput ledger scrapes to an
    all-defaults signal)."""
    ratio = None
    for _labels, v in families.get("eksml_goodput_ratio", []):
        ratio = v
    badput = {labels.get("bucket", ""): v for labels, v in
              families.get("eksml_badput_seconds_total", [])}
    preempt = sum(v for _l, v in families.get(
        "eksml_resilience_preemptions_total", []))
    straggler = 0.0
    for name, samples in families.items():
        if name.startswith("eksml_hosts_") and name.endswith(
                "_straggler"):
            straggler = max([straggler] + [v for _l, v in samples])
    return HealthSignal(goodput_ratio=ratio, badput_s=badput,
                        preemptions=preempt, stragglers=straggler)


def scrape_url(url: str, timeout: float = 5.0) -> Optional[str]:
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read().decode()
    except (OSError, ValueError):
        return None


def trainer_metrics_url(logdir: str, host: int = 0) -> Optional[str]:
    """The trainer's ephemeral-port discovery contract
    (``TELEMETRY.PORT=0`` → ``telemetry-host<i>.port``, written by local
    rank 0, the one rank of a pod that binds the exporter).  A stale
    file from the previous launch scrapes to a connection error, which
    degrades to an unknown HealthSignal: correct mid-relaunch."""
    path = os.path.join(logdir, f"telemetry-host{host}.port")
    try:
        with open(path) as f:
            return f"http://127.0.0.1:{int(f.read().strip())}/metrics"
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------
# actuators
# ---------------------------------------------------------------------


def free_port() -> int:
    """An unused TCP port on 127.0.0.1: each launch's coordinator gets a
    fresh one, so a relaunch never meets the last group's TIME_WAIT."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


class LocalTrainerActuator:
    """Owns the ranks of one ``python -m eksml_tpu_torch.train`` job.

    A topology of N chips is N processes of one host, formed into a
    group by the JobSet env as the chart's pods are
    (``COORDINATOR_ADDRESS`` on a fresh port per launch,
    ``NUM_PROCESSES=1``, ``LOCAL_WORLD_SIZE=N``, ``LOCAL_RANK=r``), each
    given ``--device``: on ``cuda`` rank r trains on ``cuda:r`` over
    NCCL, on ``cpu`` the ranks form a gloo group.  Each rank writes its
    own log file (an undrained pipe would block a rank mid-step).

    The reference owns one child and fakes the device count through XLA
    flags; the port never fakes a card: on ``cuda`` a rung with more
    ranks than ``torch.cuda.device_count()`` is refused (:meth:`refusal`)
    before any SIGTERM, never put two ranks on one card, never moved to
    the CPU."""

    def __init__(self, logdir: str, train_config: Sequence[str],
                 global_batch: int = 0, device: str = "cuda",
                 synthetic: bool = False, stop_budget: float = 600.0,
                 extra_env: Optional[Dict[str, str]] = None):
        self.logdir = os.path.abspath(logdir)
        self.train_config = list(train_config)
        self.global_batch = int(global_batch)
        self.device = str(device)
        self.synthetic = synthetic
        self.stop_budget = float(stop_budget)
        self.preempt_exit_code = int(config.RESILIENCE.PREEMPT_EXIT_CODE)
        self.extra_env = dict(extra_env or {})
        self.launches = 0
        # the ranks' exit codes at the last stop, and when its SIGTERM went
        self.last_exit_codes: List[Optional[int]] = []
        self.last_sigterm_t: Optional[float] = None
        self._procs: List[subprocess.Popen] = []

    def refusal(self, topology: Topology) -> Optional[str]:
        """Why ``topology`` cannot launch here, or None."""
        if not self.device.startswith("cuda"):
            return None
        import torch

        visible = torch.cuda.device_count()
        if topology.chips > visible:
            return (f"{topology.name} needs {topology.chips} rank(s), one "
                    f"per GPU, and {visible} GPU(s) are visible: two ranks "
                    "never share a card and a card rung never runs on the "
                    "CPU")
        return None

    def command(self, topology: Topology) -> List[str]:
        cmd = [sys.executable, "-m", "eksml_tpu_torch.train",
               "--logdir", self.logdir, "--device", self.device]
        if self.synthetic:
            cmd.append("--synthetic")
        cmd += ["--config"] + self.train_config + list(
            topology.config_overrides(self.global_batch))
        return cmd

    def environment(self, topology: Topology, rank: int,
                    port: int) -> Dict[str, str]:
        env = {k: v for k, v in os.environ.items() if k not in _RANK_ENV}
        env.update(self.extra_env)
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="1",
                   LOCAL_WORLD_SIZE=str(topology.chips),
                   LOCAL_RANK=str(rank))
        return env

    def launch(self, topology: Topology) -> List[str]:
        """Start every rank of ``topology``; returns their log paths."""
        reason = self.refusal(topology)
        if reason is not None:
            raise ValueError(reason)
        if self.running:
            raise RuntimeError("launch while the previous job runs")
        self.launches += 1
        port = free_port()
        cmd = self.command(topology)
        paths = []
        for rank in range(topology.chips):
            path = os.path.join(
                self.logdir,
                f"operator-train-{self.launches}-rank{rank}.log")
            with open(path, "a") as logf:  # the child inherits the fd
                self._procs.append(subprocess.Popen(
                    cmd, env=self.environment(topology, rank, port),
                    stdout=logf, stderr=subprocess.STDOUT, cwd=REPO))
            paths.append(path)
        return paths

    @property
    def running(self) -> bool:
        return any(p.poll() is None for p in self._procs)

    def poll(self) -> Optional[int]:
        """None while every rank runs (or before launch).  When any rank
        has ended on its own the job has ended: the rest are stopped
        (:meth:`stop`) and the job's exit code is answered."""
        if not self._procs or all(p.poll() is None for p in self._procs):
            return None
        return self.stop()

    def stop(self, budget: Optional[float] = None) -> Optional[int]:
        """SIGTERM every running rank → wait: the forced-checkpoint path.
        A rank still running past ``budget`` seconds (default
        ``stop_budget``) is SIGKILLed; every rank is reaped.  Returns
        :func:`job_exit_code` of the ranks (None before any launch);
        ``last_exit_codes`` keeps each rank's."""
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
            log.warning("%d rank(s) ignored SIGTERM for %.0fs — SIGKILL",
                        len(late), budget)
            for p in late:
                p.kill()
        for p in self._procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        self.last_exit_codes = [p.poll() for p in self._procs]
        self._procs = []
        return job_exit_code(self.last_exit_codes, self.preempt_exit_code)


def kubectl_transition_cmds(jobset: str, namespace: str,
                            topology: Topology, global_batch: int = 0,
                            kubectl: str = "kubectl") -> List[List[str]]:
    """The in-cluster transition: annotate the JobSet with the decided
    topology (the relaunch contract the chart's restart reads), then
    delete its pods GRACEFULLY: kubelet delivers SIGTERM inside
    terminationGracePeriodSeconds, the trainer forces a checkpoint and
    exits 77, and podFailurePolicy restarts the JobSet instead of
    failing it."""
    overrides = " ".join(topology.config_overrides(global_batch))
    patch = json.dumps({"metadata": {"annotations": {
        "eksml.dev/target-topology": topology.name,
        "eksml.dev/target-chips": str(topology.chips),
        "eksml.dev/target-config": overrides}}})
    return [
        [kubectl, "-n", namespace, "patch", "jobset", jobset,
         "--type", "merge", "-p", patch],
        [kubectl, "-n", namespace, "delete", "pod",
         "-l", f"jobset.sigs.k8s.io/jobset-name={jobset}",
         "--wait=false"],
    ]


def kubectl_serve_scale_cmd(deployment: str, namespace: str,
                            replicas: int,
                            kubectl: str = "kubectl") -> List[str]:
    return [kubectl, "-n", namespace, "scale",
            f"deployment/{deployment}", f"--replicas={int(replicas)}"]


def _append_row(path: str, row: Dict) -> bool:
    """One JSON line appended to a bank; False when it could not be."""
    row = dict(row)
    row.setdefault("time", time.time())
    try:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
        return True
    except (OSError, TypeError, ValueError):
        return False


# ---------------------------------------------------------------------
# canary promotion controller (the continuous-deployment gate)
# ---------------------------------------------------------------------

# the controller's flight events get their own per-"host" file for the
# same reason the operator's do
PROMOTER_HOST = "cd"


def promotion_verdict(score: Dict, knobs: Dict) -> Tuple[str, str]:
    """Pure decision: one shadow score → (verdict, reason).

    Asymmetric by design: **rollback is immediate** (one breached gate
    demotes the canary), **promotion is patient** (the caller requires
    ``CANARY_PROMOTE_STREAK`` consecutive ``promote`` verdicts).  An
    unscorable replay (too few pairs, no latency baseline) holds."""
    scored = int(score.get("scored") or 0)
    min_req = int(knobs["CANARY_MIN_REQUESTS"])
    err_rate = score.get("canary_error_rate")
    # error rate is judged even below the scoring floor: a canary
    # failing every request scores zero pairs and would otherwise hold
    # forever instead of rolling back
    if err_rate is not None \
            and float(err_rate) > float(knobs["CANARY_ERROR_RATE_MAX"]):
        return ("rollback",
                f"canary error rate {err_rate} > "
                f"{knobs['CANARY_ERROR_RATE_MAX']}")
    if scored < min_req:
        return ("hold",
                f"only {scored} scored pair(s) < CANARY_MIN_REQUESTS="
                f"{min_req} — not enough evidence either way")
    ratio = score.get("p99_ratio")
    if ratio is not None \
            and float(ratio) > float(knobs["CANARY_P99_RATIO_MAX"]):
        return ("rollback",
                f"canary p99 {ratio}x incumbent > "
                f"{knobs['CANARY_P99_RATIO_MAX']}x")
    drift = (score.get("drift") or {}).get("mean")
    if drift is None or ratio is None:
        return "hold", "replay unscorable (missing drift/latency axis)"
    if float(drift) > float(knobs["CANARY_DRIFT_MAX"]):
        return ("rollback",
                f"output drift {drift} > {knobs['CANARY_DRIFT_MAX']} "
                "— the canary checkpoint disagrees with the "
                "incumbent beyond the gate")
    return ("promote",
            f"all gates passed (p99_ratio={ratio}, "
            f"error_rate={err_rate}, drift={drift})")


def post_reload(url: str, step: Optional[int] = None,
                timeout: float = 300.0) -> Dict:
    """``POST /admin/reload``: the controller's demote/promote lever.
    Answers the server's outcome dict; transport failures degrade to
    ``{"ok": False, ...}`` (the controller records, never crashes)."""
    import urllib.error
    import urllib.request

    body = json.dumps({} if step is None
                      else {"step": int(step)}).encode("utf-8")
    req = urllib.request.Request(
        url.rstrip("/") + "/admin/reload", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read().decode("utf-8"))
        except Exception:  # noqa: BLE001 — non-JSON error body
            return {"ok": False, "reason": "http", "detail": repr(e)}
    except (OSError, ValueError) as e:
        return {"ok": False, "reason": "unreachable", "detail": repr(e)}


class PromotionController:
    """Shadow-score the canary each tick; promote or roll back.

    One tick = read both ``/healthz`` (which step is each track
    serving?) → replay the banked traffic at both
    (``serve_loadtest.replay_shadow``) → ``promotion_verdict`` → actuate
    through ``/admin/reload``:

    - **rollback**: the canary reloads the INCUMBENT's step, at the
      first breached gate;
    - **promote**: after ``CANARY_PROMOTE_STREAK`` consecutive clean
      scores, the incumbent reloads the CANARY's step.

    The verdict acts on the steps read from ``/healthz`` before the
    replay; a replay during which a track swapped weights is scored as
    one replay over both steps (``replay_shadow``).  Every verdict lands
    in ``<logdir>/canary-host0.jsonl``, flight events (``canary_score``
    / ``canary_promote`` / ``canary_rollback``) in
    ``events-host{PROMOTER_HOST}.jsonl``, and the ``eksml_serve_canary_*``
    series on the controller's registry."""

    def __init__(self, logdir: str, incumbent_url: str,
                 canary_url: str, bank: Dict, knobs: Dict,
                 registry: Optional[MetricRegistry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 raw_topk: int = 16, concurrency: int = 4,
                 timeout: float = 120.0):
        self.logdir = logdir
        self.incumbent_url = incumbent_url
        self.canary_url = canary_url
        self.bank = bank
        self.knobs = knobs
        self.raw_topk = int(raw_topk)
        self.concurrency = int(concurrency)
        self.timeout = float(timeout)
        self.streak = 0
        self.promotions = 0
        self.rollbacks = 0
        self.bank_path = os.path.join(logdir, "canary-host0.jsonl")
        self.bank_failures = 0
        self.registry = registry or MetricRegistry()
        self._preregister(self.registry)
        self.recorder = recorder or FlightRecorder(
            capacity=256,
            path=os.path.join(logdir,
                              f"events-host{PROMOTER_HOST}.jsonl"),
            host_id=PROMOTER_HOST)

    @staticmethod
    def _preregister(registry: MetricRegistry) -> None:
        registry.counter("eksml_serve_canary_scores",
                         "shadow-replay scoring rounds completed")
        for verdict in ("promote", "rollback", "hold"):
            registry.counter("eksml_serve_canary_verdicts",
                             "promotion verdicts by outcome",
                             labels={"verdict": verdict})
        registry.counter("eksml_serve_canary_promotions",
                         "canary checkpoints promoted to the "
                         "incumbent track")
        registry.counter("eksml_serve_canary_rollbacks",
                         "regressed canaries demoted back to the "
                         "incumbent checkpoint")
        registry.gauge("eksml_serve_canary_p99_ratio",
                       "latest canary/incumbent latency p99 ratio")
        registry.gauge("eksml_serve_canary_error_rate",
                       "latest canary error rate over the shadow "
                       "replay")
        registry.gauge("eksml_serve_canary_drift",
                       "latest mean detection-output drift vs the "
                       "incumbent")

    def _bank_row(self, row: Dict) -> None:
        if not _append_row(self.bank_path, row):
            self.bank_failures += 1

    def tick(self) -> Dict:
        """One scoring round; returns ``{"verdict": ..., ...}``."""
        lt = serve_loadtest
        try:
            inc = lt.fetch_health(self.incumbent_url,
                                  timeout=self.timeout)
            can = lt.fetch_health(self.canary_url,
                                  timeout=self.timeout)
        except (OSError, ValueError) as e:
            return self._hold(f"health unreachable: {e!r}")
        inc_step, can_step = inc.get("params_step"), \
            can.get("params_step")
        if can.get("status") != "ok" or inc.get("status") != "ok":
            return self._hold(
                f"track not serving (incumbent={inc.get('status')}, "
                f"canary={can.get('status')})")
        if can_step is None or can_step == inc_step:
            # converged fleet: nothing to score until training publishes
            # a new checkpoint and the canary picks it up
            return self._hold(
                f"tracks converged at step {inc_step} — no candidate")
        score = lt.replay_shadow(self.bank, self.incumbent_url,
                                 self.canary_url,
                                 timeout=self.timeout,
                                 raw_topk=self.raw_topk,
                                 concurrency=self.concurrency)
        self.registry.counter("eksml_serve_canary_scores", "").inc()
        if score.get("p99_ratio") is not None:
            self.registry.gauge("eksml_serve_canary_p99_ratio",
                                "").set(float(score["p99_ratio"]))
        self.registry.gauge("eksml_serve_canary_error_rate",
                            "").set(float(score["canary_error_rate"]))
        drift = (score.get("drift") or {}).get("mean")
        if drift is not None:
            self.registry.gauge("eksml_serve_canary_drift",
                                "").set(float(drift))
        verdict, reason = promotion_verdict(score, self.knobs)
        self.registry.counter("eksml_serve_canary_verdicts", "",
                              labels={"verdict": verdict}).inc()
        self.recorder.record(
            "canary_score", verdict=verdict, reason=reason,
            incumbent_step=inc_step, canary_step=can_step,
            p99_ratio=score.get("p99_ratio"),
            error_rate=score.get("canary_error_rate"), drift=drift)
        outcome = {"verdict": verdict, "reason": reason,
                   "incumbent_step": inc_step,
                   "canary_step": can_step, "score": score}
        if verdict == "rollback":
            self.streak = 0
            self.rollbacks += 1
            self.registry.counter("eksml_serve_canary_rollbacks",
                                  "").inc()
            demote = post_reload(self.canary_url, step=inc_step,
                                 timeout=self.timeout)
            self.recorder.record(
                "canary_rollback", reason=reason,
                from_step=can_step, to_step=inc_step,
                reload_ok=bool(demote.get("ok")))
            log.warning("canary ROLLED BACK (step %s -> %s): %s",
                        can_step, inc_step, reason)
            outcome["reload"] = demote
        elif verdict == "promote":
            self.streak += 1
            streak_need = int(self.knobs["CANARY_PROMOTE_STREAK"])
            if self.streak >= streak_need:
                self.promotions += 1
                self.registry.counter(
                    "eksml_serve_canary_promotions", "").inc()
                promote = post_reload(self.incumbent_url,
                                      step=can_step,
                                      timeout=self.timeout)
                self.recorder.record(
                    "canary_promote", step=can_step,
                    previous_step=inc_step, streak=self.streak,
                    reload_ok=bool(promote.get("ok")))
                log.info("canary PROMOTED: incumbent now serves "
                         "step %s (was %s)", can_step, inc_step)
                outcome["reload"] = promote
                self.streak = 0
            else:
                outcome["reason"] += (f"; streak {self.streak}/"
                                      f"{streak_need} — promotion "
                                      "needs more clean scores")
        else:
            self.streak = 0
        self._bank_row({"kind": "canary_verdict", **{
            k: outcome[k] for k in ("verdict", "reason",
                                    "incumbent_step", "canary_step")},
            "p99_ratio": score.get("p99_ratio"),
            "error_rate": score.get("canary_error_rate"),
            "drift": drift, "streak": self.streak})
        return outcome

    def _hold(self, reason: str) -> Dict:
        self.registry.counter("eksml_serve_canary_verdicts", "",
                              labels={"verdict": "hold"}).inc()
        self._bank_row({"kind": "canary_verdict", "verdict": "hold",
                        "reason": reason})
        return {"verdict": "hold", "reason": reason}

    def run(self, interval: float, stop_flag, max_ticks: int = 0,
            once: bool = False) -> int:
        ticks = 0
        while not stop_flag.stop:
            out = self.tick()
            log.info("canary tick %d: %s (%s)", ticks,
                     out["verdict"], out["reason"])
            ticks += 1
            if once or (max_ticks and ticks >= max_ticks):
                break
            deadline = time.monotonic() + max(0.5, interval)
            while not stop_flag.stop \
                    and time.monotonic() < deadline:
                time.sleep(0.2)
        return 0


# ---------------------------------------------------------------------
# the operator loop
# ---------------------------------------------------------------------


class _StopFlag:
    """SIGTERM/SIGINT land here flag-only (signal-safety rule: a
    handler runs between bytecodes on the interrupted thread — no
    locks, no logging, no metric publishes)."""

    def __init__(self):
        self.stop = False

    def __call__(self, signum, frame):
        self.stop = True


class Operator:
    def __init__(self, args, knobs: Dict, ladder: Sequence[Topology],
                 provider, registry: Optional[MetricRegistry] = None,
                 actuator: Optional[LocalTrainerActuator] = None):
        self.args = args
        self.knobs = knobs
        self.ladder = tuple(ladder)
        self.provider = provider
        self.actuator = actuator
        self.params = PolicyParams(
            cooldown_sec=float(knobs["COOLDOWN_SEC"]),
            grow_patience=int(knobs["GROW_PATIENCE"]),
            shrink_patience=int(knobs["SHRINK_PATIENCE"]),
            forecast_hold=float(knobs["FORECAST_HOLD"]),
            min_goodput_for_grow=float(knobs["MIN_GOODPUT_FOR_GROW"]))
        self.state: Optional[PolicyState] = None
        self.stop_flag = _StopFlag()
        self.bank_path = os.path.join(
            args.logdir, f"autoscale-host{args.operator_id}.jsonl")
        self.bank_failures = 0
        self.restarts = 0
        self.serve_target: Optional[int] = None

        self.registry = registry or MetricRegistry()
        self._preregister(self.registry)
        self.recorder = FlightRecorder(
            capacity=256,
            path=os.path.join(args.logdir,
                              f"events-host{OPERATOR_HOST}.jsonl"),
            host_id=OPERATOR_HOST)
        self.exporter = TelemetryExporter(
            port=args.port, registry=self.registry,
            port_file=os.path.join(args.logdir,
                                   "telemetry-operator.port"))

    @staticmethod
    def _preregister(registry: MetricRegistry) -> None:
        """Create every eksml_autoscale_* series at operator start so
        a healthy first scrape shows the whole family at 0."""
        for action in ACTIONS:
            registry.counter(
                "eksml_autoscale_decisions",
                "scale decisions by action", labels={"action": action})
        registry.gauge(
            "eksml_autoscale_target_chips",
            "chip count of the currently-decided topology")
        registry.gauge(
            "eksml_autoscale_available_chips",
            "capacity provider's latest available-chip reading")
        registry.counter(
            "eksml_autoscale_relaunches",
            "trainer relaunches driven through the forced-checkpoint "
            "path")
        registry.counter(
            "eksml_autoscale_refusals",
            "decided topologies the local actuator could not launch "
            "(more ranks than visible GPUs); the job kept its shape")
        registry.counter(
            "eksml_autoscale_capacity_errors",
            "ticks whose capacity signal was unreadable")
        registry.gauge(
            "eksml_autoscale_serve_target_replicas",
            "desired serve replicas (the active half of the serve "
            "HPA)")

    # -- evidence trail ------------------------------------------------
    def _bank(self, row: Dict) -> None:
        if not _append_row(self.bank_path, row):
            self.bank_failures += 1

    def _record_decision(self, decision: ScaleDecision,
                         capacity: Optional[CapacitySignal],
                         health: HealthSignal) -> None:
        self.registry.counter(
            "eksml_autoscale_decisions", "",
            labels={"action": decision.action}).inc()
        self.registry.gauge("eksml_autoscale_target_chips",
                            "").set(decision.target.chips)
        if capacity is not None:
            self.registry.gauge("eksml_autoscale_available_chips",
                                "").set(capacity.available_chips)
        row = decision.to_dict()
        row["kind"] = "decision"
        if capacity is not None:
            row["available_chips"] = capacity.available_chips
            row["preemption_forecast"] = capacity.preemption_forecast
        if health.goodput_ratio is not None:
            row["goodput_ratio"] = round(health.goodput_ratio, 4)
            # the whole signal the policy read (the reference banks the
            # ratio alone)
            row["health"] = asdict(health)
        self._bank(row)
        event_kind = ("scale_hold" if decision.action == "hold"
                      else "scale_decision")
        self.recorder.record(event_kind, action=decision.action,
                             target=decision.target.name,
                             target_chips=decision.target.chips,
                             reason=decision.reason)

    # -- health --------------------------------------------------------
    def _scrape_health(self) -> HealthSignal:
        url = trainer_metrics_url(self.args.logdir)
        text = scrape_url(url) if url else None
        if text is None:
            return HealthSignal()
        return health_from_metrics(parse_openmetrics(text))

    # -- actuation -----------------------------------------------------
    def _actuate(self, decision: ScaleDecision) -> bool:
        """Carry out a grow or shrink; False when it was refused (the
        job keeps its shape)."""
        target = decision.target
        if self.args.mode == "local":
            assert self.actuator is not None
            reason = self.actuator.refusal(target)
            if reason is not None:
                self.registry.counter("eksml_autoscale_refusals", "").inc()
                self.recorder.record("scale_refused", action=decision.action,
                                     target=target.name,
                                     target_chips=target.chips,
                                     reason=reason)
                self._bank({"kind": "refused", "action": decision.action,
                            "target": target.name,
                            "target_chips": target.chips, "reason": reason})
                log.warning("%s to %s refused: %s", decision.action,
                            target.name, reason)
                return False
            t0 = time.time()
            rc = self.actuator.stop(budget=self.args.stop_budget)
            codes = list(self.actuator.last_exit_codes)
            resumable = rc == self.actuator.preempt_exit_code
            if not resumable:
                log.error("ranks exited %s at the %s transition: not the "
                          "resumable %d on every rank", codes,
                          decision.action, self.actuator.preempt_exit_code)
            stopped_t = time.time()
            self.actuator.launch(target)
            launch_t = time.time()
            self.registry.counter("eksml_autoscale_relaunches",
                                  "").inc()
            self.recorder.record(
                "scale_relaunch", action=decision.action,
                target=target.name, target_chips=target.chips,
                exit_code=rc, exit_codes=codes, resumable=resumable,
                relaunch_gap_s=round(launch_t - stopped_t, 3))
            self._bank({"kind": "relaunch", "action": decision.action,
                        "target": target.name,
                        "target_chips": target.chips, "exit_code": rc,
                        "exit_codes": codes, "resumable": resumable,
                        "sigterm_t": self.actuator.last_sigterm_t,
                        "launch_t": launch_t,
                        "stop_s": round(stopped_t - t0, 3),
                        "relaunch_gap_s": round(launch_t - stopped_t, 3)})
            return True
        # kubectl mode: the graceful-deletion transition
        cmds = kubectl_transition_cmds(
            self.args.jobset, self.args.namespace, target,
            self.args.global_batch, kubectl=self.args.kubectl)
        rcs = [self._run_kubectl(c) for c in cmds]
        self.registry.counter("eksml_autoscale_relaunches", "").inc()
        self.recorder.record("scale_relaunch", action=decision.action,
                             target=target.name,
                             target_chips=target.chips,
                             kubectl_rcs=rcs)
        self._bank({"kind": "relaunch", "action": decision.action,
                    "target": target.name,
                    "target_chips": target.chips,
                    "kubectl_rcs": rcs})
        return True

    def _run_kubectl(self, cmd: List[str]) -> int:
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=self.args.kubectl_timeout,
                                 check=False)
            if out.returncode != 0:
                log.warning("kubectl failed (%d): %s\n%s",
                            out.returncode, " ".join(cmd),
                            out.stderr[-500:])
            return out.returncode
        except (OSError, subprocess.TimeoutExpired) as e:
            log.warning("kubectl errored: %s (%s)", " ".join(cmd), e)
            return -1

    # -- serve fleet (active half of the serve chart's HPA) ------------
    def _scale_serve(self) -> None:
        target_depth = float(self.knobs["SERVE_TARGET_QUEUE_DEPTH"])
        if target_depth <= 0 or not self.args.serve_metrics_url:
            return
        text = scrape_url(self.args.serve_metrics_url)
        if text is None:
            return
        fams = parse_openmetrics(text)
        depths = [v for _l, v in fams.get("eksml_serve_queue_depth",
                                          [])]
        if not depths:
            return
        depth = sum(depths) / len(depths)
        current = (self.serve_target
                   or int(self.knobs["SERVE_MIN_REPLICAS"]))
        desired = serve_replicas(
            depth, current, target_depth,
            int(self.knobs["SERVE_MIN_REPLICAS"]),
            int(self.knobs["SERVE_MAX_REPLICAS"]))
        self.registry.gauge("eksml_autoscale_serve_target_replicas",
                            "").set(desired)
        if desired == self.serve_target:
            return
        self.serve_target = desired
        self.recorder.record("scale_serve", replicas=desired,
                             queue_depth=round(depth, 2))
        self._bank({"kind": "serve_scale", "replicas": desired,
                    "queue_depth": round(depth, 2)})
        if self.args.mode == "kubectl" and self.args.serve_deployment:
            self._run_kubectl(kubectl_serve_scale_cmd(
                self.args.serve_deployment, self.args.namespace,
                desired, kubectl=self.args.kubectl))

    # -- lifecycle -----------------------------------------------------
    def _launchable(self, topo: Topology) -> bool:
        return self.actuator is None or self.actuator.refusal(topo) is None

    def _initial_topology(self,
                          capacity: Optional[CapacitySignal]
                          ) -> Topology:
        if self.args.initial_chips:
            for topo in self.ladder:
                if topo.chips == self.args.initial_chips:
                    if not self._launchable(topo):
                        raise SystemExit(self.actuator.refusal(topo))
                    return topo
            raise SystemExit(
                f"--initial-chips {self.args.initial_chips} names no "
                f"ladder rung (have "
                f"{[t.chips for t in self.ladder]})")
        fits = [t for t in self.ladder if self._launchable(t)]
        if not fits:
            raise SystemExit(
                "no ladder rung can launch here: "
                f"{self.actuator.refusal(self.ladder[0])}")
        if capacity is not None:
            for topo in reversed(fits):
                if topo.chips <= capacity.available_chips:
                    return topo
        return fits[-1]

    def start(self) -> None:
        self.exporter.start()
        capacity = self.provider.read()
        topo = self._initial_topology(capacity)
        now = time.time()
        self.state = PolicyState(topo, last_change_t=now)
        self.registry.gauge("eksml_autoscale_target_chips",
                            "").set(topo.chips)
        if self.args.mode == "local" and self.actuator is not None:
            paths = self.actuator.launch(topo)
            log.info("launched trainer at %s (%d rank(s)) → %s",
                     topo.name, topo.chips, ", ".join(paths))
        self.recorder.record("scale_launch", target=topo.name,
                             target_chips=topo.chips)
        self._bank({"kind": "launch", "target": topo.name,
                    "target_chips": topo.chips, "launch_t": now})

    def _child_watch(self) -> bool:
        """Local-mode supervision between decisions.  Returns False when
        the operator should exit (training completed or the restart
        budget is spent)."""
        if self.args.mode != "local" or self.actuator is None:
            return True
        rc = self.actuator.poll()
        if rc is None:
            return True
        codes = list(self.actuator.last_exit_codes)
        if rc == 0:
            log.info("trainer completed (exit 0) — operator done")
            self.recorder.record("train_complete", exit_code=0)
            self._bank({"kind": "train_complete", "exit_code": 0,
                        "exit_codes": codes})
            return False
        # a crash (or an externally delivered preemption): relaunch at
        # the CURRENT topology, bounded like JobSet maxRestarts
        self.restarts += 1
        if self.restarts > self.args.max_restarts:
            log.error("trainer exit %s and restart budget (%d) spent",
                      codes, self.args.max_restarts)
            self._bank({"kind": "restart_budget_spent",
                        "exit_code": rc, "exit_codes": codes})
            return False
        assert self.state is not None
        topo = self.state.topology
        self.actuator.launch(topo)
        self.registry.counter("eksml_autoscale_relaunches", "").inc()
        self.recorder.record("scale_relaunch", action="restart",
                             target=topo.name,
                             target_chips=topo.chips, exit_code=rc,
                             exit_codes=codes)
        self._bank({"kind": "relaunch", "action": "restart",
                    "target": topo.name, "target_chips": topo.chips,
                    "exit_code": rc, "exit_codes": codes,
                    "launch_t": time.time()})
        return True

    def tick(self) -> None:
        now = time.time()
        capacity = self.provider.read()
        health = self._scrape_health()
        assert self.state is not None
        if capacity is None:
            self.registry.counter("eksml_autoscale_capacity_errors",
                                  "").inc()
            decision = ScaleDecision(
                "hold", self.state.topology,
                "capacity signal unavailable")
            self._record_decision(decision, None, health)
        else:
            prev = self.state
            decision, self.state = decide(
                self.state, capacity, health, self.ladder,
                self.params, now)
            self._record_decision(decision, capacity, health)
            if decision.action != "hold" and not self._actuate(decision):
                # refused: the job keeps its shape, and the policy the
                # state of that shape (the streak starts over)
                self.state = replace(prev, grow_streak=0, shrink_streak=0)
        self._scale_serve()

    def run(self) -> int:
        self.start()
        interval = float(self.args.interval
                         or self.knobs["INTERVAL_SEC"])
        ticks = 0
        try:
            while not self.stop_flag.stop:
                if not self._child_watch():
                    break
                self.tick()
                ticks += 1
                if self.args.once or (self.args.max_ticks
                                      and ticks >= self.args.max_ticks):
                    break
                deadline = time.time() + interval
                while (time.time() < deadline
                       and not self.stop_flag.stop):
                    time.sleep(min(
                        0.2, max(0.0, deadline - time.time())))
        finally:
            if self.args.mode == "local" and self.actuator is not None:
                rc = self.actuator.stop(budget=self.args.stop_budget)
                if rc is not None:
                    codes = list(self.actuator.last_exit_codes)
                    self.recorder.record("scale_stop", exit_code=rc,
                                         exit_codes=codes)
                    self._bank({"kind": "stop", "exit_code": rc,
                                "exit_codes": codes,
                                "sigterm_t": self.actuator.last_sigterm_t})
            self.exporter.stop()
        return 0


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m eksml_tpu_torch.tools.eksml_operator",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--logdir", required=True,
                   help="training run directory (evidence trail + "
                        "local-mode trainer logdir)")
    p.add_argument("--mode", choices=("local", "kubectl"),
                   default="local")
    p.add_argument("--config", nargs="*", default=[],
                   help="config overrides, e.g. "
                        "RESILIENCE.AUTOSCALE.COOLDOWN_SEC=120")
    p.add_argument("--capacity-file", default=None,
                   help="JSON capacity stub "
                        '{"available_chips": N, ...}')
    p.add_argument("--capacity-env", action="store_true",
                   help="read capacity from EKSML_AVAILABLE_CHIPS")
    p.add_argument("--capacity-selector", default="",
                   help="kubectl node label selector for the "
                        "capacity census")
    p.add_argument("--capacity-resource", default="nvidia.com/gpu",
                   help="allocatable resource counted as chips")
    p.add_argument("--interval", type=float, default=0.0,
                   help="tick seconds (0 = "
                        "RESILIENCE.AUTOSCALE.INTERVAL_SEC)")
    p.add_argument("--once", action="store_true",
                   help="single tick then exit (CronJob mode)")
    p.add_argument("--max-ticks", type=int, default=0,
                   help="exit after N ticks (0 = run until signaled)")
    p.add_argument("--port", type=int, default=0,
                   help="operator /metrics port (0 = ephemeral, "
                        "published to telemetry-operator.port)")
    p.add_argument("--operator-id", type=int, default=0,
                   help="suffix of autoscale-host<i>.jsonl")
    # local mode
    p.add_argument("--train-config", nargs="*", default=[],
                   help="base --config items for the local trainer "
                        "(topology overrides are appended)")
    p.add_argument("--global-batch", type=int, default=0,
                   help="hold chips x per-chip batch at this global "
                        "batch across topologies (0 = leave batch "
                        "knobs alone)")
    p.add_argument("--synthetic", action="store_true",
                   help="pass --synthetic to the local trainer")
    p.add_argument("--device", default="cuda",
                   help="torch device of every local rank (default cuda: "
                        "rank r on cuda:r over NCCL; cpu: a gloo group on "
                        "the CPU)")
    p.add_argument("--initial-chips", type=int, default=0,
                   help="ladder rung to launch at (0 = best fit of "
                        "the first capacity reading)")
    p.add_argument("--stop-budget", type=float, default=600.0,
                   help="seconds a SIGTERMed trainer may take to "
                        "checkpoint before SIGKILL")
    p.add_argument("--max-restarts", type=int, default=10,
                   help="local-mode crash-relaunch budget (the "
                        "JobSet maxRestarts analogue)")
    # canary promotion controller
    p.add_argument("--promote", action="store_true",
                   help="run the canary promotion controller instead "
                        "of the autoscale loop: shadow-score the "
                        "canary each tick, roll back on a breached "
                        "gate, promote after CANARY_PROMOTE_STREAK "
                        "clean scores")
    p.add_argument("--incumbent-url", default="",
                   help="stable track base URL (--promote)")
    p.add_argument("--canary-url", default="",
                   help="canary track base URL (--promote)")
    p.add_argument("--shadow-bank", default="",
                   help="recorded request bank (serve_loadtest "
                        "--record) replayed for scoring (--promote)")
    p.add_argument("--raw-topk", type=int, default=16,
                   help="pre-threshold top-k drift signal depth")
    p.add_argument("--shadow-concurrency", type=int, default=4)
    p.add_argument("--shadow-timeout", type=float, default=120.0)
    # kubectl mode
    p.add_argument("--kubectl", default="kubectl")
    p.add_argument("--kubectl-timeout", type=float, default=60.0)
    p.add_argument("--jobset", default="maskrcnn")
    p.add_argument("--namespace", default="kubeflow")
    p.add_argument("--serve-deployment", default="",
                   help="serve Deployment to scale (kubectl mode)")
    p.add_argument("--serve-metrics-url", default="",
                   help="a serve pod's /metrics URL (queue-depth "
                        "source for the active HPA half)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    os.makedirs(args.logdir, exist_ok=True)

    # --train-config is applied too: the operator's ladder must read
    # the SAME sharding strategy the trainer will run under
    config.freeze(False)
    config.update_args(list(args.config) + list(args.train_config))
    knobs = knobs_with_defaults(
        getattr(getattr(config, "RESILIENCE", None), "AUTOSCALE",
                None), RESILIENCE_AUTOSCALE_DEFAULTS)

    if args.promote:
        if not (args.incumbent_url and args.canary_url
                and args.shadow_bank):
            raise SystemExit("--promote needs --incumbent-url, "
                             "--canary-url and --shadow-bank")
        with open(args.shadow_bank) as f:
            bank = json.load(f)
        controller = PromotionController(
            args.logdir, args.incumbent_url, args.canary_url, bank,
            knobs, raw_topk=args.raw_topk,
            concurrency=args.shadow_concurrency,
            timeout=args.shadow_timeout)
        exporter = TelemetryExporter(
            port=args.port, registry=controller.registry,
            port_file=os.path.join(args.logdir,
                                   "telemetry-promoter.port"))
        exporter.start()
        stop_flag = _StopFlag()
        signal.signal(signal.SIGTERM, stop_flag)
        signal.signal(signal.SIGINT, stop_flag)
        log.info("promotion controller up: incumbent=%s canary=%s "
                 "bank=%d request(s)", args.incumbent_url,
                 args.canary_url, len(bank.get("requests", ())))
        try:
            return controller.run(
                args.interval or float(knobs["INTERVAL_SEC"]),
                stop_flag, max_ticks=args.max_ticks, once=args.once)
        finally:
            exporter.stop()
    sharding = knobs_with_defaults(
        getattr(getattr(config, "TRAIN", None), "SHARDING", None),
        SHARDING_DEFAULTS)
    chip_options = tuple(
        int(c) for c in (knobs["CHIP_OPTIONS"] or ()))
    if not chip_options:
        raise SystemExit(
            "RESILIENCE.AUTOSCALE.CHIP_OPTIONS is empty — pass "
            '--config RESILIENCE.AUTOSCALE.CHIP_OPTIONS="(1,2)" '
            "(the ladder the operator may scale over)")
    try:
        ladder = topology_ladder(
            chip_options, strategy=str(sharding["STRATEGY"]),
            model_axis=int(sharding["MODEL_AXIS_SIZE"]),
            num_slices=max(1, int(getattr(config.TPU, "NUM_SLICES", 1))))
    except NotImplementedError as e:
        raise SystemExit(str(e)) from e
    if not ladder:
        raise SystemExit(
            f"no valid topology for CHIP_OPTIONS={chip_options} "
            f"under strategy {sharding['STRATEGY']!r} — every count "
            "was rejected by the plan_mesh divisibility contract")

    if args.capacity_file:
        provider = FileCapacityProvider(args.capacity_file)
    elif args.capacity_env:
        provider = EnvCapacityProvider()
    elif args.mode == "kubectl":
        provider = KubectlCapacityProvider(
            resource=args.capacity_resource,
            selector=args.capacity_selector, kubectl=args.kubectl,
            timeout=args.kubectl_timeout)
    else:
        raise SystemExit("local mode needs --capacity-file or "
                         "--capacity-env")

    actuator = None
    if args.mode == "local":
        actuator = LocalTrainerActuator(
            args.logdir, args.train_config,
            global_batch=args.global_batch, device=args.device,
            synthetic=args.synthetic, stop_budget=args.stop_budget)

    op = Operator(args, knobs, ladder, provider, actuator=actuator)
    signal.signal(signal.SIGTERM, op.stop_flag)
    signal.signal(signal.SIGINT, op.stop_flag)
    log.info("operator up: ladder=%s interval=%ss mode=%s device=%s",
             [t.name for t in ladder],
             args.interval or knobs["INTERVAL_SEC"], args.mode,
             args.device)
    return op.run()


if __name__ == "__main__":
    sys.exit(main())
