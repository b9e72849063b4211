"""The port's elastic operator on the CPU, against the reference.

``eksml_tpu_torch/resilience/autoscale.py`` and
``eksml_tpu_torch/tools/eksml_operator.py`` against
``eksml_tpu/resilience/autoscale.py`` and ``tools/eksml_operator.py``:
``decide`` over a seeded stream of observations with the state threaded
through each package (every ``ScaleDecision`` and state field equal),
the ladders (and the port's refusal of ``tensor`` and ``2d``, which its
``ShardingPlan`` cannot launch), ``serve_replicas``, ``promotion_verdict``,
the kubectl commands, and the ``HealthSignal`` parsed from a port
exporter's ``/metrics`` that carries the trainer's families.  All exact.

``LocalTrainerActuator`` runs stub ranks (``tests/torch_operator_ranks.py``,
no JAX, no model) through the JobSet env: the per-rank command and env, the
refusal of a ``cuda`` rung above the visible card count (``device_count``
patched), the exit-code rule, and a 1 -> 2 -> 1 wave through
``Operator.tick``.  A wave of real ``python -m eksml_tpu_torch.train``
gloo ranks (three launches, each importing the trainer) runs in
``chip_smoke.py``'s operator phase instead.
"""

import json
import os
import re
import sys
import time
import urllib.request
from dataclasses import asdict

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import eksml_operator as j_op  # noqa: E402
from eksml_tpu.resilience import autoscale as j_as  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch.parallel import sharding as t_sharding  # noqa: E402
from eksml_tpu_torch.resilience import autoscale as t_as  # noqa: E402
from eksml_tpu_torch.telemetry.aggregate import (  # noqa: E402
    publish_aggregates, stats_from_matrix)
from eksml_tpu_torch.telemetry.exporter import (  # noqa: E402
    TelemetryExporter, render_openmetrics)
from eksml_tpu_torch.telemetry.goodput import GoodputMeter  # noqa: E402
from eksml_tpu_torch.telemetry.registry import MetricRegistry  # noqa: E402
from eksml_tpu_torch.tools import eksml_operator as t_op  # noqa: E402
from eksml_tpu_torch.train import _preregister_core_metrics  # noqa: E402

STUB = os.path.join(REPO, "tests", "torch_operator_ranks.py")
CHIPS = (1, 2, 4, 6, 8, 12, 16)


def _ref_topology(topo):
    return j_as.Topology(**asdict(topo))


# ---- the pure policy --------------------------------------------------


def _observations(seed: int, n: int = 200):
    """(available, forecast, goodput or None, now) with a clock that
    moves 0-400 s per tick: capacity waves, calm and stormy forecasts,
    unknown and low goodput."""
    rng = np.random.RandomState(seed)
    now = 1000.0
    out = []
    for _ in range(n):
        now += float(rng.choice([0.0, 5.0, 60.0, 400.0])) \
            + float(rng.uniform(0, 30))
        forecast = float(rng.choice([0.0, 0.0, 0.2, 0.7]))
        ratio = None if rng.rand() < 0.2 else float(rng.uniform(0, 1))
        out.append((int(rng.randint(0, 11)), forecast, ratio, now))
    return out


@pytest.mark.parametrize("strategy,params", [
    ("fsdp", dict(cooldown_sec=300.0, grow_patience=2, shrink_patience=1,
                  forecast_hold=0.5, min_goodput_for_grow=0.0)),
    ("replicated", dict(cooldown_sec=120.0, grow_patience=1,
                        shrink_patience=2, forecast_hold=0.6,
                        min_goodput_for_grow=0.4)),
])
def test_decide_equals_the_reference_on_a_seeded_stream(strategy, params):
    t_ladder = t_as.topology_ladder((1, 2, 4, 8), strategy=strategy)
    j_ladder = j_as.topology_ladder((1, 2, 4, 8), strategy=strategy)
    t_params, j_params = t_as.PolicyParams(**params), \
        j_as.PolicyParams(**params)
    t_state = t_as.PolicyState(t_ladder[1], last_change_t=1000.0)
    j_state = j_as.PolicyState(j_ladder[1], last_change_t=1000.0)
    actions = set()
    for avail, forecast, ratio, now in _observations(7):
        t_dec, t_state = t_as.decide(
            t_state, t_as.CapacitySignal(avail, forecast),
            t_as.HealthSignal(goodput_ratio=ratio), t_ladder, t_params, now)
        j_dec, j_state = j_as.decide(
            j_state, j_as.CapacitySignal(avail, forecast),
            j_as.HealthSignal(goodput_ratio=ratio), j_ladder, j_params, now)
        assert asdict(t_dec) == asdict(j_dec)
        assert t_dec.to_dict() == j_dec.to_dict()
        assert asdict(t_state) == asdict(j_state)
        actions.add(t_dec.action)
    assert actions == set(t_as.ACTIONS)   # the stream reaches every branch


# ---- the ladder ---------------------------------------------------------


@pytest.mark.parametrize("strategy", ["replicated", "fsdp"])
@pytest.mark.parametrize("num_slices", [1, 2])
def test_ladder_equals_the_reference_and_every_rung_launches(strategy,
                                                             num_slices):
    ladder = t_as.topology_ladder(CHIPS, strategy=strategy,
                                  num_slices=num_slices)
    ref = j_as.topology_ladder(CHIPS, strategy=strategy,
                               num_slices=num_slices)
    assert [asdict(t) for t in ladder] == [asdict(t) for t in ref]
    assert ladder
    for topo in ladder:
        cfg = t_config.config.clone()
        cfg.freeze(False)
        cfg.TRAIN.SHARDING.STRATEGY = topo.strategy
        cfg.TRAIN.SHARDING.FSDP_AXIS_SIZE = topo.fsdp_axis
        cfg.TRAIN.SHARDING.MODEL_AXIS_SIZE = topo.model_axis
        cfg.TPU.MESH_SHAPE = ()
        cfg.TPU.NUM_SLICES = num_slices
        shape, _axes = t_sharding.plan_mesh(cfg, topo.chips)
        if topo.strategy != "replicated":
            assert int(np.prod(shape)) == topo.chips
        t_sharding._refuse_unported(topo.strategy)   # ShardingPlan's check
        assert topo.config_overrides(2 * topo.chips) == \
            _ref_topology(topo).config_overrides(2 * topo.chips)


@pytest.mark.parametrize("strategy", ["tensor", "2d"])
def test_ladder_refuses_what_sharding_plan_cannot_launch(strategy):
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        t_as.topology_ladder(CHIPS, strategy=strategy, model_axis=2)
    # the reference emits rungs here, and ShardingPlan refuses each one
    assert j_as.topology_ladder(CHIPS, strategy=strategy, model_axis=2)
    with pytest.raises(NotImplementedError, match=re.escape(t_sharding.SHARDING_ITEM)):
        t_sharding._refuse_unported(strategy)
    with pytest.raises(ValueError, match="strategy"):
        t_as.topology_ladder(CHIPS, strategy="pipeline")


@pytest.mark.parametrize("depth,current,target,lo,hi,want", [
    (8.0, 2, 8.0, 2, 16, 2),
    (16.0, 2, 8.0, 2, 16, 4),
    (20.0, 3, 8.0, 2, 16, 8),
    (0.0, 4, 8.0, 2, 16, 2),
    (100.0, 8, 8.0, 2, 16, 16),
    (5.0, 4, 0.0, 2, 16, 4),
])
def test_serve_replicas_table(depth, current, target, lo, hi, want):
    got = t_as.serve_replicas(depth, current, target, lo, hi)
    assert got == j_as.serve_replicas(depth, current, target, lo, hi) == want


def test_policy_module_is_pure_and_stdlib_only():
    src = open(t_as.__file__).read()
    for needle in ("time.time(", "import time", "import random",
                   "datetime.now", "os.environ", "open(", "import torch"):
        assert needle not in src, needle


# ---- the canary gate ------------------------------------------------------

_KNOBS = {"CANARY_MIN_REQUESTS": 8, "CANARY_ERROR_RATE_MAX": 0.02,
          "CANARY_P99_RATIO_MAX": 1.5, "CANARY_DRIFT_MAX": 0.1,
          "CANARY_PROMOTE_STREAK": 3}


def _score(scored=20, err=0.0, p99=1.0, drift=0.0):
    return {"scored": scored, "canary_error_rate": err, "p99_ratio": p99,
            "drift": None if drift is None else {"mean": drift}}


@pytest.mark.parametrize("score,verdict", [
    (_score(), "promote"),
    (_score(drift=0.3), "rollback"),
    (_score(p99=2.0), "rollback"),
    (_score(err=0.5), "rollback"),
    (_score(scored=0, err=1.0, p99=None, drift=None), "rollback"),
    (_score(scored=3), "hold"),
    (_score(drift=None), "hold"),
    (_score(p99=None), "hold"),
])
def test_promotion_verdict_equals_the_reference(score, verdict):
    got = t_op.promotion_verdict(score, _KNOBS)
    assert got == j_op.promotion_verdict(score, _KNOBS)
    assert got[0] == verdict


# ---- operator plumbing ----------------------------------------------------


def test_kubectl_commands_and_capacity_parse_equal_the_reference():
    topo = t_as.Topology("fsdp4", 4, "fsdp", fsdp_axis=4)
    assert t_op.kubectl_transition_cmds("mrcnn", "kf", topo, 8) == \
        j_op.kubectl_transition_cmds("mrcnn", "kf", _ref_topology(topo), 8)
    assert all("--force" not in c for c in
               t_op.kubectl_transition_cmds("mrcnn", "kf", topo))
    assert t_op.kubectl_serve_scale_cmd("serve", "kf", 3) == \
        j_op.kubectl_serve_scale_cmd("serve", "kf", 3)
    nodes = {"items": [
        {"status": {"conditions": [{"type": "Ready", "status": "True"}],
                    "allocatable": {"nvidia.com/gpu": "8"}}},
        {"status": {"conditions": [{"type": "Ready", "status": "False"}],
                    "allocatable": {"nvidia.com/gpu": "8"}}},
        {"status": {"conditions": [{"type": "Ready", "status": "True"}],
                    "allocatable": {"nvidia.com/gpu": "4",
                                    "google.com/tpu": "4"}}}]}
    port = t_op.KubectlCapacityProvider()
    assert port.resource == "nvidia.com/gpu"
    ref = j_op.KubectlCapacityProvider(resource="nvidia.com/gpu")
    assert asdict(port.parse(nodes)) == asdict(ref.parse(nodes)) \
        == {"available_chips": 12, "preemption_forecast": 0.0}
    assert t_op.build_parser().parse_args(
        ["--logdir", "d"]).capacity_resource == "nvidia.com/gpu"


def trainer_text() -> str:
    """``/metrics`` of a port exporter carrying what the trainer publishes:
    the core families (preregistered), a goodput snapshot, a preemption
    and the ``hosts/*`` aggregates of 2 ranks."""
    reg = MetricRegistry()
    _preregister_core_metrics(reg)
    meter = GoodputMeter(segment_start_wall=0.0, clock=lambda: 100.0)
    meter.credit("train_step", 60.0)
    meter.credit("checkpoint_save", 4.5)
    meter.credit("downtime", 12.0)
    meter.publish(reg)
    reg.counter("eksml_resilience_preemptions").inc()
    matrix = np.arange(14, dtype=np.float64).reshape(2, 7)
    publish_aggregates(stats_from_matrix(matrix), reg)
    exporter = TelemetryExporter(port=0, addr="127.0.0.1",
                                 registry=reg).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exporter.port}/metrics",
                timeout=30) as r:
            return r.read().decode()
    finally:
        exporter.stop()


def test_health_signal_from_a_port_exporter_equals_the_reference():
    text = trainer_text()
    got = t_op.health_from_metrics(t_op.parse_openmetrics(text))
    want = j_op.health_from_metrics(j_op.parse_openmetrics(text))
    assert t_op.parse_openmetrics(text) == j_op.parse_openmetrics(text)
    assert asdict(got) == asdict(want)
    assert got.goodput_ratio is not None and 0 < got.goodput_ratio < 1
    assert got.preemptions == 1.0
    assert got.badput_s["checkpoint_save"] == 4.5
    assert got.badput_s["downtime"] == 12.0
    # a fault both packages share (ROADMAP.md Queue 3): the parser reads
    # eksml_hosts_*_straggler, which no trainer publishes
    assert "eksml_hosts_lagging" in t_op.parse_openmetrics(text)
    assert got.stragglers == 0.0


def test_trainer_metrics_url_reads_the_rank0_port_file(tmp_path):
    assert t_op.trainer_metrics_url(str(tmp_path)) is None
    (tmp_path / "telemetry-host0.port").write_text("4321\n")
    assert t_op.trainer_metrics_url(str(tmp_path)) == \
        j_op.trainer_metrics_url(str(tmp_path)) == \
        "http://127.0.0.1:4321/metrics"


# ---- the local actuator ---------------------------------------------------


@pytest.mark.parametrize("codes,want", [
    ([77], 77), ([77, 77], 77), ([0, 0], 0),
    ([77, 1], 1), ([1, 77], 1), ([0, 77], 1), ([77, -9], -9),
    ([77, None], 1), ([], None),
])
def test_job_exit_code_is_resumable_only_when_every_rank_says_so(codes,
                                                                 want):
    assert t_op.job_exit_code(codes, 77) == want


class StubActuator(t_op.LocalTrainerActuator):
    """The actuator with the stub rank as its command."""

    def command(self, topology):
        cmd = super().command(topology)
        return [sys.executable, STUB] + cmd[3:]


def _stub_rows(logdir):
    path = os.path.join(logdir, "stub-ranks.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def _wait_rows(logdir, n, budget=60.0):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        rows = _stub_rows(logdir)
        if len(rows) >= n:
            return rows
        time.sleep(0.05)
    raise AssertionError(f"{n} stub rank row(s) never appeared")


def test_rank_command_and_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PROCESS_ID", "3")
    act = t_op.LocalTrainerActuator(str(tmp_path), ["A=1"], global_batch=4,
                                    device="cpu", synthetic=True)
    topo = t_as.topology_ladder((2,), strategy="fsdp")[0]
    cmd = act.command(topo)
    assert cmd[:3] == [sys.executable, "-m", "eksml_tpu_torch.train"]
    assert cmd[3:] == ["--logdir", str(tmp_path), "--device", "cpu",
                       "--synthetic", "--config", "A=1",
                       "TRAIN.NUM_CHIPS=2", "TRAIN.SHARDING.STRATEGY=fsdp",
                       "TRAIN.SHARDING.FSDP_AXIS_SIZE=2",
                       "TRAIN.BATCH_SIZE_PER_CHIP=2"]
    for rank in range(2):
        env = act.environment(topo, rank, 5555)
        assert "PROCESS_ID" not in env
        assert {k: env[k] for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                                    "LOCAL_WORLD_SIZE", "LOCAL_RANK")} == {
            "COORDINATOR_ADDRESS": "127.0.0.1:5555", "NUM_PROCESSES": "1",
            "LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": str(rank)}
    assert act.preempt_exit_code == 77


def test_cuda_rung_above_the_visible_cards_is_refused(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    one, two = t_as.topology_ladder((1, 2), strategy="replicated")
    act = t_op.LocalTrainerActuator(str(tmp_path), [], device="cuda")
    assert act.refusal(one) is None
    assert "2 rank(s)" in act.refusal(two) and "1 GPU(s)" in act.refusal(two)
    with pytest.raises(ValueError, match="visible"):
        act.launch(two)
    assert act.launches == 0
    assert t_op.LocalTrainerActuator(str(tmp_path), [],
                                     device="cpu").refusal(two) is None


def test_stop_reads_every_rank_and_poll_ends_the_job(tmp_path, monkeypatch):
    d = str(tmp_path)
    two = t_as.topology_ladder((2,), strategy="replicated")[0]
    # one rank that exits 1 at a transition is a failure, not resumable
    monkeypatch.setenv("STUB_EXIT_RANK1", "1")
    act = StubActuator(d, [], device="cpu", stop_budget=30)
    act.launch(two)
    _wait_rows(d, 2)
    assert act.stop() == 1 and act.last_exit_codes == [77, 1]
    assert not act.running and act.stop() is None
    # a rank that ends on its own ends the job: poll stops the other
    monkeypatch.delenv("STUB_EXIT_RANK1")
    monkeypatch.setenv("STUB_END_RANK1", "0.3")
    act.launch(two)
    deadline = time.monotonic() + 60
    rc = None
    while rc is None and time.monotonic() < deadline:
        rc = act.poll()
        time.sleep(0.05)
    assert act.last_exit_codes == [77, 0] and rc == 1
    assert not act.running


def _args(logdir, **kw):
    args = t_op.build_parser().parse_args(
        ["--logdir", logdir, "--device", "cpu", "--stop-budget", "30"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


KNOBS = dict(t_config.RESILIENCE_AUTOSCALE_DEFAULTS, GROW_PATIENCE=1,
             COOLDOWN_SEC=0.0)


def _bank(logdir):
    with open(os.path.join(logdir, "autoscale-host0.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_operator_wave_1_2_1_through_stub_ranks(tmp_path):
    d = str(tmp_path)
    cap = tmp_path / "capacity.json"
    cap.write_text(json.dumps({"available_chips": 1}))
    ladder = t_as.topology_ladder((1, 2), strategy="replicated")
    act = StubActuator(d, ["X=1"], global_batch=2, device="cpu",
                       stop_budget=30)
    op = t_op.Operator(_args(d), KNOBS, ladder,
                       t_op.FileCapacityProvider(str(cap)), actuator=act)
    op.start()
    try:
        first = _wait_rows(d, 1)[0]
        deadline = time.monotonic() + 60
        while op._scrape_health().goodput_ratio is None:
            assert time.monotonic() < deadline, "stub /metrics never up"
            time.sleep(0.05)
        health = op._scrape_health()
        assert (health.goodput_ratio, health.preemptions,
                health.badput_s) == (0.75, 2.0, {"downtime": 4.5,
                                                 "checkpoint_save": 1.25})
        cap.write_text(json.dumps({"available_chips": 2}))
        op.tick()
        rows = _wait_rows(d, 3)
        cap.write_text(json.dumps({"available_chips": 1}))
        op.tick()
        rows = _wait_rows(d, 4)
        cap.write_text(json.dumps({"available_chips": 1}))
        op.tick()                                 # capacity matches: hold
    finally:
        op.exporter.stop()
        rc = act.stop()
    assert rc == 77
    assert op.state.topology.chips == 1
    env = [r["launch_env"] for r in rows]
    assert [(e["LOCAL_WORLD_SIZE"], e["LOCAL_RANK"]) for e in env[:1]
            + sorted(env[1:3], key=lambda e: e["LOCAL_RANK"]) + env[3:]] \
        == [("1", "0"), ("2", "0"), ("2", "1"), ("1", "0")]
    # a fresh coordinator port per launch, one port within a launch
    coords = [e["COORDINATOR_ADDRESS"] for e in env]
    assert coords[1] == coords[2] and len({coords[0], coords[1],
                                           coords[3]}) == 3
    assert "TRAIN.BATCH_SIZE_PER_CHIP=1" in rows[1]["argv"]
    assert "TRAIN.BATCH_SIZE_PER_CHIP=2" in first["argv"]
    kinds = [(r["kind"], r.get("action")) for r in _bank(d)]
    assert kinds == [("launch", None), ("decision", "grow"),
                     ("relaunch", "grow"), ("decision", "shrink"),
                     ("relaunch", "shrink"), ("decision", "hold")]
    relaunches = [r for r in _bank(d) if r["kind"] == "relaunch"]
    assert [r["exit_codes"] for r in relaunches] == [[77], [77, 77]]
    assert all(r["resumable"] and r["sigterm_t"] < r["launch_t"]
               for r in relaunches)
    fams = t_op.parse_openmetrics(render_openmetrics(op.registry))
    assert fams["eksml_autoscale_relaunches_total"][0][1] == 2
    assert fams["eksml_autoscale_refusals_total"][0][1] == 0
    with open(os.path.join(d, "events-hostop.jsonl")) as f:
        events = [json.loads(line)["kind"] for line in f]
    assert events.count("scale_relaunch") == 2 and events[0] == "scale_launch"


def test_refused_grow_sends_no_sigterm(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    d = str(tmp_path)
    cap = tmp_path / "capacity.json"
    cap.write_text(json.dumps({"available_chips": 2}))
    ladder = t_as.topology_ladder((1, 2), strategy="replicated")
    act = StubActuator(d, [], device="cuda", stop_budget=30)
    op = t_op.Operator(_args(d, device="cuda"), KNOBS, ladder,
                       t_op.FileCapacityProvider(str(cap)), actuator=act)
    op.start()           # the best LAUNCHABLE fit of 2 chips: 1 rank
    try:
        _wait_rows(d, 1)
        op.tick()
        op.tick()
        assert act.running and len(_stub_rows(d)) == 1
    finally:
        op.exporter.stop()
        rc = act.stop()
    assert rc == 77
    assert op.state.topology.chips == 1
    kinds = [(r["kind"], r.get("action")) for r in _bank(d)]
    assert kinds == [("launch", None), ("decision", "grow"),
                     ("refused", "grow"), ("decision", "grow"),
                     ("refused", "grow")]
    assert "1 GPU(s)" in _bank(d)[2]["reason"]


def test_main_refuses_tensor_strategy_and_empty_ladder(tmp_path):
    saved = t_config.config.to_dict()
    try:
        with pytest.raises(SystemExit, match="Queue 1, item 4"):
            t_op.main(["--logdir", str(tmp_path), "--config",
                       "RESILIENCE.AUTOSCALE.CHIP_OPTIONS=(2,4)",
                       "TRAIN.SHARDING.STRATEGY=tensor"])
        with pytest.raises(SystemExit, match="CHIP_OPTIONS is empty"):
            t_op.main(["--logdir", str(tmp_path), "--config",
                       "RESILIENCE.AUTOSCALE.CHIP_OPTIONS=()",
                       "TRAIN.SHARDING.STRATEGY=fsdp"])
    finally:
        t_config.config.freeze(False)
        t_config.config.from_dict(saved)
        t_config.config.freeze()
