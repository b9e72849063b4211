"""The port's telemetry layer (``eksml_tpu_torch/telemetry``: tracing,
the profile trigger and anomaly detector, the goodput meter and ledger,
the exporter, the metric taxonomy) held to the JAX package's
(``eksml_tpu/telemetry``) on the same inputs, and the layer in
``Trainer.fit`` on the CPU.

Equalities are exact: both packages are stdlib code over the same
clock (``time.time`` / ``time.perf_counter`` / ``time.monotonic``
patched to one fake clock where a test says "injected clock").  The
fit test runs the SMOKE config (128 px, batch 2) for 3 steps with
telemetry, tracing, goodput and a one-step capture on: its losses equal
the same run with telemetry off bitwise, and the reference's
``Trainer.fit`` within ``tests/test_torch_train.py``'s 1e-4 relative
(the port takes the reference's priorities).  The two-rank test runs
``tests/torch_dist_ranks.py``'s ``exporter`` scenario under its own
time limit.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

jax.config.update("jax_platforms", "cpu")

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu import telemetry as j_tel  # noqa: E402
from eksml_tpu import train as j_train  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.data import loader as j_loader  # noqa: E402
from eksml_tpu.ops import anchors as j_anchors  # noqa: E402
from eksml_tpu.telemetry import exporter as j_exporter  # noqa: E402
from eksml_tpu.telemetry import goodput as j_goodput  # noqa: E402
from eksml_tpu.telemetry import registry as j_registry  # noqa: E402
from eksml_tpu.telemetry import tracing as j_tracing  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import telemetry as t_tel  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.convert import from_flax  # noqa: E402
from eksml_tpu_torch.telemetry import exporter as t_exporter  # noqa: E402
from eksml_tpu_torch.telemetry import goodput as t_goodput  # noqa: E402
from eksml_tpu_torch.telemetry import registry as t_registry  # noqa: E402
from eksml_tpu_torch.telemetry import tracing as t_tracing  # noqa: E402
from test_telemetry import parse_openmetrics  # noqa: E402

PACKAGES = {"jax": (j_tel, j_tracing, j_goodput, j_exporter, j_registry),
            "torch": (t_tel, t_tracing, t_goodput, t_exporter, t_registry)}
IMG = 128
BATCH = 2
LOSS_KEYS = ("rpn_cls_loss", "rpn_box_loss", "frcnn_cls_loss",
             "frcnn_box_loss", "mrcnn_loss", "total_loss")
HTTP_TIMEOUT = 10


class FakeClock:
    """One clock for ``time.time``, ``perf_counter`` and ``monotonic``:
    each read advances it by ``tick``."""

    def __init__(self, t=1000.0, tick=0.25):
        self.t, self.tick = t, tick

    def __call__(self):
        self.t += self.tick
        return self.t


@pytest.fixture
def fake_time(monkeypatch):
    clock = FakeClock()
    for name in ("time", "perf_counter", "monotonic"):
        monkeypatch.setattr(time, name, clock)
    return clock


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    for tel in (j_tel, t_tel):
        tel.install_tracer(None)
    yield
    for tel in (j_tel, t_tel):
        tel.install_tracer(None)


# ---------------------------------------------------------------------
# tracing, the trigger, the detector
# ---------------------------------------------------------------------


def _trace_sequence(tel, tracing, path):
    """One fixed sequence of spans, instants and completed spans through
    a tracer, the module API and the decorator; returns the flushed
    document."""
    tr = tracing.Tracer(capacity=32, path=path, host_id=1)
    with tr.span("train_step", step=3, attrs={"k": "v"}):
        pass
    tr.instant("profile_capture_start", step=3, reason="cli")
    tel.install_tracer(tr)
    with tel.span("data_wait", step=4):
        pass
    tel.complete_span("batch_build", 5.0, 5.5, seq=2)

    @tel.traced("hot_fn")
    def hot(x):
        return x + 1

    assert hot(1) == 2
    disabled = tracing.Tracer(capacity=16, enabled=False)
    assert disabled.span("x") is tracing.NULL_SPAN
    tel.install_tracer(None)
    assert tel.span("none") is tracing.NULL_SPAN
    for i in range(40):                  # past the ring's capacity
        with tr.span("s", step=i):
            pass
    assert tr.flush() == path
    with open(path) as f:
        return json.load(f), tr.spans_recorded


def test_tracer_events_equal_the_reference(fake_time, tmp_path):
    """The same span and instant sequence on an injected clock gives
    equal Chrome-trace documents (metadata, ring bound, fields)."""
    docs = {}
    for name, (tel, tracing, *_) in PACKAGES.items():
        fake_time.t = 1000.0
        path = tracing.trace_path_for(str(tmp_path / name), 1)
        assert path.endswith("trace-host1.json")
        docs[name] = _trace_sequence(tel, tracing, path)
    assert docs["torch"] == docs["jax"]
    doc, recorded = docs["torch"]
    assert recorded == 44
    assert len([e for e in doc["traceEvents"] if e["ph"] != "M"]) == 32


def _trigger_sequence(tracing, clock):
    trig = tracing.ProfileTrigger(cooldown_sec=60.0, max_captures=2,
                                  default_steps=3, max_steps=10,
                                  clock=lambda: clock["t"])
    out = [trig.request(steps=5, reason="debugz"), trig.request(),
           trig.take(), trig.take(), trig.request(), trig.status()]
    trig.finish()
    out += [trig.request(), trig.request(steps="bogus"),
            trig.request(steps=-1)]
    clock["t"] += 61.0
    out += [trig.request(steps=999), trig.take(), trig.status()]
    trig.finish()
    clock["t"] += 61.0
    out += [trig.request(), trig.status()]
    return out


def test_profile_trigger_equals_the_reference(fake_time):
    """The same request, take and finish sequence on a fake clock gives
    the same accept/reject results, requests and ``status()``."""
    got = {}
    for name, (_, tracing, *_) in PACKAGES.items():
        fake_time.t = 1000.0
        got[name] = _trigger_sequence(tracing, {"t": 100.0})
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] and not got["torch"][1][0]
    assert got["torch"][-1]["captures_started"] == 2


def test_anomaly_detector_fires_where_the_reference_does():
    """A seeded series of step times with regressions and a straggler
    fires at the same intervals with the same reasons."""
    rng = np.random.RandomState(0)
    times = 100.0 + rng.randn(120) * 5.0
    times[30:34] *= 2.0           # a regression of 4 intervals
    times[60:62] *= 2.0           # a blip: no fire
    times[90:100] *= 1.8
    lag = rng.randint(0, 4, 120)
    lag[40:48] = 2                # a persistent straggler
    spread = 1.0 + np.abs(rng.randn(120)) * 0.2
    spread[40:48] = 2.0
    fired = {}
    for name, (_, tracing, *_) in PACKAGES.items():
        det = tracing.AnomalyDetector(k_intervals=3, p95_factor=1.5,
                                      spread_factor=1.5, window=32,
                                      min_history=8)
        fired[name] = [(i, det.observe(float(t), int(h), float(s)))
                       for i, (t, h, s) in enumerate(zip(times, lag,
                                                         spread))]
        fired[name] = [(i, r) for i, r in fired[name] if r is not None]
    assert fired["torch"] == fired["jax"]
    kinds = {r.split(":")[0] for _, r in fired["torch"]}
    assert kinds == {"step_time_p95_regression", "persistent_straggler"}


# ---------------------------------------------------------------------
# goodput: the meter, downtime recovery, the ledger, the report tool
# ---------------------------------------------------------------------


class StepClock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _scenario(name, goodput, tel, registry_mod, tmp_path):
    """The scenarios of ``tests/test_goodput.py`` against one package:
    returns what they observe (snapshots, rendered series, bank rows)."""
    clock = StepClock(0.0)
    fine = name not in ("coarse_residual", "coarse_compile", "bank")
    m = goodput.GoodputMeter(fine=fine, clock=clock)
    if name == "coarse_residual":
        clock.t = 10.0
        m.credit("checkpoint_save", 2.0)
    elif name == "fine_residual":
        m.on_span("train_step", 6.0)
        m.on_span("data_wait", 2.0)
        clock.t = 10.0
    elif name == "compile_window":
        m.begin_compile()
        m.on_span("train_step", 30.0)
        m.end_compile(30.0)
        m.on_span("train_step", 1.0)
        clock.t = 31.0
    elif name == "compile_outside_spans":
        m.begin_compile()
        m.on_span("train_step", 0.5)
        m.end_compile(15.0)
        clock.t = 15.0
    elif name == "coarse_compile":
        m.begin_compile()
        m.end_compile(25.0)
        clock.t = 30.0
    elif name == "producer_spans":
        m.on_span("h2d_prefetch", 5.0)
        m.on_span("batch_build", 5.0)
        m.on_span("globalize_batch", 1.5)
    elif name == "coarse_only":
        m.credit("eval", 4.0, coarse_only=True)
        m.credit("eval", 1.0)
        m.credit("no_such_bucket", 3.0)
    elif name == "hang_events":
        m.on_event({"kind": "watchdog_dump", "stalled_sec": 12.5})
        m.on_event({"kind": "checkpoint_save", "step": 3})
        m.on_event({"kind": "watchdog_dump", "stalled_sec": "garbage"})
    elif name == "downtime":
        clock.t = 100.0
        m = goodput.GoodputMeter(fine=True, clock=clock)
        m.credit("downtime", 10.0)
        m.on_span("train_step", 5.0)
        clock.t = 105.0
    elif name == "publish":
        reg = registry_mod.MetricRegistry()
        m.on_span("data_wait", 3.0)
        m.on_span("train_step", 6.0)
        clock.t = 10.0
        first = m.publish(reg, steps=4)
        clock.t = 12.0
        m.on_span("train_step", 2.0)
        second = m.publish(reg, steps=5)
        return [first, second, tel.render_openmetrics(reg)]
    elif name == "span_sink":
        tracer = tel.Tracer(capacity=64)
        prev_t = tel.install_tracer(tracer)
        prev_s = tel.install_span_sink(m.on_span)
        try:
            for span in ("data_wait", "train_step", "unmapped"):
                tel.complete_span(span, 1.0, 3.5, step=1)
        finally:
            tel.install_span_sink(prev_s)
            tel.install_tracer(prev_t)
        tel.complete_span("data_wait", 0.0, 9.0)    # sink removed
    elif name == "event_sink":
        rec = tel.FlightRecorder(capacity=16)
        prev = tel.install(rec)
        tel.add_event_sink(m.on_event)
        try:
            tel.event("watchdog_dump", step=1, phase="train_step",
                      stalled_sec=7.0)
        finally:
            tel.remove_event_sink(m.on_event)
            tel.install(prev)
            rec.close()
        tel.event("noop")
    elif name == "bank":
        path = str(tmp_path / "goodput-host0.jsonl")
        clock.t = 60.0
        m.bank(path, steps=3)
        clock.t = 70.0
        m.bank(path, steps=6, final=True)
        m.bank(str(tmp_path / "no-such-dir" / "x.jsonl"))
        with open(path) as f:
            return [json.loads(line) for line in f] + [m.bank_failures]
    return m.snapshot(steps=7)


GOODPUT_SCENARIOS = ("coarse_residual", "fine_residual", "compile_window",
                     "compile_outside_spans", "coarse_compile",
                     "producer_spans", "coarse_only", "hang_events",
                     "downtime", "publish", "span_sink", "event_sink",
                     "bank")


@pytest.mark.parametrize("scenario", GOODPUT_SCENARIOS)
def test_goodput_meter_equals_the_reference(scenario, tmp_path):
    assert t_goodput.BUCKETS == j_goodput.BUCKETS
    assert t_goodput.BADPUT_BUCKETS == j_goodput.BADPUT_BUCKETS
    assert t_goodput.SPAN_BUCKETS == j_goodput.SPAN_BUCKETS
    got = {}
    for name, (tel, _, goodput, _, registry_mod) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = _scenario(scenario, goodput, tel, registry_mod, d)
    assert got["torch"] == got["jax"]


def _write_jsonl(path, rows):
    with open(path, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


@pytest.fixture
def ledger_logdir(tmp_path):
    """Two segments: events with compile, checkpoint and restore
    durations, spans of both, a banked snapshot of the second, metric
    rows, and committed checkpoints with set mtimes."""
    logdir = tmp_path / "run"
    logdir.mkdir()
    _write_jsonl(logdir / "events-host0.jsonl", [
        {"time": 1000.0, "kind": "run_start", "host": 0, "host_count": 2,
         "config_digest": "aaa"},
        {"time": 1001.0, "kind": "compile_start", "step": 1},
        {"time": 1008.0, "kind": "compile_done", "step": 1,
         "compile_ms": 7000.0},
        {"time": 1030.0, "kind": "checkpoint_save", "step": 4,
         "save_ms": 1500.0},
        {"time": 1031.0, "kind": "preempt_exit", "step": 4},
        {"time": 1050.0, "kind": "run_start", "host": 0, "host_count": 1,
         "config_digest": "aaa"},
        {"time": 1053.0, "kind": "checkpoint_restore", "step": 4,
         "restore_ms": 2500.0, "resharded": True},
        {"time": 1080.0, "kind": "checkpoint_save", "step": 8,
         "save_ms": 1000.0}])
    spans = [{"ph": "X", "name": n, "ts": ts * 1e6, "dur": d * 1e6,
              "pid": 0, "args": {}} for n, ts, d in (
        ("train_step", 1002.0, 6.0), ("train_step", 1010.0, 4.0),
        ("data_wait", 1015.0, 3.0), ("globalize_batch", 1019.0, 1.0),
        ("checkpoint_save", 1029.0, 1.2), ("h2d_prefetch", 1020.0, 9.0),
        ("train_step", 1060.0, 6.0))]
    with open(logdir / "trace-host0.json", "w") as f:
        json.dump({"traceEvents": spans}, f)
    snap = {"time": 1081.0, "segment_start": 1050.0, "elapsed_s": 31.0,
            "wall_s": 50.0, "mode": "spans", "steps": 8,
            "buckets": {b: 0.0 for b in j_goodput.BUCKETS},
            "goodput_ratio": 0.5}
    snap["buckets"].update({"train_step": 20.0, "downtime": 19.0})
    _write_jsonl(logdir / "goodput-host0.jsonl", [snap])
    _write_jsonl(logdir / "metrics.jsonl", [
        {"step": s, "time": 1010.0 + 2 * s, "step_time_ms": 1000.0}
        for s in range(1, 5)])
    for step, mtime in (("2", 1020.0), ("4", 1032.0), ("8", 1079.0)):
        d = logdir / "checkpoints" / step
        d.mkdir(parents=True)
        os.utime(d, (mtime, mtime))
    return str(logdir)


def test_downtime_and_ledger_equal_the_reference(ledger_logdir, tmp_path):
    """``recover_downtime`` and ``build_ledger`` over one logdir, and
    over an empty one."""
    for fn in ("recover_downtime", "build_ledger"):
        for logdir in (ledger_logdir, str(tmp_path)):
            want = getattr(j_goodput, fn)(logdir, 0)
            assert getattr(t_goodput, fn)(logdir, 0) == want, (fn, logdir)
    led = t_goodput.build_ledger(ledger_logdir, 0)
    assert [s["mode"] for s in led["segments"]] == ["events+spans",
                                                    "banked:spans"]
    assert led["downtime"]["total_s"] == pytest.approx(18.0)


def test_goodput_report_reads_the_ports_bank(tmp_path, capsys):
    """``tools/goodput_report.py`` merges a logdir whose events and bank
    the port's recorder and meter wrote."""
    from tools import goodput_report

    logdir = str(tmp_path / "run")
    clock = StepClock(0.0)
    rec = t_tel.FlightRecorder(path=t_tel.events_path_for(logdir, 0))
    prev = t_tel.install(rec)
    try:
        t_tel.event("run_start", pid=1, host_count=1)
        start = rec.tail()[-1]["time"]
        clock.t = start
        m = t_goodput.GoodputMeter(fine=True, segment_start_wall=start,
                                   clock=clock)
        m.on_span("train_step", 3.0)
        m.on_span("data_wait", 1.0)
        clock.t = start + 5.0
        m.bank(t_goodput.goodput_path_for(logdir, 0), steps=4, final=True)
    finally:
        t_tel.install(prev)
        rec.close()
    out = str(tmp_path / "ledger.json")
    assert goodput_report.main([logdir, "--out", out, "--artifacts",
                                str(tmp_path / "none")]) == 0
    with open(out) as f:
        led = json.load(f)
    (seg,) = led["segments"]
    assert seg["mode"] == "banked:spans" and seg["steps"] == 4
    assert seg["buckets"]["train_step"] == pytest.approx(3.0)
    assert seg["buckets"]["host_overhead"] == pytest.approx(1.0)
    assert json.loads(capsys.readouterr().out)["goodput_ratio"] == \
        led["goodput_ratio"]


# ---------------------------------------------------------------------
# the exporter and the metric taxonomy
# ---------------------------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _populated(registry_mod):
    reg = registry_mod.MetricRegistry()
    reg.counter("eksml_x", "a counter", labels={"kind": "a\"b"}).inc(3)
    reg.gauge("eksml_g", "a gauge").set(2.5)
    reg.gauge("eksml_lazy").set_function(lambda: 7)
    h = reg.histogram("eksml_h_ms", "a histogram", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    return reg


def _exchange(exporter_mod, registry_mod, tracing, clock, stale):
    since = {"s": 1.0}
    trig = tracing.ProfileTrigger(cooldown_sec=60.0,
                                  clock=lambda: clock["t"])
    out = []
    for trigger in (trig, None):
        ex = exporter_mod.TelemetryExporter(
            port=0, addr="127.0.0.1", registry=_populated(registry_mod),
            health_fn=lambda: {"step": 3,
                               "seconds_since_last_step": since["s"]},
            profile_trigger=trigger, stale_after_sec=stale).start()
        try:
            since["s"] = 1.0
            code, body = _get(ex.port, "/metrics")
            out.append((code, body))
            for s in (1.0, 5.0):
                since["s"] = s
                code, body = _get(ex.port, "/healthz")
                payload = json.loads(body)
                payload.pop("uptime_sec")
                out.append((code, payload))
            for _ in range(2):
                code, body = _get(ex.port, "/debugz/profile?steps=2")
                out.append((code, json.loads(body)))
                if trigger is not None:
                    trigger.take()
                    trigger.finish()
            code, body = _get(ex.port, "/debugz/stacks")
            out.append((code, "thread" in body))
            out.append(_get(ex.port, "/nope")[0])
        finally:
            ex.stop()
    return out


@pytest.mark.parametrize("stale", [0.0, 2.0])
def test_exporter_answers_as_the_reference(stale):
    """Both exporters on port 0 over equal registries: equal /metrics
    bodies, /healthz codes and payloads fresh and stale (503 past the
    bound, always 200 without one), /debugz/profile 200 then 429 in
    the cooldown (503 without a trigger), /debugz/stacks 200, 404."""
    got = {name: _exchange(exporter, registry_mod, tracing, {"t": 10.0},
                           stale)
           for name, (_, tracing, _, exporter, registry_mod)
           in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    out = got["torch"]
    parse_openmetrics(out[0][1])
    assert [c if isinstance(c, int) else c[0] for c in out[:7]] == [
        200, 200, 503 if stale else 200, 200, 429, 200, 404]
    assert [c if isinstance(c, int) else c[0] for c in out[7:]] == [
        200, 200, 503 if stale else 200, 503, 503, 200, 404]


def test_exporter_bind_rule_and_port_file(tmp_path, caplog):
    """A failed bind is never fatal; with a liveness bound it logs an
    error; the port file is written whole (write-then-rename)."""
    pf = str(tmp_path / "telemetry-host0.port")
    first = t_exporter.TelemetryExporter(port=0, port_file=pf).start()
    try:
        assert int(open(pf).read()) == first.port
        assert not os.path.exists(pf + ".tmp")
        with caplog.at_level(logging.WARNING):
            second = t_exporter.TelemetryExporter(
                port=first.port, port_file=str(tmp_path / "p2"),
                stale_after_sec=5.0).start()
        assert not second.running and second.port is None
        assert not (tmp_path / "p2").exists()
        assert any(r.levelno == logging.ERROR and "liveness" in r.message
                   for r in caplog.records)
    finally:
        first.stop()
    assert not first.running


def test_core_metric_taxonomy_equals_the_reference():
    """``_preregister_core_metrics`` of each package on a fresh registry
    renders the same families, types, labels and values."""
    bodies = {}
    for name, (tel, _, _, _, registry_mod) in PACKAGES.items():
        reg = registry_mod.MetricRegistry()
        (j_train if name == "jax" else t_train)._preregister_core_metrics(
            reg)
        bodies[name] = tel.render_openmetrics(reg)
    assert bodies["torch"] == bodies["jax"]
    fams = parse_openmetrics(bodies["torch"])
    assert "eksml_goodput_ratio" in fams and "eksml_badput_seconds" in fams


def test_knobs_fall_back_to_the_defaults():
    class Empty:
        pass

    assert t_train._telemetry_knobs(Empty()) == t_config.TELEMETRY_DEFAULTS
    assert t_train._tracing_knobs(Empty()) == \
        t_config.TELEMETRY_TRACING_DEFAULTS
    assert t_train._goodput_knobs(Empty()) == \
        t_config.TELEMETRY_GOODPUT_DEFAULTS
    for fn in ("_telemetry_knobs", "_tracing_knobs", "_goodput_knobs"):
        assert getattr(t_train, fn)(t_config.config) == \
            getattr(j_train, fn)(j_config.config), fn


# ---------------------------------------------------------------------
# the slice as a whole: Trainer.fit with the layer on
# ---------------------------------------------------------------------

RUN = ("PREPROC.DEVICE_NORMALIZE=False", f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}",
       "TRAIN.GRADIENT_CLIP=5.0", "TRAIN.BASE_LR=0.1",
       "TRAIN.WARMUP_STEPS=0", "TRAIN.STEPS_PER_EPOCH=1000",
       "TRAIN.LOG_PERIOD=1", "TELEMETRY.PORT=0",
       # the stall below then lands in the loop's data_wait whole, not
       # in the prefetcher's thread behind a step
       "TRAIN.PREFETCH_TO_DEVICE=False")
TELEMETRY_ON = ("TELEMETRY.TRACING.ENABLED=True",
                "TELEMETRY.GOODPUT.ENABLED=True",
                "TELEMETRY.HEALTHZ_STALE_SEC=1.0")
STALL_S = 2.5


def tiny_cfg(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + list(RUN) + list(extra))
    if config_mod is j_config:
        cfg.TPU.MESH_SHAPE = (1, 1)
        cfg.TELEMETRY.ENABLED = False
    cfg.freeze()
    return cfg


def reference_priorities(cfg):
    """The reference's ``Trainer._priorities``: its model's draws from
    ``fold_in(PRNGKey(TRAIN.SEED), step)`` (``tests/test_torch_train.py``
    ``jax_priorities``)."""
    key = jax.random.PRNGKey(cfg.TRAIN.SEED)
    a = sum(j_anchors.num_anchors_per_level(
        (IMG, IMG), tuple(cfg.FPN.ANCHOR_STRIDES), 3))
    n = cfg.RPN.TRAIN_POST_NMS_TOPK + cfg.DATA.MAX_GT_BOXES

    def priorities(batch, step):
        rngs = jax.random.split(jax.random.fold_in(key, step), (BATCH, 2))

        def pair(r, size):
            f, g = jax.random.split(r)
            return (jax.random.uniform(f, (size,)),
                    jax.random.uniform(g, (size,)))

        rpn_fg, rpn_bg = jax.vmap(lambda r: pair(r, a))(rngs[:, 0])
        fr_fg, fr_bg = jax.vmap(lambda r: pair(r, n))(rngs[:, 1])
        return {k: torch.from_numpy(np.array(v)) for k, v in (
            ("rpn_fg", rpn_fg), ("rpn_bg", rpn_bg), ("frcnn_fg", fr_fg),
            ("frcnn_bg", fr_bg))}

    return priorities


def _stalling(batches, logdir, codes, stall_before=2):
    """The batches, with a stall of ``STALL_S`` before batch
    ``stall_before``, while a thread scrapes /healthz every 50 ms."""
    stop = threading.Event()

    def scrape():
        pf = os.path.join(logdir, "telemetry-host0.port")
        while not stop.is_set():
            if os.path.exists(pf):
                with open(pf) as f:
                    port = int(f.read())
                try:
                    codes.append(_get(port, "/healthz")[0])
                except OSError:
                    pass
            stop.wait(0.05)

    th = threading.Thread(target=scrape, daemon=True)
    th.start()
    try:
        for i, b in enumerate(batches):
            if i == stall_before:
                time.sleep(STALL_S)
            yield b
    finally:
        stop.set()
        th.join(timeout=HTTP_TIMEOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's fit of 3 steps from its init, and the port's
    from the same init with its priorities: with the telemetry layer
    off, and on (tracing, goodput, a one-step capture, a stall before
    the third batch under a 1 s liveness bound)."""
    jcfg = tiny_cfg(j_config)
    ds = j_loader.SyntheticDataset(num_images=6, height=IMG, width=IMG,
                                   num_classes=jcfg.DATA.NUM_CLASSES, seed=3)
    loader = j_loader.DetectionLoader(ds.records(), jcfg, BATCH, seed=3,
                                      gt_mask_size=28, prefetch=1)
    batches = list(loader.batches(3))
    jdir = str(tmp_path_factory.mktemp("jax"))
    jt = j_train.Trainer(jcfg, jdir)
    state0 = jt.init_state({k: v for k, v in batches[0].items()
                            if k not in ("image_scale", "image_id")})
    init = jax.device_get(state0.params)
    jt.fit(iter(batches), 3, state=state0)
    jt.ckpt.close()
    with open(os.path.join(jdir, "metrics.jsonl")) as f:
        jrows = {r["step"]: r for r in map(json.loads, f)
                 if "total_loss" in r}
    out = {"jax": jrows}
    for name, extra in (("off", ("TELEMETRY.ENABLED=False",)),
                        ("on", TELEMETRY_ON)):
        cfg = tiny_cfg(t_config, *extra)
        logdir = str(tmp_path_factory.mktemp(name))
        trainer = t_train.Trainer(cfg, logdir, device="cpu")
        trainer.init_state(from_flax(init))
        trainer._priorities = reference_priorities(cfg)
        codes = []
        source = (iter(batches) if name == "off"
                  else _stalling(batches, logdir, codes))
        t0 = time.time()
        rows = trainer.fit(source, 3, profile_steps=int(name == "on"))
        out[name] = {"rows": rows, "logdir": logdir, "codes": codes,
                     "capture": trainer.last_capture,
                     "wall_s": time.time() - t0}
        trainer.close()
    return out


def test_fit_losses_with_telemetry_equal_without_and_match_jax(runs):
    on, off = runs["on"]["rows"], runs["off"]["rows"]
    assert [r["step"] for r in on] == [r["step"] for r in off] == [1, 2, 3]
    for r_on, r_off in zip(on, off):
        for k in LOSS_KEYS + ("grad_norm", "learning_rate"):
            assert r_on[k] == r_off[k], (r_on["step"], k)
    for r in on:
        for k in LOSS_KEYS:
            assert r[k] == pytest.approx(runs["jax"][r["step"]][k],
                                         rel=1e-4), (r["step"], k)
    assert "goodput/ratio" in on[-1] and "goodput/ratio" not in off[-1]


def test_fit_healthz_turns_503_on_a_stall(runs):
    codes = runs["on"]["codes"]
    assert 200 in codes and 503 in codes, codes
    first_503 = codes.index(503)
    assert 200 in codes[:first_503], codes
    assert set(codes) <= {200, 503}


def test_fit_writes_the_trace_the_bank_and_an_attribution(runs):
    run = runs["on"]
    logdir = run["logdir"]
    with open(os.path.join(logdir, "trace-host0.json")) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X"}
    assert {"data_wait", "globalize_batch", "train_step", "host_metrics",
            "host_aggregate", "checkpoint_save"} <= spans
    with open(os.path.join(logdir, "goodput-host0.jsonl")) as f:
        bank = [json.loads(line) for line in f]
    last = bank[-1]
    assert last["final"] and last["mode"] == "spans" and last["steps"] == 3
    b = last["buckets"]
    assert b["compile"] > 0 and b["train_step"] > 0
    assert b["data_wait"] >= STALL_S
    # the buckets hold the segment's wall time, nothing twice
    assert sum(b.values()) == pytest.approx(last["wall_s"], abs=0.01)
    with open(os.path.join(logdir, "events-host0.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    for k in ("compile_start", "compile_done", "profile_capture",
              "profile_capture_done"):
        assert k in kinds, k
    cap = run["capture"]
    assert cap["profiler"] and cap["start_step"] == 1
    assert cap["end_step"] == 2
    with open(cap["attribution"]) as f:
        attr = json.load(f)
    assert os.path.dirname(cap["attribution"]) == os.path.join(logdir,
                                                               "profile")
    table = attr["component_table"]
    assert table["basis"] == "host"        # no device on the CPU
    comps = set(table["component_pct"])
    for c in ("backbone", "backbone-bwd", "fpn-conv", "fpn-conv-bwd",
              "rpn-head", "rpn-head-bwd", "box-head", "box-head-bwd",
              "mask-head", "mask-head-bwd", "roi-fwd", "roi-bwd",
              "rpn-nms", "matching", "sampling", "loss", "optimizer",
              "mask-targets"):
        assert c in comps, c
    assert table["other_pct"] <= 30.0


def test_fit_records_the_ranks_exporter_only_on_local_rank_zero(tmp_path):
    """Two gloo ranks of one host (``LOCAL_WORLD_SIZE=2``) with the same
    fixed ``TELEMETRY.PORT`` and a liveness bound: exactly one exporter
    binds (local rank 0's port file), and no rank logs a bind error."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = s.getsockname()[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        http = s.getsockname()[1]
    workdir = str(tmp_path)
    procs, logs = [], []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX", "XLA"))}
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                   NUM_PROCESSES="1", PROCESS_ID="0",
                   LOCAL_WORLD_SIZE="2", LOCAL_RANK=str(r),
                   EKSML_TEST_HTTP_PORT=str(http), OMP_NUM_THREADS="1")
        logs.append(open(os.path.join(workdir, f"rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_dist_ranks.py"),
             "exporter", workdir],
            cwd=REPO, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    text = []
    for f in logs:
        f.seek(0)
        text.append(f.read())
        f.close()
    assert rcs == [0, 0], text
    run = os.path.join(workdir, "exporter")
    ports = sorted(n for n in os.listdir(run) if n.endswith(".port"))
    assert ports == ["telemetry-host0.port"], (ports, text)
    with open(os.path.join(run, ports[0])) as f:
        assert int(f.read()) == http
    for t in text:
        assert "cannot bind" not in t and "liveness bound" not in t, t
    assert "EXPORTER 1" in text[0] and "EXPORTER 0" in text[1], text
