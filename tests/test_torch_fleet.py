"""The port's serving fleet on the CPU, against the reference: the load and
shadow-replay tool (``eksml_tpu_torch/tools/serve_loadtest.py`` against
``tools/serve_loadtest.py``), the promotion controller of
``eksml_tpu_torch/tools/eksml_operator.py``, and the serve chart's
argument list (``--serve-id``).

Two serving tracks run in this process, as ``chip_smoke.py``'s fleet phase
runs them on the card: each its own engine, ``ServingServer``,
``ReloadManager`` and flight recorder (``events-hoststable.jsonl``,
``events-hostcanary.jsonl``), over one logdir whose steps 1 and 2 the
port's ``Trainer`` wrote through its ``CheckpointManager`` (two seeded
inits).  SMOKE widths, buckets 64x128 and 128x128, rungs (1, 4).

Tolerances: ``detection_drift`` 1e-12 against the reference; drift between
two tracks serving the same step exactly 0; the rest exact."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import eksml_operator as j_op  # noqa: E402
import serve_loadtest as j_lt  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu_torch.convert import init_params  # noqa: E402
from eksml_tpu_torch.serve import (InferenceEngine,  # noqa: E402
                                   MicroBatcher, ReloadManager,
                                   ServingServer)
from eksml_tpu_torch.telemetry.recorder import (  # noqa: E402
    FlightRecorder, events_path_for)
from eksml_tpu_torch.tools import eksml_operator as t_op  # noqa: E402
from eksml_tpu_torch.tools import serve_loadtest as t_lt  # noqa: E402

SERVE = ("PREPROC.TEST_SHORT_EDGE_SIZE=128", "RPN.TEST_PRE_NMS_TOPK=64",
         "RPN.TEST_POST_NMS_TOPK=32", "SERVE.BUCKETS=((64,128),(128,128))",
         "SERVE.MAX_BATCH_SIZE=4", "SERVE.BATCH_SIZES=(1,4)",
         "SERVE.MAX_BATCH_DELAY_MS=25.0")
#: the bank's request sizes: both buckets, landscape and portrait
SIZES = "100x80,80x100,64x128,120x120"
BANK_REQUESTS = 8


def tiny_cfg(*extra):
    cfg = t_config.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + ["TELEMETRY.PORT=0"]
                    + list(extra))
    cfg.freeze()
    return cfg


# ---- the tool's pure parts against the reference ---------------------------


def _raw(rng, k, classes):
    return {"scores": [float(s) for s in rng.uniform(0, 1, k)],
            "classes": [int(c) for c in rng.randint(1, classes, k)],
            "boxes": rng.uniform(0, 100, (k, 4)).tolist()}


def _dets(rng, n):
    out = []
    for _ in range(n):
        x0, y0 = rng.uniform(0, 50, 2)
        w, h = rng.uniform(5, 40, 2)
        out.append({"box": [x0, y0, x0 + w, y0 + h],
                    "class_id": int(rng.randint(1, 3)),
                    "score": float(rng.uniform(0.05, 1))})
    return out


def test_detection_drift_equals_the_reference():
    rng = np.random.RandomState(3)
    pairs = []
    for k in (0, 1, 5, 16):
        a = _raw(rng, k, 3)
        b = {"scores": [s + float(rng.normal(0, 0.05)) for s in a["scores"]],
             "classes": [c if rng.rand() < 0.7 else c + 1
                         for c in a["classes"]], "boxes": a["boxes"]}
        pairs += [({"raw_top": a}, {"raw_top": b}),
                  ({"raw_top": a}, {"raw_top": a}),
                  ({"raw_top": a}, {"raw_top": _raw(rng, k + 2, 5)})]
    for na, nb in ((0, 0), (3, 0), (0, 2), (4, 4), (6, 3)):
        da = _dets(rng, na)
        db = [dict(d, box=[v + float(rng.normal(0, 2)) for v in d["box"]])
              for d in da[:nb]] + _dets(rng, max(0, nb - na))
        pairs += [({"detections": da}, {"detections": db}),
                  ({"detections": da}, {"detections": list(da)})]
    # rows a predict marks invalid score -inf: the reference scores two
    # identical such answers 1.0 (abs(-inf - -inf) is nan, and
    # min(1.0, nan) is 1.0); the port compares equal scores first and
    # gives 0, as for any two identical answers (a deliberate difference)
    dead = {"scores": [float("-inf")] * 4, "classes": [1, 2, 3, 4],
            "boxes": [[0.0, 0.0, 1.0, 1.0]] * 4}
    pairs.append(({"raw_top": dead}, {"raw_top": dead}))
    got = [t_lt.detection_drift(a, b) for a, b in pairs]
    want = [j_lt.detection_drift(a, b) for a, b in pairs]
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=0, atol=1e-12)
    assert 0.0 < max(got) <= 1.0 and min(got) == 0.0
    assert got[-1] == 0.0 and want[-1] == 1.0


def test_bank_images_and_artifact_naming_equal_the_reference(tmp_path):
    bank, ref = (m.build_bank(7, SIZES, 6) for m in (t_lt, j_lt))
    assert {k: v for k, v in bank.items() if k != "recorded_at"} == \
        {k: v for k, v in ref.items() if k != "recorded_at"}
    for row in bank["requests"]:
        np.testing.assert_array_equal(t_lt.bank_image(bank, row),
                                      j_lt.bank_image(ref, row))
    p1 = t_lt.next_bank_path(str(tmp_path), prefix="shadow")
    assert p1 == j_lt.next_bank_path(str(tmp_path), prefix="shadow")
    assert os.path.basename(p1) == "shadow_r1.json"
    open(p1, "w").write("{}")
    assert os.path.basename(t_lt.next_bank_path(
        str(tmp_path), prefix="shadow")) == "shadow_r2.json"
    text = ('eksml_serve_requests_total{outcome="ok"} 5\n'
            'eksml_serve_batches_total 3\n')
    for name, labels in (("eksml_serve_requests_total", '{outcome="ok"}'),
                         ("eksml_serve_batches_total", ""),
                         ("eksml_missing", "")):
        assert t_lt.metric_value(text, name, labels) == \
            j_lt.metric_value(text, name, labels)
    out = str(tmp_path / "bank.json")
    assert t_lt.main(["--record", out, "--seed", "7", "--sizes", SIZES,
                      "--requests", "6"]) == 0
    with open(out) as f:
        assert json.load(f)["requests"] == ref["requests"]


# ---- two serving tracks ----------------------------------------------------


@pytest.fixture(scope="module")
def serve_cfg():
    return tiny_cfg(*SERVE)


@pytest.fixture(scope="module")
def logdir(tmp_path_factory, serve_cfg):
    """The port trainer's checkpoints: steps 1 and 2, seeded inits 0 and 1."""
    d = str(tmp_path_factory.mktemp("fleet"))
    trainer = t_train.Trainer(tiny_cfg(), d, device="cpu")
    for step, seed in ((1, 0), (2, 1)):
        trainer.init_state(init_params(serve_cfg,
                                       torch.Generator().manual_seed(seed)))
        trainer.step = step
        trainer.ckpt.save(step, trainer.checkpoint_state())
    trainer.close()
    return d


class Track:
    """One serving track in this process, started at ``step``."""

    def __init__(self, cfg, logdir, serve_id, step):
        self.engine = InferenceEngine(cfg, checkpoint_dir=logdir,
                                      checkpoint_step=step, device="cpu")
        self.server = ServingServer(MicroBatcher(self.engine, cfg), port=0,
                                    addr="127.0.0.1")
        self.recorder = FlightRecorder(
            path=events_path_for(logdir, serve_id), host_id=serve_id)
        self.server.reload_manager = ReloadManager(
            self.engine, logdir, lock=self.server.lifecycle_lock,
            is_draining=self.server.draining.is_set,
            recorder=self.recorder)
        self.server.start()
        assert self.engine.warmup() == 4
        self.server.mark_ready()
        self.url = f"http://127.0.0.1:{self.server.port}"

    def close(self):
        self.server.drain(timeout=30)
        self.engine.close()
        self.recorder.close()


@pytest.fixture(scope="module")
def tracks(serve_cfg, logdir):
    stable = Track(serve_cfg, logdir, "stable", 1)
    canary = Track(serve_cfg, logdir, "canary", 1)
    yield stable, canary
    stable.close()
    canary.close()


@pytest.fixture(scope="module")
def bank():
    return t_lt.build_bank(11, SIZES, BANK_REQUESTS)


def test_run_load_closed_and_open_loop(tracks, tmp_path):
    stable, _ = tracks
    closed = t_lt.run_load(stable.url, 8, 4, seed=1, sizes=SIZES)
    opened = t_lt.run_load(stable.url, 8, 2, mode="open", rate=40.0,
                           seed=1, sizes=SIZES)
    for art in (closed, opened):
        assert (art["completed"], art["errors"]) == (8, 0), art
        assert all(art["phase_ms"][ph]["mean"] is not None
                   for ph in t_lt.PHASES), art["phase_ms"]
        assert art["latency_ms"]["p99"] >= art["latency_ms"]["p50"] > 0
        assert art["images_per_sec"] > 0
    assert opened["open_loop"]["workers"] == 8
    assert closed["open_loop"] is None
    out = str(tmp_path / "serve.json")
    assert t_lt.main(["--url", stable.url, "--requests", "4",
                      "--concurrency", "2", "--sizes", SIZES,
                      "--out", out]) == 0
    with open(out) as f:
        art = json.load(f)
    assert art["zero_request_path_compiles"] is True
    assert art["engine"]["request_path_compiles"] == 0
    assert art["metrics"]["request_path_compiles"] == 0


def test_shadow_drift_is_zero_on_one_step_and_not_on_two(tracks, bank):
    stable, canary = tracks
    same = t_lt.replay_shadow(bank, stable.url, canary.url, raw_topk=8)
    assert same["scored"] == BANK_REQUESTS and same["canary_error_rate"] == 0
    assert same["drift"] == {"mean": 0.0, "p99": 0.0, "max": 0.0}
    assert same["canary"]["params_steps"] == [1]
    # the reference's replay over the same two port servers agrees
    ref = j_lt.replay_shadow(bank, stable.url, canary.url, raw_topk=8)
    assert ref["drift"] == same["drift"] and ref["scored"] == same["scored"]
    code, body = _post(canary.url, "/admin/reload", {"step": 2})
    assert (code, body["step"]) == (200, 2), body
    other = t_lt.replay_shadow(bank, stable.url, canary.url, raw_topk=8)
    assert other["drift"]["mean"] > 0.0
    assert other["canary"]["params_steps"] == [2]
    assert other["incumbent"]["params_steps"] == [1]


def _post(url, path, payload=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload or {}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _step(url):
    return t_lt.fetch_health(url)["params_step"]


def test_promotion_controller_promotes_then_rolls_back(tracks, bank,
                                                       logdir):
    stable, canary = tracks
    assert (_step(stable.url), _step(canary.url)) == (1, 2)
    # the latency gate is opened wide: CPU latencies of two tracks in one
    # process are not what this test holds; drift and streak are
    knobs = dict(t_config.RESILIENCE_AUTOSCALE_DEFAULTS,
                 CANARY_MIN_REQUESTS=BANK_REQUESTS,
                 CANARY_P99_RATIO_MAX=1e6, CANARY_DRIFT_MAX=1.0,
                 CANARY_PROMOTE_STREAK=2)
    ctl = t_op.PromotionController(logdir, stable.url, canary.url, bank,
                                   knobs, raw_topk=8)
    outs = [ctl.tick() for _ in range(2)]
    assert [o["verdict"] for o in outs] == ["promote", "promote"]
    assert "reload" not in outs[0] and outs[1]["reload"]["ok"]
    for o in outs:
        assert t_op.promotion_verdict(o["score"], knobs) == \
            j_op.promotion_verdict(o["score"], knobs)
    assert (_step(stable.url), _step(canary.url)) == (2, 2)
    held = ctl.tick()
    assert held["verdict"] == "hold" and "converged" in held["reason"]
    # a canary on another step, and a gate no drift passes
    assert _post(canary.url, "/admin/reload", {"step": 1})[0] == 200
    ctl.knobs = dict(knobs, CANARY_DRIFT_MAX=0.0)
    back = ctl.tick()
    assert back["verdict"] == "rollback" and back["reload"]["ok"], back
    assert back["reason"] == j_op.promotion_verdict(
        back["score"], ctl.knobs)[1]
    assert (_step(stable.url), _step(canary.url)) == (2, 2)
    assert (ctl.promotions, ctl.rollbacks) == (1, 1)

    def rows(name):
        with open(os.path.join(logdir, name)) as f:
            return [json.loads(line) for line in f]

    assert [r["verdict"] for r in rows("canary-host0.jsonl")] == [
        "promote", "promote", "hold", "rollback"]
    cd = [r["kind"] for r in rows("events-hostcd.jsonl")]
    assert cd == ["canary_score", "canary_score", "canary_promote",
                  "canary_score", "canary_rollback"]
    assert [r["step"] for r in rows("events-hoststable.jsonl")
            if r["kind"] == "serve_reload"] == [2]
    assert [r["step"] for r in rows("events-hostcanary.jsonl")
            if r["kind"] == "serve_reload"] == [2, 1, 2]
    assert {r["host"] for r in rows("events-hostcanary.jsonl")} == {"canary"}
    assert stable.engine.request_path_compiles == 0
    assert canary.engine.request_path_compiles == 0


# ---- the serve chart's argument list ----------------------------------------

#: the canary Deployment's --config items (charts/golden/serve__serve.yaml)
CHART_CANARY = ("SERVE.PORT=8081", "SERVE.MAX_BATCH_SIZE=4",
                "SERVE.MAX_BATCH_DELAY_MS=5", "SERVE.MAX_QUEUE=256",
                "SERVE.RESULT_MASKS=False", "SERVE.RELOAD_POLL_SEC=30",
                "TRAIN.PRECISION=bfloat16", "TEST.RESULT_SCORE_THRESH=0.05")


def test_chart_items_match_the_golden_chart():
    with open(os.path.join(REPO, "charts", "golden",
                           "serve__serve.yaml")) as f:
        text = f.read()
    block = text[text.index("- canary\n"):]
    block = block[block.index("- --config\n"):block.index("resources:")]
    items = [line.strip()[2:] for line in block.splitlines()[1:]
             if line.strip().startswith("- ")]
    assert tuple(items) == CHART_CANARY


def test_chart_arguments_serve_with_a_serve_id(logdir, tmp_path):
    """``python -m eksml_tpu_torch.serve --checkpoint-dir D --serve-id
    canary`` with the chart's items (SMOKE widths, one small bucket after
    them): serves the latest step, records its reload in
    ``D/events-hostcanary.jsonl``, drains with rc 0 on SIGTERM."""
    port_file = str(tmp_path / "serve.port")
    before = os.path.getsize(events_path_for(logdir, "canary"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "eksml_tpu_torch.serve", "--checkpoint-dir",
         logdir, "--serve-id", "canary", "--device", "cpu", "--port", "0",
         "--addr", "127.0.0.1", "--port-file", port_file, "--config",
         *CHART_CANARY, *SMOKE_OVERRIDES, *SERVE[:3],
         "SERVE.BUCKETS=((128,128),)"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                url = f"http://127.0.0.1:{int(open(port_file).read())}"
                health = t_lt.wait_ready(url, budget=5)
                break
            except (OSError, ValueError, TimeoutError):
                time.sleep(0.2)
        assert health is not None and health["params_step"] == 2, \
            proc.stdout.read() if proc.poll() is not None else health
        art = t_lt.run_load(url, 4, 2, seed=3, sizes=SIZES)
        assert (art["completed"], art["errors"]) == (4, 0)
        assert _post(url, "/admin/reload", {"step": 1})[0] == 200
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "drain complete" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    with open(events_path_for(logdir, "canary")) as f:
        f.seek(before)
        new = [json.loads(line) for line in f]
    assert [(e["kind"], e["step"], e["host"]) for e in new] == [
        ("serve_reload", 1, "canary")]
