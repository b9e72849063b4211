"""Serving from the port's checkpoints on the CPU: ``InferenceEngine`` /
``OfflinePredictor(checkpoint_dir=...)`` against the reference's restore
of the same weights, verified hot-reload (``serve/reload.py``), which
fails closed on every rejection, ``/admin/reload`` and
``python -m eksml_tpu_torch.serve --checkpoint-dir``, and the served
step of a batch computed across a swap.

Checkpoints: a port training logdir with step 1 (a seeded Flax init
through ``convert.from_flax``) and step 2 (the port's own seeded init),
written by the port's ``Trainer``; the reference's Orbax checkpoint of
the same Flax init at step 1.  SMOKE widths, buckets 64x128 and 128x128,
rungs (1, 4).  Tolerances as ``tests/test_torch_serve.py``: boxes 1e-3
px, scores 1e-5, masks 1e-4; equal classes and valid rows."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

jax.config.update("jax_platforms", "cpu")

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu import train as j_train  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN  # noqa: E402
from eksml_tpu.predict.predictor import \
    restore_predict_params as j_restore  # noqa: E402
from eksml_tpu.serve.engine import InferenceEngine as JaxEngine  # noqa: E402
from eksml_tpu.utils import checkpoint as j_checkpoint  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import telemetry  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.convert import from_flax, init_params  # noqa: E402
from eksml_tpu_torch.predict import OfflinePredictor  # noqa: E402
from eksml_tpu_torch.resilience import integrity  # noqa: E402
from eksml_tpu_torch.serve import (InferenceEngine,  # noqa: E402
                                   MicroBatcher, ReloadManager,
                                   ServingServer)
from eksml_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402

SERVE = ("PREPROC.TEST_SHORT_EDGE_SIZE=128", "RPN.TEST_PRE_NMS_TOPK=64",
         "RPN.TEST_POST_NMS_TOPK=32", "SERVE.BUCKETS=((64,128),(128,128))",
         "SERVE.MAX_BATCH_SIZE=4", "SERVE.BATCH_SIZES=(1,4)",
         "SERVE.MAX_BATCH_DELAY_MS=25.0")


def tiny_cfg(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + ["TELEMETRY.PORT=0"]
                    + list(extra))
    cfg.freeze()
    return cfg


def _img(seed, h=100, w=80):
    return np.random.RandomState(seed).randint(
        0, 255, (h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def serve_cfg():
    return tiny_cfg(t_config, *SERVE)


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxMaskRCNN.from_config(tiny_cfg(j_config, *SERVE))
    images = jnp.zeros((1, 128, 128, 3), jnp.uint8)
    hw = jnp.asarray([[128, 128]], jnp.float32)
    params = jax.jit(lambda r: model.init(
        r, images, hw, method=FlaxMaskRCNN.predict))(jax.random.PRNGKey(0))
    return jax.device_get(params["params"])


@pytest.fixture(scope="module")
def params_b(serve_cfg):
    return init_params(serve_cfg, torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def logdir(tmp_path_factory, flax_params, params_b):
    """The port trainer's checkpoints: step 1 = the Flax init, step 2 =
    the port's seed-1 init."""
    d = str(tmp_path_factory.mktemp("train"))
    trainer = t_train.Trainer(tiny_cfg(t_config), d, device="cpu")
    for step, params in ((1, from_flax(flax_params)), (2, params_b)):
        trainer.init_state(params)
        trainer.step = step
        trainer.ckpt.save(step, trainer.checkpoint_state())
    trainer.close()
    return d


@pytest.fixture(scope="module")
def canvases(serve_cfg, params_b):
    """Preprocessed 100x80 images by seed: (canvas, hw, bucket)."""
    eng = InferenceEngine(serve_cfg, params=params_b, device="cpu")
    out = {}
    for seed in (21, 22, 31, 32, 41):
        canvas, _, (nh, nw), b = eng.preprocess(_img(seed))
        out[seed] = (canvas[None], np.asarray([[nh, nw]], np.float32), b)
    eng.close()
    return out


@pytest.fixture(scope="module")
def reference_out(tmp_path_factory, flax_params, canvases):
    """The reference's restore of its own checkpoint of the same weights
    (a TrainState at step 1), run by its engine on two canvases."""
    jcfg = tiny_cfg(j_config, *SERVE)
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    tx, _ = j_train.make_optimizer(jcfg)
    state = j_train.TrainState(
        step=jnp.asarray(1, jnp.int32), params=flax_params,
        opt_state=tx.init(flax_params), rng=jax.random.PRNGKey(0))
    m = j_checkpoint.CheckpointManager(d)
    m.save(1, state)
    m.close()
    jeng = JaxEngine(jcfg, params=j_restore(
        jcfg, FlaxMaskRCNN.from_config(jcfg), d, 1))
    return [_infer(jeng, canvases[seed]) for seed in (21, 22)]


def _infer(engine, canvas):
    """One preprocessed image at rung 1 (``engine`` of either package)."""
    return engine.infer(*canvas, rung=1)


def _close(got, want):
    assert set(got) == set(want)
    assert got["valid"].any()
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def engine(serve_cfg, logdir):
    """ONE warmed port engine restored from step 1."""
    eng = InferenceEngine(serve_cfg, checkpoint_dir=logdir, checkpoint_step=1,
                          device="cpu")
    assert eng.warmup() == 4
    yield eng
    eng.close()


# ---------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["engine", "predictor"])
def test_restored_weights_match_the_reference(entry, serve_cfg, logdir,
                                              canvases, reference_out):
    if entry == "engine":
        eng = InferenceEngine(serve_cfg, checkpoint_dir=logdir,
                              checkpoint_step=1, device="cpu")
        assert eng.params_step == 1
        outs = [_infer(eng, canvases[seed]) for seed in (21, 22)]
        eng.close()
    else:
        pred = OfflinePredictor(serve_cfg, checkpoint_dir=logdir,
                                checkpoint_step=1, device="cpu")
        outs = [pred.raw(_img(seed))[0] for seed in (21, 22)]
    for got, want in zip(outs, reference_out):
        _close(got, want)


def test_latest_step_resolves_at_construction(serve_cfg, logdir, params_b):
    eng = InferenceEngine(serve_cfg, checkpoint_dir=logdir, device="cpu")
    assert eng.params_step == 2
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, params_b[k]), k
    eng.close()


# ---------------------------------------------------------------------
# hot-reload
# ---------------------------------------------------------------------


def test_good_reload_swaps_without_request_path_compiles(engine, serve_cfg,
                                                         logdir, params_b,
                                                         canvases):
    mgr = ReloadManager(engine, logdir)
    ok = mgr.reload_step(1)
    assert ok["ok"], ok
    before = _infer(engine, canvases[31])
    outcome = mgr.reload_step(2)
    assert outcome["ok"] and outcome["step"] == 2, outcome
    assert outcome["previous_step"] == 1
    assert set(mgr.last_timings) == {"verify_ms", "restore_ms", "swap_ms"}
    assert engine.params_step == 2 and mgr.reloads == 2
    after = _infer(engine, canvases[31])
    fresh = InferenceEngine(serve_cfg, params=params_b, device="cpu")
    want = _infer(fresh, canvases[31])
    fresh.close()
    for k in want:
        np.testing.assert_array_equal(after[k], want[k])
    assert not np.array_equal(after["scores"], before["scores"])
    assert engine.request_path_compiles == 0
    # the watcher finds nothing newer than step 2
    assert mgr.latest_candidate() is None and mgr.poll_once() is None


def _bad_step(logdir, tmp_path, reason):
    """A copy of ``logdir`` plus a step 3 that fails by ``reason``."""
    d = str(tmp_path / "logdir")
    shutil.copytree(logdir, d)
    root = os.path.join(d, "checkpoints")
    if reason == "integrity":                 # committed, no manifest
        shutil.copytree(os.path.join(root, "2"), os.path.join(root, "3"))
    elif reason == "structure":               # a tensor of another shape
        state = CheckpointManager(d).restore(2)
        model = state["model"]
        k = next(k for k in sorted(model) if model[k].dim() == 2)
        model[k] = torch.zeros(model[k].shape[0], model[k].shape[1] + 1)
        m = CheckpointManager(d)
        m.save(3, state)
        m.close()
    else:
        shutil.copytree(os.path.join(root, "2"), os.path.join(root, "3"))
        integrity.write_manifest(root, 3)
    return d


@pytest.mark.parametrize("reason", ["integrity", "restore", "structure",
                                    "draining"])
def test_rejected_reload_keeps_the_old_weights(engine, logdir, canvases,
                                               tmp_path, reason):
    d = _bad_step(logdir, tmp_path, reason)

    def broken_restore(step):
        raise OSError("stale file handle")

    mgr = ReloadManager(
        engine, d,
        restore_fn=broken_restore if reason == "restore" else None,
        is_draining=(lambda: True) if reason == "draining" else None)
    counter = telemetry.default_registry().counter(
        "eksml_serve_reload_rejected", labels={"reason": reason})
    seen = counter.value
    step_before = engine.params_step
    before = _infer(engine, canvases[32])
    outcome = mgr.reload_step(None if reason == "integrity" else 3)
    assert not outcome["ok"] and outcome["reason"] == reason, outcome
    assert outcome["step"] == 3
    assert engine.params_step == step_before
    after = _infer(engine, canvases[32])
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    assert mgr.rejected == 1 and mgr.reloads == 0
    assert counter.value == seen + 1
    assert engine.request_path_compiles == 0
    if reason == "integrity":
        # the watcher remembers a step it saw rejected
        assert "manifest missing" in outcome["detail"]
        assert mgr._rejected == {3: "integrity"}
        assert mgr.latest_candidate() != 3


def test_served_step_names_the_weights_that_computed_it(serve_cfg, logdir,
                                                        params_b, canvases):
    """A swap lands between a batch's device call and its postprocess:
    that batch still reports the step whose weights computed it, and
    the next batch the new step."""
    eng = InferenceEngine(serve_cfg, checkpoint_dir=logdir,
                          checkpoint_step=1, device="cpu")
    img = _img(41)
    want_a = _infer(eng, canvases[41])["scores"][0]
    real_infer = eng.infer
    swapped = []

    def infer_then_swap(*args, **kwargs):
        out = real_infer(*args, **kwargs)
        if not swapped:
            swapped.append(True)
            eng.swap_params(params_b, step=2)
        return out

    eng.infer = infer_then_swap
    batcher = MicroBatcher(eng, serve_cfg)
    try:
        first = batcher.submit(img, raw_topk=8)
        first.wait_result(timeout=60)
        second = batcher.submit(img, raw_topk=8)
        second.wait_result(timeout=60)
    finally:
        batcher.close()
        eng.close()
    fresh = InferenceEngine(serve_cfg, params=params_b, device="cpu")
    want_b = _infer(fresh, canvases[41])["scores"][0]
    fresh.close()
    assert swapped
    assert (first.served_step, second.served_step) == (1, 2)
    np.testing.assert_allclose(first.raw_top["scores"],
                               np.sort(want_a)[::-1][:8], rtol=0, atol=0)
    np.testing.assert_allclose(second.raw_top["scores"],
                               np.sort(want_b)[::-1][:8], rtol=0, atol=0)


def _post(url, path, payload=None):
    data = b"" if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_admin_reload_endpoint_and_drain(serve_cfg, logdir):
    eng = InferenceEngine(serve_cfg, checkpoint_dir=logdir,
                          checkpoint_step=1, device="cpu")
    server = ServingServer(MicroBatcher(eng, serve_cfg), port=0,
                           addr="127.0.0.1").start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        assert _post(url, "/admin/reload")[0] == 503     # no manager
        server.reload_manager = ReloadManager(
            eng, logdir, lock=server.lifecycle_lock,
            is_draining=server.draining.is_set)
        code, body = _post(url, "/admin/reload")          # the latest
        assert (code, body["ok"], body["step"]) == (200, True, 2), body
        code, body = _post(url, "/admin/reload", {"step": 99})
        assert (code, body["reason"]) == (409, "integrity"), body
        code, body = _post(url, "/admin/reload", {"step": 1})
        assert (code, body["step"], body["previous_step"]) == (200, 1, 2)
        health = server.health()[1]
        assert (health["params_step"], health["reloads"],
                health["reload_rejected"]) == (1, 2, 1)
        server.draining.set()
        out = server.reload_manager.reload_step(2)
        assert out["reason"] == "draining" and eng.params_step == 1
    finally:
        server.drain(timeout=30)
        eng.close()


def test_main_serves_a_checkpoint_and_reloads(logdir, tmp_path):
    """``python -m eksml_tpu_torch.serve --checkpoint-dir ... --step 1``:
    serves step 1, ``POST /admin/reload`` moves it to the latest step,
    SIGTERM drains and exits 0."""
    port_file = str(tmp_path / "serve.port")
    proc = subprocess.Popen(
        [sys.executable, "-m", "eksml_tpu_torch.serve", "--checkpoint-dir",
         logdir, "--step", "1", "--device", "cpu", "--port", "0", "--addr",
         "127.0.0.1", "--port-file", port_file, "--config",
         *SMOKE_OVERRIDES, *SERVE, "SERVE.RELOAD_POLL_SEC=0"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                url = f"http://127.0.0.1:{int(open(port_file).read())}"
                health = json.load(urllib.request.urlopen(url + "/healthz"))
                break
            except (OSError, ValueError):
                time.sleep(0.2)
        assert health is not None and health["status"] == "ok", \
            proc.stdout.read() if proc.poll() is not None else health
        assert health["params_step"] == 1
        code, body = _post(url, "/admin/reload")
        assert (code, body["step"]) == (200, 2), body
        health = json.load(urllib.request.urlopen(url + "/healthz"))
        assert (health["params_step"], health["reloads"],
                health["request_path_compiles"]) == (2, 1, 0)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "drain complete" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    events = [json.loads(line) for line in
              open(os.path.join(logdir, "events-hostserve.jsonl"))]
    assert [e["step"] for e in events if e["kind"] == "serve_reload"] == [2]
