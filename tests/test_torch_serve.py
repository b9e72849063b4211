"""The PyTorch port's serving path (``eksml_tpu_torch/serve``) on the CPU:
the contracts of ``tests/test_serve.py`` held on the port, plus the
engine against the JAX ``InferenceEngine`` on the same converted
params.  ONE module-scoped port engine and ONE JAX engine (one compile)
serve every test."""

import base64
import json
import os
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

jax.config.update("jax_platforms", "cpu")

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN  # noqa: E402
from eksml_tpu.serve.engine import InferenceEngine as JaxEngine  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch.convert import from_flax  # noqa: E402
from eksml_tpu_torch.predict import OfflinePredictor  # noqa: E402
from eksml_tpu_torch.serve import (InferenceEngine,  # noqa: E402
                                   MicroBatcher, ServingServer)
from eksml_tpu_torch.serve.batcher import DrainingError  # noqa: E402

BUCKETS = ((64, 128), (128, 128))


def tiny_serve_cfg(config_mod):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES))
    cfg.PREPROC.TEST_SHORT_EDGE_SIZE = 128
    cfg.RPN.TEST_PRE_NMS_TOPK = 64
    cfg.RPN.TEST_POST_NMS_TOPK = 32
    cfg.SERVE.BUCKETS = BUCKETS
    cfg.SERVE.MAX_BATCH_SIZE = 4
    cfg.SERVE.BATCH_SIZES = (1, 4)
    cfg.SERVE.MAX_BATCH_DELAY_MS = 25.0
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def serve_cfg():
    return tiny_serve_cfg(t_config)


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxMaskRCNN.from_config(tiny_serve_cfg(j_config))
    images = jnp.zeros((1, 128, 128, 3), jnp.uint8)
    hw = jnp.asarray([[128, 128]], jnp.float32)
    params = jax.jit(lambda r: model.init(
        r, images, hw, method=FlaxMaskRCNN.predict))(jax.random.PRNGKey(0))
    return jax.device_get(params["params"])


@pytest.fixture(scope="module")
def engine(serve_cfg, flax_params):
    """ONE warmed port engine: 2 buckets × rungs (1, 4)."""
    eng = InferenceEngine(serve_cfg, params=from_flax(flax_params),
                          device="cpu")
    n = eng.warmup()
    assert n == len(eng.buckets) * len(eng.rungs) == 4
    yield eng
    eng.close()


def _img(seed, h=100, w=80):
    return np.random.RandomState(seed).randint(
        0, 255, (h, w, 3)).astype(np.uint8)


# ---------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------


def test_warmup_covers_every_bucket_and_rung(engine):
    assert engine.compiles == 4 and engine.warmed
    assert engine._exes == {(b, r) for b in range(2) for r in (1, 4)}
    # mixed request shapes, both buckets: nothing new on the request path
    seen = set()
    for seed, (h, w) in enumerate([(100, 80), (40, 100), (128, 128),
                                   (30, 90), (60, 60)]):
        canvas, scale, (nh, nw), b = engine.preprocess(_img(seed, h, w))
        seen.add(b)
        assert canvas.shape[:2] == BUCKETS[b] and canvas.dtype == np.uint8
        out = engine.infer(canvas[None], np.asarray([[nh, nw]], np.float32),
                           b)
        assert out["boxes"].shape == (1, 8, 4)
    assert seen == {0, 1}
    assert engine.request_path_compiles == 0
    assert engine.compiles == 4


def test_batch_of_n_identical_to_padded_singles(engine):
    """Rows of a batch-of-4 dispatch equal the same images dispatched
    one at a time through the same rung (padded with zero images)."""
    pre = [engine.preprocess(_img(s, 100, 80)) for s in range(4)]
    bucket = pre[0][3]
    canvases = np.stack([p[0] for p in pre])
    hw = np.asarray([[p[2][0], p[2][1]] for p in pre], np.float32)
    batched = engine.infer(canvases, hw, bucket, rung=4)
    for i in range(4):
        single = engine.infer(canvases[i:i + 1], hw[i:i + 1], bucket, rung=4)
        for key in batched:
            np.testing.assert_array_equal(
                single[key][0], batched[key][i],
                err_msg=f"{key} differs for image {i}: batch padding "
                        "leaked across requests")
    assert engine.request_path_compiles == 0


def test_oversized_image_force_fits_largest_bucket(engine):
    big = _img(7, 600, 900)
    b = engine.assign(600, 900)
    assert b == len(engine.buckets) - 1
    canvas, scale, (nh, nw), bb = engine.preprocess(big)
    assert bb == b and canvas.shape[:2] == tuple(engine.buckets[b])
    assert scale < 128 / 600
    assert nh <= engine.buckets[b][0] and nw <= engine.buckets[b][1]
    out = engine.infer(canvas[None], np.asarray([[nh, nw]], np.float32), bb)
    valid = out["valid"][0] > 0
    if valid.any():
        boxes = out["boxes"][0][valid] / scale
        assert boxes[:, [0, 2]].max() <= 900 + 1e-3
        assert boxes[:, [1, 3]].max() <= 600 + 1e-3
    assert engine.request_path_compiles == 0


def test_engine_matches_jax_engine(engine, flax_params):
    """The port engine against ``eksml_tpu``'s InferenceEngine on the
    same converted params and the same canvases (rung 4, 2 rows):
    equal classes and valid; boxes to 1e-3 px, scores to 1e-5 and masks
    to 1e-4 (float32 on both sides, sums in different orders)."""
    jcfg = tiny_serve_cfg(j_config)
    jeng = JaxEngine(jcfg, params=flax_params)
    pre = [engine.preprocess(_img(s, 100, 80)) for s in (21, 22)]
    bucket = pre[0][3]
    canvases = np.stack([p[0] for p in pre])
    hw = np.asarray([list(p[2]) for p in pre], np.float32)
    want = jeng.infer(canvases, hw, bucket, rung=4)
    got = engine.infer(canvases, hw, bucket, rung=4)
    assert set(got) == set(want)
    assert got["valid"].any()
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=1e-4)


def test_entry_points_default_to_cuda_and_raise_without_it(serve_cfg,
                                                           flax_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(serve_cfg, params=from_flax(flax_params))
    with pytest.raises(RuntimeError, match="cuda"):
        OfflinePredictor(serve_cfg, params=from_flax(flax_params))


def test_checkpoint_restore_waits_for_the_trainer_slice(serve_cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        InferenceEngine(serve_cfg, checkpoint_dir="ckpt", device="cpu")


def test_host_pre_and_postprocess_match_jax():
    """The port's numpy copies against ``eksml_tpu.data``: bucket
    assignment, resize/pad (the reference may take its C++ resize, so
    to 1e-3 of 255), mask paste and RLE."""
    from eksml_tpu.data import loader as j_loader
    from eksml_tpu.data import masks as j_masks
    from eksml_tpu_torch.data import loader as t_loader
    from eksml_tpu_torch.data import masks as t_masks

    for h, w in [(100, 80), (40, 100), (600, 900), (128, 128)]:
        assert t_loader.assign_bucket(h, w, 128, 128, BUCKETS) == \
            j_loader.assign_bucket(h, w, 128, 128, BUCKETS)
        img = _img(h + w, h, w)
        got = t_loader.resize_and_pad(img, 128, 128, (128, 128))
        want = j_loader.resize_and_pad(img, 128, 128, (128, 128))
        assert got[1:] == want[1:]
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    rng = np.random.RandomState(3)
    for box in ([10.2, 5.7, 60.9, 44.1], [-5, -5, 30, 200], [70, 10, 70, 40]):
        m28 = rng.rand(28, 28).astype(np.float32)
        got = t_masks.paste_mask(m28, box, 100, 80)
        np.testing.assert_array_equal(got, j_masks.paste_mask(m28, box,
                                                              100, 80))
        rle = t_masks.rle_encode(got)
        assert rle["size"] == [100, 80] and sum(rle["counts"]) == 8000
        want = j_masks.rle_encode(got)
        assert list(rle["counts"]) == list(want["counts"])


# ---------------------------------------------------------------------
# batcher and HTTP server
# ---------------------------------------------------------------------


def test_concurrent_submits_batch_and_drain(engine, serve_cfg):
    bat = MicroBatcher(engine, serve_cfg)
    reqs = [bat.submit(_img(s, 100, 80)) for s in range(6)]
    bat.close(drain=True)
    for r in reqs:      # every ACCEPTED request completed
        assert isinstance(r.wait_result(timeout=60), list)
        assert 1 <= r.batch_fill <= r.batch_rung <= 4
        assert set(r.timings_ms) >= {"pad", "queue_wait", "device_infer",
                                     "postprocess", "total"}
    with pytest.raises(DrainingError):
        bat.submit(_img(9, 100, 80))
    assert engine.request_path_compiles == 0


def test_request_spans_reach_the_trace_file(engine, serve_cfg, tmp_path):
    from eksml_tpu_torch.telemetry.tracing import Tracer, install_tracer

    tracer = Tracer(path=str(tmp_path / "trace.json"))
    prev = install_tracer(tracer)
    try:
        bat = MicroBatcher(engine, serve_cfg)
        bat.submit(_img(5, 100, 80)).wait_result(timeout=60)
        bat.close(drain=True)
    finally:
        install_tracer(prev)
    with open(tracer.flush()) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert names == {"pad", "queue_wait", "device_infer", "postprocess"}


def _post(url, img, **params):
    payload = {"image_b64": base64.b64encode(img.tobytes()).decode(),
               "shape": list(img.shape), "dtype": "uint8", **params}
    req = urllib.request.Request(
        url + "/v1/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return json.load(urllib.request.urlopen(req, timeout=120))


@pytest.fixture()
def server(engine, serve_cfg):
    bat = MicroBatcher(engine, serve_cfg)
    srv = ServingServer(bat, port=0, addr="127.0.0.1")
    srv.start()
    yield srv
    srv.draining.clear()
    srv.stop()
    bat.close(drain=True)


def test_healthz_gates_on_warmup_and_drain(server):
    url = f"http://127.0.0.1:{server.port}"
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url + "/healthz")
    assert ei.value.code == 503
    assert json.load(ei.value)["status"] == "warming"
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, _img(1))
    assert ei.value.code == 503

    server.mark_ready()
    h = json.load(urllib.request.urlopen(url + "/healthz"))
    assert h["status"] == "ok"
    assert h["request_path_compiles"] == 0
    assert h["warm_executables"] == 4
    assert h["devices"] == torch.cuda.device_count()

    server.draining.set()
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url + "/healthz")
    assert ei.value.code == 503
    assert json.load(ei.value)["status"] == "draining"


def test_predict_endpoint_matches_offline_predictor(server, engine,
                                                    serve_cfg):
    server.mark_ready()
    url = f"http://127.0.0.1:{server.port}"
    img = _img(3, 100, 80)
    resp = _post(url, img, score_thresh=-1.0, masks=True)
    assert resp["bucket"] == [128, 128]
    assert resp["detections"]
    pred = OfflinePredictor(serve_cfg, params=engine.model.state_dict(),
                            model=engine.model, device="cpu")
    dets = pred(img, score_thresh=-1.0)
    assert len(resp["detections"]) == len(dets)
    for got, want in zip(
            sorted(resp["detections"], key=lambda d: -d["score"]), dets):
        np.testing.assert_allclose(got["box"], want.box, atol=1e-4)
        assert got["class_id"] == want.class_id
        np.testing.assert_allclose(got["score"], want.score, atol=1e-6)
        assert got["mask_rle"]["size"] == [100, 80]
        assert sum(got["mask_rle"]["counts"]) == 100 * 80
    assert engine.request_path_compiles == 0


def test_metrics_expose_serve_families(server):
    server.mark_ready()
    url = f"http://127.0.0.1:{server.port}"
    _post(url, _img(4))
    body = urllib.request.urlopen(url + "/metrics").read().decode()
    assert body.rstrip().endswith("# EOF")
    for name in ("eksml_serve_requests", "eksml_serve_batches",
                 "eksml_serve_request_latency_ms",
                 "eksml_serve_queue_depth", "eksml_serve_aot_compiles",
                 "eksml_serve_request_path_compiles",
                 "eksml_serve_warm_executables"):
        assert f"# TYPE {name} " in body, f"missing metric family {name}"


def test_main_serves_and_drains_on_sigterm(tmp_path):
    """``python -m eksml_tpu_torch.serve --random-params --device cpu``:
    /healthz turns 200 after warmup, /v1/predict answers, SIGTERM drains
    and exits 0."""
    port_file = str(tmp_path / "serve.port")
    overrides = list(SMOKE_OVERRIDES) + [
        "PREPROC.TEST_SHORT_EDGE_SIZE=128", "RPN.TEST_PRE_NMS_TOPK=64",
        "RPN.TEST_POST_NMS_TOPK=32"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "eksml_tpu_torch.serve", "--random-params",
         "--device", "cpu", "--port", "0", "--addr", "127.0.0.1",
         "--port-file", port_file, "--config", *overrides],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
        assert health["warm_executables"] == 2
        assert "detections" in _post(url, _img(6))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "drain complete" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
