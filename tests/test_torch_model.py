"""The PyTorch port's Mask-RCNN (``eksml_tpu_torch/models``) against the
Flax model on the CPU, at ``SMOKE_OVERRIDES`` widths, on one seeded Flax
init converted with ``convert.from_flax``.

Tolerances: both sides compute in float32; the convolutions and matrix
products sum in different orders, so each block is held to 1e-4 of its
output's largest magnitude.  The whole ``predict`` must give the same
``classes`` and ``valid``; boxes to 1e-3 px (decoded coordinates up to
128 px inherit the relative error of the head outputs), scores to 1e-5
and masks to 1e-4.
"""

import os
import sys

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
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch.convert import from_flax, init_params  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402

IMG = 128


def tiny_cfg(config_mod):
    """The same tiny config in either package (both keep a copy of the
    same config tree)."""
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES))
    cfg.PREPROC.TEST_SHORT_EDGE_SIZE = IMG
    cfg.RPN.TEST_PRE_NMS_TOPK = 64
    cfg.RPN.TEST_POST_NMS_TOPK = 32
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def models():
    flax_model = FlaxMaskRCNN.from_config(tiny_cfg(j_config))
    images = np.random.RandomState(0).randint(
        0, 255, (2, IMG, IMG, 3)).astype(np.uint8)
    hw = np.asarray([[IMG, IMG], [100, 90]], np.float32)
    params = jax.jit(lambda r: flax_model.init(
        r, jnp.asarray(images), jnp.asarray(hw),
        method=FlaxMaskRCNN.predict))(jax.random.PRNGKey(0))["params"]
    params = jax.device_get(params)
    model = MaskRCNN.from_config(tiny_cfg(t_config))
    model.load_state_dict(from_flax(params))
    model.eval()
    return flax_model, params, model, images, hw


def _flax(flax_model, params, fn, *args):
    return jax.device_get(jax.jit(lambda p, *a: flax_model.apply(
        {"params": p}, *a, method=fn))(params, *args))


def _close(got, want, rel=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12))


def _normalized(images):
    mean = np.asarray((123.675, 116.28, 103.53), np.float32)
    std = np.asarray((58.395, 57.12, 57.375), np.float32)
    return ((images.astype(np.float32) - mean) / std).astype(np.float32)


def test_backbone_matches_flax(models):
    flax_model, params, model, images, _ = models
    x = _normalized(images)
    want = _flax(flax_model, params, lambda m, x: m.backbone(x), x)
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_fpn_matches_flax(models):
    flax_model, params, model, images, _ = models
    c_feats = _flax(flax_model, params, lambda m, x: m.backbone(x),
                    _normalized(images))
    want = _flax(flax_model, params, lambda m, c: m.fpn(c), c_feats)
    with torch.no_grad():
        got = model.fpn([torch.from_numpy(np.array(c)) for c in c_feats])
    assert len(got) == 5
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_rpn_head_matches_flax(models):
    flax_model, params, model, images, _ = models
    p_feats = _flax(flax_model, params, lambda m, x: m._features(x), images)
    want_logits, want_deltas = _flax(
        flax_model, params, lambda m, f: m.rpn_head(f), p_feats)
    with torch.no_grad():
        logits, deltas = model.rpn(
            [torch.from_numpy(np.array(f)) for f in p_feats])
    for g, w in zip(logits + deltas, list(want_logits) + list(want_deltas)):
        _close(g.numpy(), w)


def test_box_head_matches_flax(models):
    flax_model, params, model, _, _ = models
    x = np.random.RandomState(1).randn(6, 7, 7, 32).astype(np.float32)
    want_logits, want_deltas = _flax(
        flax_model, params, lambda m, x: m.box_head(x), x)
    with torch.no_grad():
        logits, deltas = model.fastrcnn(torch.from_numpy(x))
    _close(logits.numpy(), want_logits)
    _close(deltas.numpy(), want_deltas)


def test_mask_head_matches_flax(models):
    flax_model, params, model, _, _ = models
    x = np.random.RandomState(2).randn(5, 14, 14, 32).astype(np.float32)
    want = _flax(flax_model, params, lambda m, x: m.mask_head(x), x)
    with torch.no_grad():
        got = model.maskrcnn(torch.from_numpy(x))
    assert got.shape == (5, 28, 28, 5)
    _close(got.numpy(), want)


def test_predict_matches_flax(models):
    flax_model, params, model, images, hw = models
    want = _flax(flax_model, params, FlaxMaskRCNN.predict, images, hw)
    got = {k: v.numpy() for k, v in model.predict(
        torch.from_numpy(images), torch.from_numpy(hw)).items()}
    assert set(got) == set(want)
    assert got["valid"].any()      # scores of 5 random classes clear 0.05
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0,
                               atol=1e-4)


def test_from_flax_and_init_params_cover_every_tensor(models):
    _, params, model, _, _ = models
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    converted = from_flax(params)
    assert {k: tuple(v.shape) for k, v in converted.items()} == want
    seeded = init_params(tiny_cfg(t_config), torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in seeded.items()} == want
    # Flax's defaults: lecun-normal kernels, zero biases, FrozenBN 1/0
    w = seeded["backbone.group0_block0.conv2.weight"]      # fan_in 9*64
    std = (1.0 / (9 * 64)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(seeded["fpn.lateral_2.bias"],
                       torch.zeros_like(seeded["fpn.lateral_2.bias"]))
    assert torch.equal(seeded["backbone.FrozenBN_0.var"], torch.ones(64))
    again = init_params(tiny_cfg(t_config), torch.Generator().manual_seed(0))
    assert all(torch.equal(seeded[k], again[k]) for k in seeded)
