"""Cascade R-CNN in the port (``eksml_tpu_torch/models/cascade.py`` and the
cascade branches of ``models/mask_rcnn.py``) against ``eksml_tpu`` on
the CPU, in float32, at ``SMOKE_OVERRIDES`` widths with
``MODE_CASCADE=True``, from one seeded Flax init converted with
``convert.from_flax``.

Tolerances as ``tests/test_torch_train.py`` and
``tests/test_torch_model.py`` (both sides float32, sums in other
orders): the stage functions to 1e-6 (labels and matches exactly); the
training losses to 1e-4 relative, every gradient tensor to 1e-4 of its
largest magnitude; ``predict`` with equal classes and validity, boxes to
1e-3 px, scores to 1e-5, masks to 1e-4; ``run_evaluation`` AP to 1e-6.
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
sys.path.insert(0, os.path.join(REPO, "tests"))

jax.config.update("jax_platforms", "cpu")

import conftest  # noqa: E402
from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.data import loader as j_loader  # noqa: E402
from eksml_tpu.data.coco import CocoDataset as JCocoDataset  # noqa: E402
from eksml_tpu.evalcoco import runner as j_runner  # noqa: E402
from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN  # noqa: E402
from eksml_tpu.models import cascade as j_cascade  # noqa: E402
from eksml_tpu.ops import anchors as j_anchors  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch.convert import (flax_leaves, from_flax,  # noqa: E402
                                     init_params)
from eksml_tpu_torch.data.coco import CocoDataset  # noqa: E402
from eksml_tpu_torch.evalcoco import runner as t_runner  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from eksml_tpu_torch.models import cascade as t_cascade  # noqa: E402
from test_torch_train import jax_priorities  # noqa: E402
from torch_dist_ranks import EVAL_OVERRIDES  # noqa: E402

IMG = 128
BATCH = 2
CASCADE_LOSSES = tuple(f"cascade{i}_{k}_loss" for i in range(3)
                       for k in ("cls", "box"))
LOSS_KEYS = ("rpn_cls_loss", "rpn_box_loss") + CASCADE_LOSSES + (
    "mrcnn_loss", "total_loss")


def tiny_cfg(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        "MODE_CASCADE=True", "PREPROC.DEVICE_NORMALIZE=False",
        f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}", "TELEMETRY.PORT=0", *extra])
    cfg.PREPROC.TEST_SHORT_EDGE_SIZE = IMG
    cfg.RPN.TEST_PRE_NMS_TOPK = 64
    cfg.RPN.TEST_POST_NMS_TOPK = 32
    cfg.freeze()
    return cfg


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12))


# ---------------------------------------------------------------------
# the stage functions
# ---------------------------------------------------------------------


def _stage_inputs(seed=0, b=2, s=24, g=5):
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, g, 4), np.float32)
    xy = rng.uniform(0, 80, (b, g, 2))
    wh = rng.uniform(10, 40, (b, g, 2))
    gt[..., :2], gt[..., 2:] = xy, xy + wh
    # ROIs jittered around the GT so every IoU band is populated
    pick = rng.randint(0, g, (b, s))
    rois = np.take_along_axis(gt, pick[..., None], 1)
    rois = (rois + rng.normal(0, 6, rois.shape)).astype(np.float32)
    rois[..., 2:] = np.maximum(rois[..., 2:], rois[..., :2] + 1)
    classes = rng.randint(1, 5, (b, g)).astype(np.int32)
    valid = np.ones((b, g), np.int32)
    valid[0, -1] = 0
    crowd = np.zeros((b, g), np.int32)
    crowd[1, 0] = 1
    deltas = rng.normal(0, 0.5, (b, s, 4)).astype(np.float32)
    hw = np.asarray([[100, 120], [128, 90]], np.float32)
    return rois, gt, classes, valid, crowd, deltas, hw


@pytest.mark.parametrize("thresh", [0.5, 0.6, 0.7])
def test_relabel_rois_matches_jax(thresh):
    rois, gt, classes, valid, crowd, _, _ = _stage_inputs()
    want = jax.vmap(lambda r, gb, gc, gv, cr: j_cascade.relabel_rois(
        r, gb, gc, gv, cr, thresh))(rois, gt, classes, valid, crowd)
    got = t_cascade.relabel_rois(_t(rois), _t(gt), _t(classes), _t(valid),
                                 _t(crowd), thresh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any() and not got[2].all()


def test_refine_boxes_matches_jax_and_stops_the_gradient():
    rois, _, _, _, _, deltas, hw = _stage_inputs(1)
    weights = (20., 20., 10., 10.)
    want = jax.vmap(lambda r, d, h: j_cascade.refine_boxes(
        r, d, weights, h))(rois, deltas, hw)
    d = _t(deltas).requires_grad_(True)
    r = _t(rois).requires_grad_(True)
    got = t_cascade.refine_boxes(r, d, weights, _t(hw))
    _close(got.numpy(), want, 1e-6)
    # the reference's stop_gradient: no path back to the ROIs or deltas
    assert not got.requires_grad and got.grad_fn is None
    jgrad = jax.grad(lambda d: jax.vmap(lambda r, d, h: j_cascade.refine_boxes(
        r, d, weights, h))(rois, d, hw).sum())(deltas)
    assert not np.asarray(jgrad).any()


def test_cascade_stage_losses_match_jax():
    rois, gt, classes, valid, crowd, deltas, _ = _stage_inputs(2)
    rng = np.random.RandomState(3)
    logits = rng.normal(0, 1, rois.shape[:2] + (5,)).astype(np.float32)
    labels, matched, fg = jax.vmap(lambda r, gb, gc, gv, cr:
                                   j_cascade.relabel_rois(
                                       r, gb, gc, gv, cr, 0.5))(
        rois, gt, classes, valid, crowd)
    valid_mask = np.ones(rois.shape[:2], bool)
    valid_mask[:, -3:] = False
    weights = (10., 10., 5., 5.)
    want = jax.vmap(lambda *a: j_cascade.cascade_stage_losses(
        *a, weights))(logits, deltas, rois, labels, matched, gt, fg,
                      valid_mask)
    got = t_cascade.cascade_stage_losses(
        _t(logits), _t(deltas), _t(rois), _t(labels), _t(matched).long(),
        _t(gt), _t(fg), _t(valid_mask), weights)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-6)
        assert np.asarray(w).min() > 0


# ---------------------------------------------------------------------
# the cascade model: losses, gradients, predict
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = tiny_cfg(j_config), tiny_cfg(t_config)
    batch = j_loader.make_synthetic_batch(jcfg, batch_size=BATCH,
                                          image_size=IMG, seed=7,
                                          gt_mask_size=28)
    batch = {k: v for k, v in batch.items()
             if k not in ("image_scale", "image_id")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flax_model = FlaxMaskRCNN.from_config(jcfg)
    key = jax.random.PRNGKey(42)
    params = jax.jit(lambda r, b: flax_model.init(r, b, r))(key, jb)["params"]

    def loss_fn(p, b, r):
        losses = flax_model.apply({"params": p}, b, r)
        return losses["total_loss"], losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jb, key)
    a = sum(j_anchors.num_anchors_per_level(
        (IMG, IMG), tuple(jcfg.FPN.ANCHOR_STRIDES), 3))
    n = jcfg.RPN.TRAIN_POST_NMS_TOPK + jcfg.DATA.MAX_GT_BOXES
    pri = {k: _t(v) for k, v in jax_priorities(key, BATCH, a, n).items()}
    model = MaskRCNN.from_config(tcfg)
    model.load_state_dict(from_flax(jax.device_get(params)))
    model.train()
    losses = model({k: _t(v) for k, v in batch.items()}, pri)
    losses["total_loss"].backward()
    images = batch["images"]
    hw = np.asarray([[IMG, IMG], [100, 90]], np.float32)
    jpred = jax.device_get(jax.jit(lambda p, x, h: flax_model.apply(
        {"params": p}, x, h, method=FlaxMaskRCNN.predict))(params, images,
                                                          hw))
    model.eval()
    tpred = {k: v.numpy() for k, v in model.predict(_t(images),
                                                    _t(hw)).items()}
    return {"jax_losses": jax.device_get(jlosses),
            "jax_grads": from_flax(jax.device_get(jgrads)),
            "losses": {k: v.detach() for k, v in losses.items()},
            "model": model, "jax_pred": jpred, "pred": tpred}


def test_cascade_model_has_three_stages_and_no_fastrcnn(run):
    model = run["model"]
    assert not hasattr(model, "fastrcnn")
    for i in range(3):
        head = getattr(model, f"cascade{i}")
        assert head.box.out_features == 4           # class-agnostic
    assert set(run["losses"]) == set(LOSS_KEYS)


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_cascade_losses_match_jax(run, key):
    want = float(run["jax_losses"][key])
    got = float(run["losses"][key])
    assert got == pytest.approx(want, rel=1e-4), (key, got, want)


def test_cascade_gradients_match_jax(run):
    model = run["model"]
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    jg = run["jax_grads"]
    assert set(jg) == set(params) | {k for k in buffers if k in jg}
    moved = 0
    for name, want in jg.items():
        if name in buffers:
            assert not want.numpy().any(), name
            continue
        p = params[name]
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(got.numpy(), want.numpy(), 1e-4)
        moved += bool(want.abs().max() > 0)
    # every stage's head gets a gradient
    for i in range(3):
        assert run["jax_grads"][f"cascade{i}.fc6.weight"].abs().max() > 0
    assert moved > 40


def test_cascade_predict_matches_jax(run):
    got, want = run["pred"], run["jax_pred"]
    assert set(got) == set(want)
    assert got["valid"].any()
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------
# COCO eval of a cascade model
# ---------------------------------------------------------------------


def test_run_evaluation_of_a_cascade_model_matches_jax(tmp_path):
    """Both runners on ``mini_coco``'s val images from the same cascade
    weights (the port's seeded init as a Flax tree): AP dicts to 1e-6."""
    base = conftest.mini_coco.__wrapped__(tmp_path)
    extra = ["MODE_CASCADE=True", *EVAL_OVERRIDES]

    def cfg(config_mod):
        c = config_mod.config.clone()
        c.freeze(False)
        c.update_args(list(SMOKE_OVERRIDES) + ["TELEMETRY.PORT=0"] + extra)
        c.freeze()
        return c

    tcfg, jcfg = cfg(t_config), cfg(j_config)
    tree = {}
    for name, t in flax_leaves(init_params(
            tcfg, torch.Generator().manual_seed(3))):
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(np.ascontiguousarray(t.numpy()))
    assert "cascade2" in tree and "fastrcnn" not in tree
    model = MaskRCNN.from_config(tcfg)
    model.load_state_dict(from_flax(tree))
    flax_model = FlaxMaskRCNN.from_config(jcfg)
    got = t_runner.run_evaluation(
        model, tcfg, CocoDataset(base, "val2017").records(skip_empty=False),
        batch_size=2, device="cpu")
    want = j_runner.run_evaluation(
        flax_model, tree, jcfg,
        JCocoDataset(base, "val2017").records(skip_empty=False),
        batch_size=2)
    assert set(got) == set(want) and {"bbox/AP", "segm/AP"} <= set(got)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
