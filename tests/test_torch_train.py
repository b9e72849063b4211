"""The port's training slice (``eksml_tpu_torch``: samplers, anchor
matching, proposal targets, losses, mask targets, the loader, the
optimizer and the step) against the JAX package on the CPU.

The model runs at ``SMOKE_OVERRIDES`` widths on the 128 px canvas of
``test_golden.py`` (float normalized input), batch 2, on one seeded Flax
init converted with ``convert.from_flax``; the batch is JAX's
``make_synthetic_batch`` and the sampling priorities are recomputed in
JAX from the key splits the Flax model makes (``mask_rcnn.py:217``,
``rpn.py:111``, ``heads.py:121``) and passed to the port.  The JAX side
compiles once per module: one ``jax.jit(jax.value_and_grad(...))`` and
one optimizer update.

Tolerances (both sides compute in float32; convolutions and matrix
products sum in different orders): losses to 1e-4 relative, every
gradient tensor to 1e-4 of its largest magnitude (``from_flax`` is
linear, so it maps gradients as it maps weights), parameter updates
after 1 and 3 steps to 1e-3 of each update's largest magnitude (the
differences of the gradients compound through the momentum and the
changed parameters).
"""

import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

jax.config.update("jax_platforms", "cpu")

import optax  # noqa: E402

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu import train as j_train  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.data import loader as j_loader  # noqa: E402
from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN  # noqa: E402
from eksml_tpu.models import heads as j_heads  # noqa: E402
from eksml_tpu.models import rpn as j_rpn  # noqa: E402
from eksml_tpu.ops import anchors as j_anchors  # noqa: E402
from eksml_tpu.ops import sampling as j_sampling  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.convert import _flatten, from_flax  # noqa: E402
from eksml_tpu_torch.data import loader as t_loader  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from eksml_tpu_torch.models import heads as t_heads  # noqa: E402
from eksml_tpu_torch.models import rpn as t_rpn  # noqa: E402
from eksml_tpu_torch.ops import roi_align as t_roi  # noqa: E402
from eksml_tpu_torch.ops import sampling as t_sampling  # noqa: E402

IMG = 128
BATCH = 2
STEPS = 3
LOSS_KEYS = ("rpn_cls_loss", "rpn_box_loss", "frcnn_cls_loss",
             "frcnn_box_loss", "mrcnn_loss", "total_loss")


def tiny_cfg(config_mod, *extra):
    """The same tiny training config in either package."""
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        "PREPROC.DEVICE_NORMALIZE=False", f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}",
        # below the first step's gradient norm: the clip is exercised
        "TRAIN.GRADIENT_CLIP=5.0",
        # updates far above one float32 ulp of the parameters they move
        "TRAIN.BASE_LR=0.1", "TRAIN.WARMUP_STEPS=0",
        # an ephemeral exporter port: the xdist workers never share 9090
        "TELEMETRY.PORT=0", *extra])
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


def jax_priorities(rng, b, a, n):
    """The priorities the Flax model draws inside from ``rng``: two
    uniform vectors per image from each of its two per-image keys."""
    rngs = jax.random.split(rng, (b, 2))

    def pair(r, size):
        f, g = jax.random.split(r)
        return (jax.random.uniform(f, (size,)),
                jax.random.uniform(g, (size,)))

    rpn_fg, rpn_bg = jax.vmap(lambda r: pair(r, a))(rngs[:, 0])
    fr_fg, fr_bg = jax.vmap(lambda r: pair(r, n))(rngs[:, 1])
    return {"rpn_fg": rpn_fg, "rpn_bg": rpn_bg, "frcnn_fg": fr_fg,
            "frcnn_bg": fr_bg}


def _port_grads(model):
    return {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def run():
    """One batch, one init, and both sides' losses, gradients and the
    parameters after each of ``STEPS`` optimizer steps."""
    jcfg = tiny_cfg(j_config)
    tcfg = tiny_cfg(t_config)
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

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx, _ = j_train.make_optimizer(jcfg)

    @jax.jit
    def update(g, s, p):
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    a = sum(j_anchors.num_anchors_per_level(
        (IMG, IMG), tuple(jcfg.FPN.ANCHOR_STRIDES), 3))
    n = jcfg.RPN.TRAIN_POST_NMS_TOPK + jcfg.DATA.MAX_GT_BOXES

    model = MaskRCNN.from_config(tcfg)
    model.load_state_dict(from_flax(jax.device_get(params)))
    model.train()
    opt, sched = t_train.make_optimizer(model, tcfg)
    step = t_train.make_train_step(model, opt, sched,
                                   tcfg.TRAIN.GRADIENT_CLIP)
    tb = {k: _t(v) for k, v in batch.items()}

    out = {"jax_params": [jax.device_get(params)],
           "port_params": [{k: v.clone() for k, v in
                            model.state_dict().items()}],
           "jax_metrics": [], "port_metrics": []}
    opt_state = tx.init(params)
    for i in range(STEPS):
        r = jax.random.fold_in(key, i)
        pri = {k: _t(v) for k, v in jax_priorities(r, BATCH, a, n).items()}
        (_, losses), grads = grad_fn(params, jb, r)
        if i == 0:
            out["jax_losses"] = jax.device_get(losses)
            out["jax_grads"] = from_flax(jax.device_get(grads))
            model.zero_grad(set_to_none=True)
            port_losses = model(tb, pri)
            port_losses["total_loss"].backward()
            out["port_losses"] = {k: v.detach() for k, v in
                                  port_losses.items()}
            out["port_grads"] = _port_grads(model)
        params, opt_state = update(grads, opt_state, params)
        out["jax_params"].append(jax.device_get(params))
        out["jax_metrics"].append(
            {"grad_norm": float(optax.global_norm(grads))})
        out["port_metrics"].append(step(tb, pri, i))
        out["port_params"].append({k: v.clone() for k, v in
                                   model.state_dict().items()})
    out["model"] = model
    return out


# ---------------------------------------------------------------------
# the step as a whole
# ---------------------------------------------------------------------


def test_training_losses_match_jax(run):
    assert set(run["port_losses"]) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        want = float(run["jax_losses"][k])
        got = float(run["port_losses"][k])
        assert got == pytest.approx(want, rel=1e-4), (k, got, want)
        # the step builder's own forward gave the same losses
        assert float(run["port_metrics"][0][k]) == pytest.approx(
            want, rel=1e-4), k


def test_training_gradients_match_jax(run):
    jg, pg = run["jax_grads"], run["port_grads"]
    model = run["model"]
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert set(jg) == set(params) | {k for k in buffers if k in jg}
    for name, want in jg.items():
        if name in buffers:      # FrozenBN statistics: stop-gradiented
            assert not want.numpy().any(), name
            continue
        _close(pg[name].numpy(), want.numpy(), 1e-4)
    # the frozen stem and stage (FREEZE_AT=2) get no gradient at all
    frozen = [n for n, p in params.items() if not p.requires_grad]
    assert frozen and all(n.startswith(("backbone.conv0",
                                        "backbone.group0_")) for n in frozen)
    assert all(not jg[n].numpy().any() for n in frozen)


@pytest.mark.parametrize("steps", [1, STEPS])
def test_parameter_updates_match_jax(run, steps):
    j0, jn = from_flax(run["jax_params"][0]), from_flax(
        run["jax_params"][steps])
    p0, pn = run["port_params"][0], run["port_params"][steps]
    moved = 0
    for name in j0:
        want = (jn[name] - j0[name]).numpy()
        got = (pn[name] - p0[name]).numpy()
        _close(got, want, 1e-3)
        moved += bool(np.abs(want).max() > 0)
    assert moved > 40      # every trainable tensor of the tiny model


def test_step_metrics_match_jax(run):
    """``grad_norm`` is the raw gradients' norm (before the clip); the
    learning rate is the schedule's at each step."""
    jcfg = tiny_cfg(j_config)
    sched = j_train.lr_schedule(jcfg)
    for i, (pm, jm) in enumerate(zip(run["port_metrics"],
                                     run["jax_metrics"])):
        assert float(pm["grad_norm"]) == pytest.approx(jm["grad_norm"],
                                                       rel=1e-4)
        assert float(pm["grad_norm"]) > 5.0       # the clip was active
        assert pm["learning_rate"] == pytest.approx(float(sched(i)),
                                                    rel=1e-6)


# ---------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------


@pytest.mark.parametrize("with_limit", [False, True])
def test_samplers_match_jax(with_limit):
    rng = np.random.RandomState(0)
    cand = rng.rand(300) < 0.05            # fewer candidates than k
    key = jax.random.PRNGKey(3)
    pri = np.asarray(jax.random.uniform(key, (300,)))
    limit = 9 if with_limit else None
    j_idx, j_take = j_sampling.sample_by_priority(
        jnp.asarray(cand), key, 32, None if limit is None else jnp.int32(9))
    idx, take = t_sampling.sample_by_priority(
        _t(cand)[None], _t(pri)[None], 32,
        None if limit is None else torch.tensor([9]))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(take[0].numpy(), np.asarray(j_take))
    j_mask = j_sampling.sample_mask_by_priority(
        jnp.asarray(cand), key, 32, None if limit is None else jnp.int32(9))
    mask = t_sampling.sample_mask_by_priority(
        _t(cand)[None], _t(pri)[None], 32,
        None if limit is None else torch.tensor([9]))
    np.testing.assert_array_equal(mask[0].numpy(), np.asarray(j_mask))


def _anchors_and_gt(rng, shared=False):
    anchors = np.concatenate(j_anchors.generate_fpn_anchors(
        (IMG, IMG), (4, 8, 16, 32, 64), (32, 64, 128, 256, 512),
        (0.5, 1.0, 2.0)))
    g = 8
    xy = rng.rand(g, 2) * 80
    wh = rng.rand(g, 2) * 40 + 8
    gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    valid = np.ones(g, np.float32)
    valid[6:] = 0                        # padding rows
    gt[6:] = 0
    crowd = np.zeros(g, np.float32)
    crowd[5] = 1                         # one crowd region
    if shared:
        gt[1] = gt[0]                    # two GTs share their best anchor
    return anchors, gt, valid, crowd


@pytest.mark.parametrize("shared", [False, True])
def test_match_anchors_matches_jax(shared):
    anchors, gt, valid, crowd = _anchors_and_gt(np.random.RandomState(1),
                                                shared)
    j_labels, j_matched = j_rpn.match_anchors(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid), 0.7, 0.3,
        gt_crowd=jnp.asarray(crowd))
    labels, matched = t_rpn.match_anchors(
        _t(anchors), _t(gt)[None], _t(valid)[None], 0.7, 0.3,
        gt_crowd=_t(crowd)[None])
    np.testing.assert_array_equal(labels[0].numpy(), np.asarray(j_labels))
    np.testing.assert_array_equal(matched[0].numpy(), np.asarray(j_matched))
    assert (labels[0] == 1).any() and (labels[0] == -1).any()


def test_sample_anchors_and_rpn_losses_match_jax():
    rng = np.random.RandomState(2)
    anchors, gt, valid, crowd = _anchors_and_gt(rng)
    labels, matched = j_rpn.match_anchors(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid), 0.7, 0.3,
        gt_crowd=jnp.asarray(crowd))
    key = jax.random.PRNGKey(5)
    j_fg, j_bg = j_rpn.sample_anchors(labels, key, 64, 0.5)
    kf, kb = jax.random.split(key)
    a = anchors.shape[0]
    fg, bg = t_rpn.sample_anchors(
        _t(labels)[None], _t(jax.random.uniform(kf, (a,)))[None],
        _t(jax.random.uniform(kb, (a,)))[None], 64, 0.5)
    np.testing.assert_array_equal(fg[0].numpy(), np.asarray(j_fg))
    np.testing.assert_array_equal(bg[0].numpy(), np.asarray(j_bg))
    logits = rng.randn(a).astype(np.float32) * 3
    deltas = rng.randn(a, 4).astype(np.float32)
    j_cls, j_box = j_rpn.rpn_losses(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors),
        labels, matched, jnp.asarray(gt), j_fg, j_bg)
    cls, box = t_rpn.rpn_losses(
        _t(logits)[None], _t(deltas)[None], _t(anchors), _t(labels)[None],
        _t(matched)[None].long(), _t(gt)[None], fg, bg)
    assert float(cls[0]) == pytest.approx(float(j_cls), rel=1e-5)
    assert float(box[0]) == pytest.approx(float(j_box), rel=1e-5)


def test_sample_proposal_targets_matches_jax():
    """The fg prefix, the bg after it and the padding slots (their
    indices included) are the reference's, and so are the head losses
    on them."""
    rng = np.random.RandomState(3)
    _, gt, valid, crowd = _anchors_and_gt(rng)
    classes = rng.randint(1, 5, 8).astype(np.int32)
    p = 40
    base = gt[rng.randint(0, 6, p)]
    props = (base + rng.randn(p, 4) * 6).astype(np.float32)
    scores = rng.rand(p).astype(np.float32)
    scores[-20:] = -np.inf               # padding proposals
    key = jax.random.PRNGKey(9)
    s, k = 32, 5                         # more slots than candidates
    j_out = j_heads.sample_proposal_targets(
        jnp.asarray(props), jnp.asarray(scores), jnp.asarray(gt),
        jnp.asarray(classes), jnp.asarray(valid), key, s, 0.5, 0.25,
        gt_crowd=jnp.asarray(crowd))
    kf, kb = jax.random.split(key)
    out = t_heads.sample_proposal_targets(
        _t(props)[None], _t(scores)[None], _t(gt)[None], _t(classes)[None],
        _t(valid)[None], _t(jax.random.uniform(kf, (p + 8,)))[None],
        _t(jax.random.uniform(kb, (p + 8,)))[None], s, 0.5, 0.25,
        gt_crowd=_t(crowd)[None])
    for got, want in zip(out, j_out):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    rois, labels, matched, fg, valid_m = (np.asarray(x) for x in j_out)
    assert fg.any() and not fg.all() and not valid_m.all()
    first_bg = int(np.argmin(fg))
    assert fg[:first_bg].all() and not fg[first_bg:].any()   # fg prefix
    logits = rng.randn(s, k).astype(np.float32)
    deltas = rng.randn(s, k, 4).astype(np.float32)
    w = (10.0, 10.0, 5.0, 5.0)
    j_cls, j_box = j_heads.box_head_losses(
        jnp.asarray(logits), jnp.asarray(deltas), *j_out[:3],
        jnp.asarray(gt), j_out[3], j_out[4], w)
    cls, box = t_heads.box_head_losses(
        _t(logits)[None], _t(deltas)[None], out[0], out[1], out[2],
        _t(gt)[None], out[3], out[4], w)
    assert float(cls[0]) == pytest.approx(float(j_cls), rel=1e-5)
    assert float(box[0]) == pytest.approx(float(j_box), rel=1e-5)
    mlog = rng.randn(s, 6, 6, k).astype(np.float32) * 2
    targ = (rng.rand(s, 6, 6) < 0.5).astype(np.float32)
    want = j_heads.mask_head_loss(jnp.asarray(mlog), j_out[1],
                                  jnp.asarray(targ), j_out[3])
    got = t_heads.mask_head_loss(_t(mlog)[None], out[1], _t(targ)[None],
                                 out[3])
    assert float(got[0]) == pytest.approx(float(want), rel=1e-5)
    assert t_heads.max_fg_proposals(16, 0.25) == \
        j_heads.max_fg_proposals(16, 0.25) == 4
    assert t_heads.max_fg_proposals(2, 0.25) == 1
    assert t_heads.max_fg_proposals(8, 0.0) == 0


def test_mask_targets_match_jax(run):
    """Targets equal the reference's, except where the sampled mask
    value lies within 1e-6 of the 0.5 threshold (sums in another
    order)."""
    rng = np.random.RandomState(4)
    k, g, m0 = 12, 8, 28
    gt = _anchors_and_gt(rng)[1][None].repeat(BATCH, 0)
    gt[:, 6:] = gt[:, :2] + 3            # no zero-area boxes in use
    yy, xx = np.mgrid[:m0, :m0]
    masks = np.stack([
        ((yy - rng.rand() * m0) ** 2 + (xx - rng.rand() * m0) ** 2
         < (rng.rand() * m0) ** 2) for _ in range(BATCH * g)]
    ).reshape(BATCH, g, m0, m0).astype(np.float32)
    matched = rng.randint(0, g, (BATCH, k)).astype(np.int32)
    rois = (gt[np.arange(BATCH)[:, None], matched]
            + rng.randn(BATCH, k, 4) * 5).astype(np.float32)
    jcfg = tiny_cfg(j_config)
    flax_model = FlaxMaskRCNN.from_config(jcfg)
    want = np.asarray(flax_model.apply(
        {"params": run["jax_params"][0]}, jnp.asarray(rois),
        jnp.asarray(matched), jnp.asarray(gt), jnp.asarray(masks),
        method=lambda mod, *a: jax.vmap(mod._mask_targets)(*a)))
    got = run["model"]._mask_targets(_t(rois), _t(matched).long(), _t(gt),
                                     _t(masks)).numpy()
    assert got.shape == want.shape == (BATCH, k, 28, 28)
    # the unthresholded values, by the plain version
    g_boxes = gt[np.arange(BATCH)[:, None], matched]
    gw = np.maximum(g_boxes[..., 2] - g_boxes[..., 0], 1e-4)
    gh = np.maximum(g_boxes[..., 3] - g_boxes[..., 1], 1e-4)
    mrois = np.stack([(rois[..., 0] - g_boxes[..., 0]) / gw * m0,
                      (rois[..., 1] - g_boxes[..., 1]) / gh * m0,
                      (rois[..., 2] - g_boxes[..., 0]) / gw * m0,
                      (rois[..., 3] - g_boxes[..., 1]) / gh * m0], -1)
    sampled = t_roi.batched_multilevel_roi_align(
        [_t(masks[np.arange(BATCH)[:, None], matched]
            .reshape(-1, m0, m0, 1))],
        _t(mrois.astype(np.float32)).reshape(-1, 1, 4), (1,),
        28).reshape(BATCH, k, 28, 28).numpy()
    differ = got != want
    assert not (differ & (np.abs(sampled - 0.5) > 1e-6)).any()
    assert 0.1 < want.mean() < 0.9


@pytest.mark.parametrize("extra", [
    (), ("TRAIN.WARMUP_STEPS=500", "TRAIN.BASE_LR=0.01"),
    ("TRAIN.LR_SCHEDULE=(8,16,16)", "TRAIN.WARMUP_STEPS=4",
     "TRAIN.NUM_CHIPS=4")])
def test_lr_schedule_matches_jax(extra):
    jsched = j_train.lr_schedule(tiny_cfg(j_config, *extra))
    tsched = t_train.lr_schedule(tiny_cfg(t_config, *extra))
    for step in (0, 1, 3, 4, 5, 7, 8, 15, 16, 17, 499, 500, 501, 10 ** 6):
        assert tsched(step) == pytest.approx(float(jsched(step)),
                                             rel=1e-6), step


@pytest.mark.parametrize("freeze_at", [0, 1, 2, 3])
def test_decay_mask_matches_jax(run, freeze_at):
    tree = j_train._decay_mask(freeze_at)(run["jax_params"][0])
    flat = {(n[:-len("kernel")] + "weight" if n.endswith(".kernel") else n):
            bool(v) for n, v in _flatten(tree).items()}
    got = t_train.decay_mask(run["model"], freeze_at)
    assert set(got) <= set(flat)
    for name, decay in got.items():
        assert decay == bool(flat[name]), name
    # parameters the port keeps as buffers never decay in JAX either
    assert not any(bool(flat[n]) for n in set(flat) - set(got))


@pytest.mark.parametrize("device_normalize", [False, True])
def test_make_synthetic_batch_is_byte_identical(device_normalize):
    extra = (f"PREPROC.DEVICE_NORMALIZE={device_normalize}",)
    want = j_loader.make_synthetic_batch(tiny_cfg(j_config, *extra),
                                         batch_size=2, image_size=IMG,
                                         seed=7, gt_mask_size=28)
    got = t_loader.make_synthetic_batch(tiny_cfg(t_config, *extra),
                                        batch_size=2, image_size=IMG,
                                        seed=7, gt_mask_size=28)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_loader_batches_with_segmentations_are_byte_identical():
    """Records with polygon, RLE and crowd annotations, flips drawn at
    random, on an unscaled canvas (both resizes are then the
    identity)."""
    rng = np.random.RandomState(6)
    recs = []
    for i in range(5):
        h, w = 96, 128
        recs.append({
            "image_id": i, "path": None, "height": h, "width": w,
            "boxes": np.asarray([[10, 12, 70, 80], [30, 5, 120, 60],
                                 [0, 0, 40, 30]], np.float32),
            "classes": np.asarray([1, 2, 3], np.int32),
            "iscrowd": np.asarray([0, 1, 0], np.int32),
            "segmentation": [
                [[10, 12, 70, 14, 60, 80, 12, 70]],
                {"size": [h, w], "counts": [200, 500, 3000, 400]},
                None],
            "_image": rng.randint(0, 255, (h, w, 3)).astype(np.uint8)})
    extra = ("PREPROC.TRAIN_SHORT_EDGE_SIZE=(96,96)",)
    jl = j_loader.DetectionLoader(recs, tiny_cfg(j_config, *extra), 2,
                                  seed=3, gt_mask_size=28, prefetch=1)
    tl = t_loader.DetectionLoader(recs, tiny_cfg(t_config, *extra), 2,
                                  seed=3, gt_mask_size=28)
    for want, got in zip(jl.batches(4), tl.batches(4)):
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k


def test_trainer_fit_on_the_cpu():
    """Two steps through ``Trainer.fit`` on the port's loader: finite
    losses, every trainable tensor moved, the frozen ones did not."""
    cfg = tiny_cfg(t_config, "TRAIN.LOG_PERIOD=1")
    ds = t_loader.SyntheticDataset(num_images=4, height=IMG, width=IMG,
                                   num_classes=cfg.DATA.NUM_CLASSES)
    loader = t_loader.DetectionLoader(ds.records(), cfg, batch_size=2,
                                      gt_mask_size=28)
    with tempfile.TemporaryDirectory() as logdir:
        trainer = t_train.Trainer(cfg, logdir, device="cpu")
        model = trainer.init_state()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        rows = trainer.fit(loader.batches(), total_steps=2)
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert set(LOSS_KEYS) <= set(r)
        assert all(np.isfinite(v) for v in r.values())
    after = model.state_dict()
    for name, p in model.named_parameters():
        assert torch.equal(before[name], after[name]) != p.requires_grad, name
    for name, _ in model.named_buffers():
        if name in before:
            assert torch.equal(before[name], after[name]), name
