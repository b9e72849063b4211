"""The model variants of the port's config against ``eksml_tpu`` on the
CPU: ``BACKBONE.NORM=GN``, R101 (``BACKBONE.RESNET_NUM_BLOCKS=
(3,4,23,3)``), ``TRAIN.REMAT``, ``MaskRCNN.from_config`` over every
value the reference's config accepts, the serve engine and the eval in
bfloat16.

Tolerances: float32 backbones (GN, R101) to 1e-4 of each output's
largest magnitude (sums in other orders; Flax's GroupNorm takes its
variance as E[x²] - E[x]², PyTorch's as E[(x - E[x])²]); the GN backbone
in bfloat16 to 8 bfloat16 epsilons of each output's largest magnitude
(twice FreezeBN's 4 in ``tests/test_torch_precision.py``: each group's
1/std rescales the convolutions' rounding; 4.0 seen); REMAT's losses
and gradients equal to the non-REMAT model's bit for bit (the recomputed forward runs the
same kernels on the same inputs).  bfloat16 serving: the detections are
compared as sets matched by class and IoU >= 0.9 (near-ties in bfloat16
scores reorder top-k and NMS), scores of matched rows to 0.02.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

jax.config.update("jax_platforms", "cpu")

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.models import mask_rcnn as j_mask_rcnn  # noqa: E402
from eksml_tpu.models.resnet import ResNetBackbone as JBackbone  # noqa: E402
from eksml_tpu.serve.engine import InferenceEngine as JaxEngine  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.convert import from_flax, init_params  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from eksml_tpu_torch.models.resnet import (GroupNorm,  # noqa: E402
                                           ResNetBackbone)
from eksml_tpu_torch.ops.boxes import pairwise_iou  # noqa: E402
from eksml_tpu_torch.serve import InferenceEngine  # noqa: E402
from test_torch_precision import (_pallas_dispatch,  # noqa: E402
                                  _within_eps)

IMG = 64


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12))


def cfg_of(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + ["TELEMETRY.PORT=0"]
                    + list(extra))
    cfg.freeze()
    return cfg


# ---------------------------------------------------------------------
# the backbones: GroupNorm and R101
# ---------------------------------------------------------------------


def _backbones(blocks, norm, dtype):
    x = np.random.RandomState(1).randn(2, IMG, IMG, 3).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jb = JBackbone(num_blocks=blocks, norm=norm, freeze_at=2, dtype=jdt)
    params = jax.device_get(jb.init(jax.random.PRNGKey(2), x)["params"])
    if norm == "GN":
        # non-trivial affine parameters, so scale and bias are exercised
        rng = np.random.RandomState(3)

        def perturb(tree):
            return {k: (perturb(v) if isinstance(v, dict) else
                        v + 0.1 * rng.randn(*v.shape).astype(v.dtype)
                        if k in ("scale", "bias") else v)
                    for k, v in tree.items()}
        params = perturb(params)
    want = jax.device_get(jax.jit(lambda p, x: jb.apply(
        {"params": p}, x))(params, x))
    tb = ResNetBackbone(blocks, 2, norm, dtype)
    tb.load_state_dict(from_flax(params))
    with torch.no_grad():
        got = tb(_t(x))
    return tb, got, want


@pytest.mark.parametrize("blocks,norm", [((1, 1, 1, 1), "GN"),
                                         ((3, 4, 23, 3), "FreezeBN")])
def test_backbone_variants_match_flax_in_float32(blocks, norm):
    tb, got, want = _backbones(blocks, norm, torch.float32)
    if norm == "GN":
        norms = [m for m in tb.modules() if isinstance(m, GroupNorm)]
        assert len(norms) == 1 + 4 * 4 and norms[0].eps == 1e-6
        assert "FrozenBN_0" not in dict(tb.named_children())
    else:
        assert len(tb.stage_names[2]) == 23
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)


def test_gn_backbone_matches_flax_in_bfloat16():
    _, got, want = _backbones((1, 1, 1, 1), "GN", torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _within_eps(g, w, 8)


def test_gn_parameters_train_and_take_no_decay():
    cfg = cfg_of(t_config, "BACKBONE.NORM=GN")
    model = MaskRCNN.from_config(cfg)
    mask = t_train.decay_mask(model, cfg.BACKBONE.FREEZE_AT)
    gn = [n for n, p in model.named_parameters()
          if ".GroupNorm_" in n or n.startswith("backbone.GroupNorm_")]
    assert gn and not any(mask[n] for n in gn)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    # the stem's and stage 0's norms are frozen with their stage
    assert "backbone.GroupNorm_0.scale" not in trainable
    assert "backbone.group1_block0.GroupNorm_0.scale" in trainable


# ---------------------------------------------------------------------
# from_config: every value the reference's config accepts
# ---------------------------------------------------------------------


VARIANTS = {
    "bfloat16": ("TRAIN.PRECISION=bfloat16",),
    "param_dtype": ("TRAIN.PARAM_DTYPE=bfloat16",),
    "remat": ("TRAIN.REMAT=True",),
    "cascade": ("MODE_CASCADE=True",),
    "gn": ("BACKBONE.NORM=GN",),
    "r101": ("BACKBONE.RESNET_NUM_BLOCKS=(3,4,23,3)",),
    "all": ("TRAIN.PRECISION=bfloat16", "TRAIN.PARAM_DTYPE=bfloat16",
            "TRAIN.REMAT=True", "MODE_CASCADE=True", "BACKBONE.NORM=GN"),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_from_config_accepts_every_variant_and_each_changes_the_model(
        name):
    extra = VARIANTS[name]
    cfg = cfg_of(t_config, *extra)
    model = MaskRCNN.from_config(cfg)
    base = MaskRCNN.from_config(cfg_of(t_config))
    assert model.compute_dtype == (torch.bfloat16 if any(
        "PRECISION=bfloat16" in e for e in extra) else torch.float32)
    assert model.remat == any("REMAT" in e for e in extra)
    assert model.cascade == any("CASCADE" in e for e in extra)
    names = set(model.state_dict())
    if name == "param_dtype":
        # the model is unchanged; the trainer casts its storage
        assert names == set(base.state_dict())
        t_train.cast_for_storage(model, cfg.TRAIN.PARAM_DTYPE)
        assert all(v.dtype == torch.bfloat16
                   for v in model.state_dict().values())
    if model.cascade:
        assert {"cascade0.box.weight", "cascade2.fc7.weight"} <= names
        assert not any(n.startswith("fastrcnn.") for n in names)
    if "gn" in name or name == "all":
        assert any("GroupNorm_" in n for n in names)
        assert not any("FrozenBN_" in n for n in names)
    if name == "r101":
        assert len(model.backbone.stage_names[2]) == 23
    else:
        # the whole model's tensors are the ones init_params makes (R101's
        # 40M-element init is left to the backbone parity test)
        seeded = init_params(cfg, torch.Generator().manual_seed(0))
        assert set(seeded) == names


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="NORM"):
        ResNetBackbone((1, 1, 1, 1), 2, "BN")


# ---------------------------------------------------------------------
# REMAT
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def remat_runs():
    """The same step's losses and gradients with and without REMAT, and
    the shapes of the tensors autograd saved in the forward."""
    from eksml_tpu_torch.data import loader as t_loader

    out = {}
    sd = None
    for remat in (False, True):
        cfg = cfg_of(t_config, f"TRAIN.REMAT={remat}",
                     "PREPROC.DEVICE_NORMALIZE=False")
        model = MaskRCNN.from_config(cfg)
        if sd is None:
            sd = init_params(cfg, torch.Generator().manual_seed(4))
        model.load_state_dict(sd)
        model.train()
        batch = {k: torch.from_numpy(v) for k, v in
                 t_loader.make_synthetic_batch(
                     cfg, batch_size=2, image_size=128, seed=7,
                     gt_mask_size=28).items()
                 if k not in ("image_scale", "image_id")}
        pri = model.make_priorities(
            (2, 128, 128, batch["gt_boxes"].shape[1]),
            torch.Generator().manual_seed(9))
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            losses = model(batch, pri)
        losses["total_loss"].backward()
        out[remat] = {"losses": {k: v.detach() for k, v in losses.items()},
                      "grads": {n: p.grad.clone() for n, p in
                                model.named_parameters()
                                if p.grad is not None},
                      "saved": saved}
    return out


def test_remat_losses_and_gradients_equal_no_remat(remat_runs):
    a, b = remat_runs[False], remat_runs[True]
    assert set(a["losses"]) == set(b["losses"])
    for k in a["losses"]:
        assert torch.equal(a["losses"][k], b["losses"][k]), k
    assert set(a["grads"]) == set(b["grads"]) and len(a["grads"]) > 40
    for n in a["grads"]:
        assert torch.equal(a["grads"][n], b["grads"][n]), n


def test_remat_keeps_no_backbone_activation(remat_runs):
    """Without REMAT autograd keeps the trainable stages' activations
    (batch 2, the backbone's 128..2048 channels; the FPN's are 32); with
    it the backbone and the FPN keep none (checkpoint's own hooks take
    their saves and drop them), so far fewer tensors are saved."""
    def backbone(saved):
        # NCHW activations; checkpoint keeps its input, the NHWC images
        return {s for s in saved if len(s) == 4 and s[0] == 2
                and s[1] in (128, 256, 512, 1024, 2048) and s[3] != 3}

    plain, remat = remat_runs[False]["saved"], remat_runs[True]["saved"]
    assert backbone(plain) and not backbone(remat)
    assert len(remat) < len(plain) - 20


# ---------------------------------------------------------------------
# bfloat16 serving and eval
# ---------------------------------------------------------------------


SERVE = ("PREPROC.TEST_SHORT_EDGE_SIZE=128", "RPN.TEST_PRE_NMS_TOPK=64",
         "RPN.TEST_POST_NMS_TOPK=32", "SERVE.BUCKETS=((128,128),)",
         "SERVE.MAX_BATCH_SIZE=4", "SERVE.BATCH_SIZES=(1,4)",
         "TRAIN.PRECISION=bfloat16")


def _matched(got, want, score_thresh=0.1):
    """Each of JAX's valid detections above ``score_thresh`` against the
    port's of the same class with the best IoU: (IoU, |score diff|)."""
    out = []
    for i in range(want["boxes"].shape[0]):
        w = want["valid"][i] & (want["scores"][i] >= score_thresh)
        g = got["valid"][i]
        if not w.any():
            continue
        iou = pairwise_iou(_t(want["boxes"][i][w]),
                           _t(got["boxes"][i][g])).numpy()
        same = want["classes"][i][w][:, None] == got["classes"][i][g][None]
        iou = np.where(same, iou, 0.0)
        best = iou.argmax(1)
        out += [(iou[r, c], abs(want["scores"][i][w][r]
                                - got["scores"][i][g][c]))
                for r, c in enumerate(best)]
    return out


def test_serve_engine_in_bfloat16_matches_jax(monkeypatch):
    """The port's engine under ``TRAIN.PRECISION=bfloat16`` (the serve
    chart's default): warmup covers every shape (no request-path first
    run), outputs are float32 and finite, and the detections match JAX's
    bfloat16 engine (its ROIAlign through the Pallas kernel in interpret
    mode) as sets."""
    tcfg, jcfg = cfg_of(t_config, *SERVE), cfg_of(j_config, *SERVE)
    tree = jax.device_get(jax.jit(lambda r: j_mask_rcnn.MaskRCNN
                                  .from_config(jcfg).init(
        r, jnp.zeros((1, 128, 128, 3), jnp.uint8),
        jnp.asarray([[128, 128]], jnp.float32),
        method=j_mask_rcnn.MaskRCNN.predict))(
        jax.random.PRNGKey(0))["params"])
    engine = InferenceEngine(tcfg, params=from_flax(tree), device="cpu")
    assert engine.model.compute_dtype == torch.bfloat16
    assert engine.warmup() == 2
    rng = np.random.RandomState(5)
    pre = [engine.preprocess(rng.randint(0, 255, (110, 90, 3))
                             .astype(np.uint8)) for _ in range(3)]
    canvases = np.stack([p[0] for p in pre])
    hw = np.asarray([list(p[2]) for p in pre], np.float32)
    got = engine.infer(canvases, hw, 0)
    engine.close()
    assert engine.request_path_compiles == 0
    for k in ("boxes", "scores", "masks"):
        assert got[k].dtype == np.float32 and np.isfinite(got[k]).all(), k
    monkeypatch.setattr(j_mask_rcnn, "dispatch_roi_align", _pallas_dispatch)
    want = JaxEngine(jcfg, params=tree).infer(canvases, hw, 0, rung=4)
    pairs = _matched(got, want)
    assert len(pairs) >= 3
    ious = np.asarray([p[0] for p in pairs])
    dscore = np.asarray([p[1] for p in pairs])
    assert (ious >= 0.9).mean() >= 0.9, ious
    assert dscore[ious >= 0.9].max() <= 0.02


def test_eval_of_a_bf16_model_through_the_trainer(tmp_path):
    """``Trainer.eval_model`` and ``run_evaluation`` under
    ``TRAIN.PRECISION=bfloat16`` with bfloat16 storage: the eval predicts
    with the trainer's bfloat16 parameters and returns finite AP."""
    import conftest
    from eksml_tpu_torch.data.coco import CocoDataset
    from eksml_tpu_torch.evalcoco import runner as t_runner
    from torch_dist_ranks import EVAL_OVERRIDES

    base = conftest.mini_coco.__wrapped__(tmp_path / "coco")
    cfg = cfg_of(t_config, *EVAL_OVERRIDES, "TRAIN.PRECISION=bfloat16",
                 "TRAIN.PARAM_DTYPE=bfloat16")
    trainer = t_train.Trainer(cfg, str(tmp_path / "run"), device="cpu")
    trainer.init_state()
    model = trainer.eval_model()
    assert model.compute_dtype == torch.bfloat16
    assert all(v.dtype == torch.bfloat16 for v in model.state_dict().values())
    res = t_runner.run_evaluation(
        model, cfg, CocoDataset(base, "val2017").records(skip_empty=False),
        batch_size=2, device="cpu")
    trainer.close()
    assert {"bbox/AP", "segm/AP"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())


def test_remat_under_ddp_and_fsdp2_keeps_launches_and_losses(tmp_path,
                                                             monkeypatch):
    """REMAT under the plan's wrappers (a gloo group of one rank): one
    step of ``Trainer.fit`` under DDP and under FSDP2 gives the plain
    REMAT step's losses (to 1e-6), the same kernel launches (3 / 2 / 8,
    the plain versions counted as the kernels would be) and the backbone
    and FPN forwards twice (the recompute)."""
    import chip_smoke
    import torch.distributed as dist

    from eksml_tpu_torch.data import loader as t_loader
    from eksml_tpu_torch.ops.cuda import roi_align_kernel
    from eksml_tpu_torch.ops.roi_align import KERNELS

    def counted(kernel, fn):
        def call(*a, **k):
            kernel.launches += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(KERNELS.fwd, "_plain",
                        counted(KERNELS.fwd, KERNELS.fwd._plain))
    monkeypatch.setattr(KERNELS.bwd, "_plain",
                        counted(KERNELS.bwd, KERNELS.bwd._plain))
    copy = roi_align_kernel.CopyToGlobal.__call__
    monkeypatch.setattr(roi_align_kernel.CopyToGlobal, "__call__",
                        lambda self, src: counted(self, copy)(self, src))
    base = ("TRAIN.BATCH_SIZE_PER_CHIP=2", "TRAIN.NUM_CHIPS=1",
            "PREPROC.DEVICE_NORMALIZE=False")
    params = init_params(cfg_of(t_config, *base),
                         torch.Generator().manual_seed(6))
    batch = t_loader.make_synthetic_batch(cfg_of(t_config, *base),
                                          batch_size=2, image_size=128,
                                          seed=6, gt_mask_size=28)

    def one_step(name, *extra):
        cfg = cfg_of(t_config, *base, *extra)
        trainer = t_train.Trainer(cfg, str(tmp_path / name), device="cpu")
        model = trainer.init_state(params)
        forwards = []
        for part in (model.backbone, model.fpn):
            part.register_forward_pre_hook(
                lambda m, a: forwards.append(type(m).__name__))
        for k in KERNELS:
            k.launches = 0
        row = trainer.fit(iter([batch]), total_steps=1)[-1]
        trainer.close()
        return row, {k.name: k.launches for k in KERNELS}, len(forwards)

    # (REMAT's losses equal the plain model's:
    # test_remat_losses_and_gradients_equal_no_remat)
    remat, remat_launches, remat_fwd = one_step("remat", "TRAIN.REMAT=True")
    assert remat_fwd == 4     # backbone + FPN, and their recompute
    assert remat_launches == dict(zip([k.name for k in KERNELS], (3, 2, 8)))
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{chip_smoke._free_port()}",
        world_size=1, rank=0)
    try:
        for strategy in ("replicated", "fsdp"):
            row, launches, fwd = one_step(
                strategy, "TRAIN.REMAT=True",
                f"TRAIN.SHARDING.STRATEGY={strategy}")
            assert launches == remat_launches, (strategy, launches)
            assert fwd == 4, (strategy, fwd)
            for k in ("rpn_cls_loss", "frcnn_cls_loss", "mrcnn_loss",
                      "total_loss"):
                assert row[k] == pytest.approx(remat[k], rel=1e-6), (
                    strategy, k)
    finally:
        dist.destroy_process_group()
