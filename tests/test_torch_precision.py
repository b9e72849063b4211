"""``TRAIN.PRECISION=bfloat16`` and ``TRAIN.PARAM_DTYPE=bfloat16`` in the
port (``eksml_tpu_torch``) against the JAX package on the CPU, at
``SMOKE_OVERRIDES`` widths on a 128 px canvas, from one seeded Flax init
converted with ``convert.from_flax``.

Tolerances.  bfloat16 keeps 8 significant bits (epsilon 2^-8 relative).
XLA:CPU does not round every bfloat16 op's output
(``xla_allow_excess_precision``) while PyTorch's CPU kernels do, and the
convolutions sum in other orders, so each output is held to a number of
bfloat16 epsilons of its largest magnitude, growing with depth: the
backbone's and the FPN's outputs to 4 (``TRUNK_EPS``; 1.9 seen), the
RPN head's float32 outputs on the same bfloat16 features and the box,
mask and cascade heads' to 2 (``HEAD_EPS``; 0.8 seen).  The port's bfloat16 features must
also lie closer to JAX's bfloat16 ones than to JAX's float32 ones, which
fails if the dtype policy is missing.  Whole-model bfloat16 losses: the
JAX side's ROIAlign runs through the Pallas kernel in interpret mode,
whose coordinates are float32 as the port's (the CPU XLA path casts the
ROIs to bfloat16 first); every loss to 1e-2 relative, 2.56 bfloat16
epsilons (0.2 % seen: the sampled proposals agree on this batch).

``PARAM_DTYPE=bfloat16``: parameters, FrozenBN statistics and momentum
buffers are bfloat16; two SGD steps (clip, decay, momentum) on the same
bfloat16 gradients are held to optax's chain within two bfloat16 ulps
per step (the update's rounding and the parameter's), of the largest of
the reference's parameter before and after that step and its update,
summed over the steps (the two chains round at different points:
torch's SGD adds the decay and the update in one rounding each, optax in
two; the first step alone stays within one such ulp); a checkpoint
round-trips bitwise and a resume continues bitwise; the state bytes
halve.
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

import optax  # noqa: E402

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu import train as j_train  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.data import loader as j_loader  # noqa: E402
from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN  # noqa: E402
from eksml_tpu.models import mask_rcnn as j_mask_rcnn  # noqa: E402
from eksml_tpu.models.cascade import CascadeBoxHead as JCascadeHead  # noqa: E402
from eksml_tpu.ops.pallas import \
    pallas_batched_multilevel_roi_align  # noqa: E402
from eksml_tpu.ops import anchors as j_anchors  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.convert import from_flax  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from eksml_tpu_torch.models.cascade import CascadeBoxHead  # noqa: E402
from test_torch_train import jax_priorities  # noqa: E402

IMG = 128
BATCH = 2
EPS = 2.0 ** -8
TRUNK_EPS = 4
HEAD_EPS = 2
BF16 = torch.bfloat16


def tiny_cfg(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        "PREPROC.DEVICE_NORMALIZE=False",
        f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}", "TRAIN.GRADIENT_CLIP=5.0",
        "TRAIN.BASE_LR=0.1", "TRAIN.WARMUP_STEPS=0", "TELEMETRY.PORT=0",
        *extra])
    cfg.PREPROC.TEST_SHORT_EDGE_SIZE = IMG
    cfg.RPN.TEST_PRE_NMS_TOPK = 64
    cfg.RPN.TEST_POST_NMS_TOPK = 32
    cfg.freeze()
    return cfg


def _t(x):
    x = np.array(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(BF16)
    return torch.from_numpy(x)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x, np.float32).astype(np.float64)


def _within_eps(got, want, n_eps):
    """``|got - want| <= n_eps * 2^-8 * max|want|`` everywhere; returns
    the error in those epsilons."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / (EPS * scale)
    assert err <= n_eps, f"{err:.2f} bf16 epsilons of max|ref|, {n_eps} allowed"
    return err


def _rms(a, b):
    return float(np.sqrt(np.mean((_f64(a) - _f64(b)) ** 2)))


def _normalized(images):
    mean = np.asarray((123.675, 116.28, 103.53), np.float32)
    std = np.asarray((58.395, 57.12, 57.375), np.float32)
    return ((images.astype(np.float32) - mean) / std).astype(np.float32)


def _pallas_dispatch(feats, rois, strides, out_size, sampling_ratio=2,
                     min_level=2):
    """The JAX model's ROIAlign through the TPU kernel in interpret mode
    (float32 coordinates, as on the TPU and in the port)."""
    return pallas_batched_multilevel_roi_align(
        tuple(feats), rois, tuple(strides), out_size, sampling_ratio,
        min_level, True)


@pytest.fixture(scope="module")
def nets():
    """One Flax init; the Flax model and the port's in float32 and in
    bfloat16 compute (float32 parameters on both sides)."""
    images = np.random.RandomState(0).randint(
        0, 255, (BATCH, IMG, IMG, 3)).astype(np.uint8)
    hw = np.asarray([[IMG, IMG], [100, 90]], np.float32)
    jf32 = FlaxMaskRCNN.from_config(tiny_cfg(j_config))
    jbf16 = FlaxMaskRCNN.from_config(
        tiny_cfg(j_config, "TRAIN.PRECISION=bfloat16"))
    params = jax.device_get(jax.jit(lambda r: jf32.init(
        r, jnp.asarray(images), jnp.asarray(hw),
        method=FlaxMaskRCNN.predict))(jax.random.PRNGKey(0))["params"])
    sd = from_flax(params)
    ports = {}
    for name, extra in (("f32", ()), ("bf16", ("TRAIN.PRECISION=bfloat16",))):
        m = MaskRCNN.from_config(tiny_cfg(t_config, *extra))
        m.load_state_dict(sd)
        ports[name] = m.eval()
    return {"jax": {"f32": jf32, "bf16": jbf16}, "port": ports,
            "params": params, "images": images, "hw": hw}


def _flax(model, params, fn, *args):
    return jax.device_get(jax.jit(lambda p, *a: model.apply(
        {"params": p}, *a, method=fn))(params, *args))


@pytest.fixture(scope="module")
def trunk(nets):
    """The trunk's outputs on both sides in both dtypes: C2..C5 and
    P2..P6."""
    x = _normalized(nets["images"])
    out = {}
    for dt in ("f32", "bf16"):
        jm = nets["jax"][dt]
        out[("jax", dt)] = _flax(
            jm, nets["params"],
            lambda m, x: (m.backbone(x.astype(m.compute_dtype)),
                          m._features(x)), x)
        with torch.no_grad():
            pm = nets["port"][dt]
            c = pm.backbone(torch.from_numpy(x))
            out[("port", dt)] = (c, pm._features(torch.from_numpy(x)))
    return out


def test_backbone_and_fpn_bf16_match_jax_bf16(trunk):
    jc, jp = trunk[("jax", "bf16")]
    pc, pp = trunk[("port", "bf16")]
    assert len(pc) == 4 and len(pp) == 5
    for g, w in zip(list(pc) + list(pp), list(jc) + list(jp)):
        # the dtype policy reaches every output (tests/test_models.py)
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        _within_eps(g, w, TRUNK_EPS)


def test_bf16_features_are_closer_to_jax_bf16_than_to_jax_f32(trunk):
    """Fails if the port ignored TRAIN.PRECISION (its features would then
    be JAX's float32 ones) or cast somewhere else than the reference."""
    pp = trunk[("port", "bf16")][1]
    jb = trunk[("jax", "bf16")][1]
    jf = trunk[("jax", "f32")][1]
    for g, wb, wf in zip(pp, jb, jf):
        assert _rms(g, wb) < 0.5 * _rms(g, wf), (_rms(g, wb), _rms(g, wf))
    # and float32 stays float32
    for g in trunk[("port", "f32")][1]:
        assert g.dtype == torch.float32


def test_parameters_stay_float32_under_bf16_compute(nets):
    for name, t in nets["port"]["bf16"].state_dict().items():
        assert t.dtype == torch.float32, name


def test_rpn_head_bf16_matches_jax(nets, trunk):
    jp = trunk[("jax", "bf16")][1]
    want_l, want_d = _flax(nets["jax"]["bf16"], nets["params"],
                           lambda m, f: m.rpn_head(f), jp)
    with torch.no_grad():
        got_l, got_d = nets["port"]["bf16"].rpn([_t(f) for f in jp])
    for g, w in zip(got_l + got_d, list(want_l) + list(want_d)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _within_eps(g, w, HEAD_EPS)


@pytest.mark.parametrize("head", ["box", "mask"])
def test_heads_bf16_match_jax(nets, head):
    rng = np.random.RandomState(3)
    size = 7 if head == "box" else 14
    x = rng.randn(6, size, size, 32).astype(np.float32)
    jfn = (lambda m, x: m.box_head(x)) if head == "box" \
        else (lambda m, x: m.mask_head(x))
    want = _flax(nets["jax"]["bf16"], nets["params"], jfn, x)
    port = nets["port"]["bf16"]
    with torch.no_grad():
        got = (port.fastrcnn if head == "box" else port.maskrcnn)(_t(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _within_eps(g, w, HEAD_EPS)
    # bfloat16 inputs give the same outputs (the head casts once)
    with torch.no_grad():
        again = (port.fastrcnn if head == "box" else port.maskrcnn)(
            _t(x).to(BF16))
    again = again if isinstance(again, tuple) else (again,)
    for a, g in zip(again, got):
        assert torch.equal(a, g)


def test_cascade_head_bf16_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(6, 7, 7, 32).astype(np.float32)
    jhead = JCascadeHead(num_classes=5, fc_dim=64, dtype=jnp.bfloat16)
    params = jax.device_get(jhead.init(jax.random.PRNGKey(1), x)["params"])
    want = jax.device_get(jhead.apply({"params": params}, x))
    head = CascadeBoxHead(7 * 7 * 32, 5, 64, BF16)
    head.load_state_dict(from_flax(params))
    with torch.no_grad():
        got = head(_t(x))
    assert got[0].shape == (6, 5) and got[1].shape == (6, 4)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _within_eps(g, w, HEAD_EPS)


# ---------------------------------------------------------------------
# the whole model's bfloat16 losses
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_losses(nets):
    """Both sides' training losses in bfloat16 compute on one batch,
    one init and the same sampling priorities."""
    jcfg = tiny_cfg(j_config, "TRAIN.PRECISION=bfloat16")
    batch = j_loader.make_synthetic_batch(jcfg, batch_size=BATCH,
                                          image_size=IMG, seed=7,
                                          gt_mask_size=28)
    batch = {k: v for k, v in batch.items()
             if k not in ("image_scale", "image_id")}
    key = jax.random.PRNGKey(42)
    jm = nets["jax"]["bf16"]
    saved = j_mask_rcnn.dispatch_roi_align
    j_mask_rcnn.dispatch_roi_align = _pallas_dispatch
    try:
        want = jax.device_get(jax.jit(lambda p, b, r: jm.apply(
            {"params": p}, b, r))(nets["params"], {
                k: jnp.asarray(v) for k, v in batch.items()}, key))
    finally:
        j_mask_rcnn.dispatch_roi_align = saved
    a = sum(j_anchors.num_anchors_per_level(
        (IMG, IMG), tuple(jcfg.FPN.ANCHOR_STRIDES), 3))
    n = jcfg.RPN.TRAIN_POST_NMS_TOPK + jcfg.DATA.MAX_GT_BOXES
    pri = {k: _t(v) for k, v in jax_priorities(key, BATCH, a, n).items()}
    model = MaskRCNN.from_config(
        tiny_cfg(t_config, "TRAIN.PRECISION=bfloat16"))
    model.load_state_dict(from_flax(nets["params"]))
    model.train()
    got = model({k: _t(v) for k, v in batch.items()}, pri)
    return got, want


@pytest.mark.parametrize("key", ["rpn_cls_loss", "rpn_box_loss",
                                 "frcnn_cls_loss", "frcnn_box_loss",
                                 "mrcnn_loss", "total_loss"])
def test_bf16_losses_match_jax(bf16_losses, key):
    got, want = bf16_losses
    g, w = float(got[key].detach()), float(want[key])
    assert got[key].dtype == torch.float32
    assert np.isfinite(g) and g == pytest.approx(w, rel=1e-2), (key, g, w)


# ---------------------------------------------------------------------
# TRAIN.PARAM_DTYPE=bfloat16: storage, the optimizer, checkpoints
# ---------------------------------------------------------------------


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 spacing at |x| (8 significant bits; subnormals aside)."""
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _tree(pairs):
    tree = {}
    for name, v in pairs:
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def test_bf16_sgd_steps_match_optax_within_bf16_ulps():
    """Two steps of the port's step (global norm, clip, weight decay,
    momentum, learning rate) on bfloat16 storage against the
    reference's optax chain from the same bfloat16 parameters and
    gradients: every parameter within two bfloat16 ulps per step (of the
    step's largest magnitude, see the module docstring), summed over the
    steps."""
    from eksml_tpu_torch.convert import flax_leaves

    tcfg = tiny_cfg(t_config, "TRAIN.PARAM_DTYPE=bfloat16")
    jcfg = tiny_cfg(j_config, "TRAIN.PARAM_DTYPE=bfloat16")
    model = MaskRCNN.from_config(tcfg)
    t_train.cast_for_storage(model, "bfloat16")
    opt, sched = t_train.make_optimizer(model, tcfg)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    gen = torch.Generator().manual_seed(5)
    # gradients of the trainable parameters (the frozen get none)
    grads = [{n: (0.3 * torch.randn(p.shape, generator=gen)).to(BF16)
              for n, p in model.named_parameters() if n in trainable}
             for _ in range(2)]
    current, allowed = {}, {}

    def forward(batch, priorities):
        total = sum((p.float() * current[n].float()).sum()
                    for n, p in model.named_parameters() if n in trainable)
        return {"total_loss": total}

    step = t_train.make_train_step(forward, opt, sched,
                                   tcfg.TRAIN.GRADIENT_CLIP)
    sd = model.state_dict()
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    jparams = _tree((n, to_j(t)) for n, t in flax_leaves(sd))
    tx, _ = j_train.make_optimizer(jcfg)
    jstate = tx.init(jparams)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(jstate)
               if hasattr(x, "dtype") and x.ndim > 0)
    for i, g in enumerate(grads):
        current.clear()
        current.update(g)
        full = {n: g.get(n, torch.zeros_like(t)) for n, t in sd.items()}
        jgrads = _tree((n, to_j(t)) for n, t in flax_leaves(full))
        upd, jstate = update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        jupd = from_flax(jax.device_get(upd))
        metrics = step({}, {}, i)
        assert float(metrics["grad_norm"]) > tcfg.TRAIN.GRADIENT_CLIP
        want = from_flax(jax.device_get(jparams))
        for name, p in model.named_parameters():
            assert p.dtype == BF16, name
            w = want[name]
            # each step adds 2 ulps (the update's rounding and the
            # parameter's) of the largest of the reference's
            # parameter before and after it and its update: where the
            # update cancels the parameter, or a momentum update outgrows
            # it, the result's own ulp is far below either rounding
            ulp = _ulp(torch.maximum(torch.maximum(
                w.abs(), (w - jupd[name]).abs()), jupd[name].abs()))
            allowed[name] = allowed.get(name, 0) + 2 * ulp
            diff = (p.detach().float() - w).abs()
            assert bool((diff <= allowed[name]).all()), (
                i, name, float((diff / allowed[name]).max()))
    # the momentum buffers follow the storage dtype
    bufs = [s["momentum_buffer"] for s in opt.state.values()]
    assert len(bufs) == len(trainable)
    assert all(b.dtype == BF16 for b in bufs)


@pytest.fixture(scope="module")
def storage_runs(tmp_path_factory):
    """A float32-storage and a bfloat16-storage Trainer, two steps each
    on one batch, checkpointing every step."""
    from eksml_tpu_torch.data import loader as t_loader

    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = tiny_cfg(t_config, f"TRAIN.PARAM_DTYPE={dt}",
                       "TRAIN.STEPS_PER_EPOCH=1", "TRAIN.CHECKPOINT_PERIOD=1",
                       "TRAIN.LOG_PERIOD=1")
        batch = t_loader.make_synthetic_batch(cfg, batch_size=BATCH,
                                              image_size=IMG, seed=7,
                                              gt_mask_size=28)
        logdir = str(tmp_path_factory.mktemp(f"storage_{dt}"))
        trainer = t_train.Trainer(cfg, logdir, device="cpu")
        trainer.init_state()
        rows = trainer.fit(iter([batch] * 2), total_steps=2)
        trainer.ckpt.wait()
        out[dt] = {"cfg": cfg, "batch": batch, "logdir": logdir,
                   "trainer": trainer, "rows": rows,
                   "bytes": trainer.state_bytes()}
    return out


def test_bf16_storage_dtypes_and_halved_state_bytes(storage_runs):
    t = storage_runs["bfloat16"]["trainer"]
    for name, v in t.model.state_dict().items():
        assert v.dtype == BF16, name
    assert t.model.pixel_mean.dtype == torch.float32   # not a parameter
    bufs = [s["momentum_buffer"] for s in t.optimizer.state.values()]
    assert bufs and all(b.dtype == BF16 for b in bufs)
    for r in storage_runs["bfloat16"]["rows"]:
        assert all(np.isfinite(v) for v in r.values())
    (pb32, ob32) = storage_runs["float32"]["bytes"]
    (pb16, ob16) = storage_runs["bfloat16"]["bytes"]
    assert pb16 * 2 == pb32 and ob16 * 2 == ob32 and ob16 > 0


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == BF16 else a,
        b.view(torch.int16) if b.dtype == BF16 else b)


def test_bf16_checkpoint_round_trip_and_resume_are_bitwise(storage_runs):
    run = storage_runs["bfloat16"]
    live = run["trainer"]
    again = t_train.Trainer(run["cfg"], run["logdir"], device="cpu")
    assert again.restore_or_init() == 2
    for k, v in live.model.state_dict().items():
        assert _bitwise(again.model.state_dict()[k], v), k
    for a, b in zip(live.optimizer.state.values(),
                    again.optimizer.state.values()):
        assert _bitwise(a["momentum_buffer"], b["momentum_buffer"])
    # one more step from the restored state equals the live run's
    rows = [t.fit(iter([run["batch"]]), total_steps=3, start_step=2)
            for t in (live, again)]
    assert rows[0][-1]["total_loss"] == rows[1][-1]["total_loss"]
    for k, v in live.model.state_dict().items():
        assert _bitwise(again.model.state_dict()[k], v), k
    again.close()


@pytest.mark.parametrize("saved,live", [("float32", "bfloat16"),
                                        ("bfloat16", "float32")])
def test_checkpoint_of_another_param_dtype_restores_cast(storage_runs,
                                                         saved, live):
    """As the reference (its restore casts to the state's dtypes): a
    checkpoint written under one ``TRAIN.PARAM_DTYPE`` resumes under the
    other, every tensor cast to the live dtype."""
    src = storage_runs[saved]
    ckpt = src["trainer"].ckpt.restore(1)
    trainer = t_train.Trainer(storage_runs[live]["cfg"], str(
        os.path.join(src["logdir"], "..", f"cast_{saved}")), device="cpu")
    trainer.init_state()
    trainer.load_checkpoint_state(ckpt)
    dtype = BF16 if live == "bfloat16" else torch.float32
    for k, v in trainer.model.state_dict().items():
        assert v.dtype == dtype
        assert torch.equal(v, ckpt["model"][k].to(dtype)), k
    bufs = [s["momentum_buffer"] for s in trainer.optimizer.state.values()]
    saved = [s["momentum_buffer"] for s in
             ckpt["optimizer"]["state"].values()]
    assert bufs and len(bufs) == len(saved)
    for b, w in zip(bufs, saved):
        assert b.dtype == dtype and torch.equal(b, w.to(dtype))
    trainer.close()


def test_bf16_storage_checkpoint_serves_and_hot_reloads_widened(
        storage_runs):
    """As the reference (its serving restore casts into a skeleton of
    float32 params, ``eksml_tpu/predict/predictor.py``, and its swap
    rejects any dtype change, ``eksml_tpu/serve/engine.py:163-190``):
    ``restore_predict_params`` gives a bfloat16-storage checkpoint's
    tensors widened to float32, exactly; the engine swaps them in; a
    bfloat16 tree handed to the swap as it is is rejected."""
    from eksml_tpu_torch.predict.predictor import restore_predict_params
    from eksml_tpu_torch.serve import InferenceEngine

    run = storage_runs["bfloat16"]
    cfg = tiny_cfg(t_config, "TRAIN.PARAM_DTYPE=bfloat16",
                   "TRAIN.PRECISION=bfloat16")
    restored = restore_predict_params(cfg, run["logdir"], 2)
    live = run["trainer"].ckpt.restore(2)["model"]
    for k, v in restored.items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, live[k].float()), k
    engine = InferenceEngine(cfg, params=restored, device="cpu")
    engine.swap_params(restore_predict_params(cfg, run["logdir"], 1),
                       step=1)
    assert engine.params_step == 1
    with pytest.raises(ValueError, match="changed"):
        engine.swap_params(live, step=2)
    assert engine.params_step == 1
    engine.close()
