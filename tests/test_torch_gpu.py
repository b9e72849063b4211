"""Tests of the port that need a CUDA card (marker ``gpu``; they skip
without one).  This file imports neither JAX nor the JAX package, so on
the card's machine it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from eksml_tpu_torch.ops.roi_align import (  # noqa: E402
    KERNELS, batched_multilevel_roi_align, dispatch_roi_align,
    roi_align_backward_plain)

STRIDES = (4, 8, 16, 32)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, dtype, b=2, img=256, c=64, n=40, seed=0):
    rng = np.random.RandomState(seed)
    feats = tuple(torch.from_numpy(
        rng.randn(b, img // s, img // s, c).astype(np.float32))
        .to(dev, dtype) for s in STRIDES)
    xy = rng.rand(b, n, 2) * img
    wh = np.exp(rng.uniform(0, np.log(img), (b, n, 2)))
    rois = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    rois[:, 0] = [-30, -30, img + 40, img + 20]      # larger than the map
    rois[:, 1] = [0, 0, 9, 13]                       # on the border
    rois[:, 2] = [50, 50, 50.3, 50.6]                # sub-pixel
    return feats, torch.from_numpy(rois.astype(np.float32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size", [7, 14])
def test_kernel_matches_plain_version(cuda, dtype, out_size):
    """float32: within 1e-5 of the features' largest magnitude (sums in
    another order); bfloat16: within one bfloat16 ulp of the plain
    version, which also accumulates in float32, plus that allowance."""
    feats, rois = _inputs(cuda, dtype)
    before = KERNELS.fwd.launches
    got = dispatch_roi_align(feats, rois, STRIDES, out_size)
    assert KERNELS.fwd.launches == before + 1
    want = batched_multilevel_roi_align(feats, rois, STRIDES, out_size)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    fmax = max(float(f.float().abs().max()) for f in feats)
    _assert_close(got, want, dtype, fmax)


def test_kernel_takes_the_mask_target_call(cuda):
    """Training's mask targets: one level at stride 1, one channel, each
    ROI on its own 56² GT mask, out 28; within 1e-5 of the plain
    version."""
    masks, rois = chip_smoke.mask_target_inputs(np.random.RandomState(4),
                                                48)
    masks = torch.from_numpy(masks).to(cuda)
    rois = torch.from_numpy(rois).to(cuda)
    before = KERNELS.fwd.launches
    got = dispatch_roi_align((masks,), rois, (1,), 28)
    assert KERNELS.fwd.launches == before + 1
    want = batched_multilevel_roi_align((masks,), rois, (1,), 28)
    assert got.shape == (48, 1, 28, 28, 1) and float(want.max()) > 0.5
    _assert_close(got, want, torch.float32, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_takes_the_rowwise_design_where_the_footprint_does_not_fit(
        cuda, dtype):
    """At out 64 a footprint block would need out x ceil(out / 7) = 640
    threads, more than its 224: the wrapper runs the rowwise kernel,
    which matches the plain version."""
    feats, rois = _inputs(cuda, dtype, c=8, n=4)
    got, ran = _kernels_run(lambda: KERNELS.fwd(feats, rois, STRIDES, 64),
                            "roi_align_fwd_")
    assert len(ran) == 1 and "roi_align_fwd_rowwise_kernel" in ran.pop()
    want = batched_multilevel_roi_align(feats, rois, STRIDES, 64)
    _assert_close(got, want, dtype,
                  max(float(f.float().abs().max()) for f in feats))


def _assert_close(got, want, dtype, scale):
    """float32: within 1e-5 of ``scale``; bfloat16: within one bfloat16
    ulp of the plain value plus that allowance."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * scale
    else:
        w = want.float().abs()
        _, e = torch.frexp(w)
        ulp = torch.where(w == 0, torch.zeros_like(w),
                          torch.ldexp(torch.ones_like(w), e - 8))
        assert bool((diff <= ulp + 1e-5 * scale).all())


def _zeros_like_levels(feats):
    return [torch.zeros(f.shape, dtype=torch.float32, device=f.device)
            for f in feats]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size", [7, 14])
def test_backward_kernel_matches_plain_version(cuda, dtype, out_size):
    """Each level's gradient: float32 within 1e-5 of its largest
    magnitude (atomics add in another order); bfloat16 within one ulp of
    the plain value, which also sums in float32, plus that allowance."""
    feats, rois = _inputs(cuda, dtype)
    g = torch.randn((*rois.shape[:2], out_size, out_size, 64),
                    device=cuda).to(dtype)
    before = KERNELS.bwd.launches
    got = KERNELS.bwd(_zeros_like_levels(feats), rois, g, STRIDES, out_size)
    assert KERNELS.bwd.launches == before + 1
    want = roi_align_backward_plain(feats, rois, g, STRIDES, out_size)
    torch.cuda.synchronize()
    assert any(float(w.float().abs().max()) > 0 for w in want)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        _assert_close(a.to(dtype), w, dtype,
                      max(float(w.float().abs().max()), 1e-30))


def test_backward_kernel_deposits_n_times_one_rois_gradient(cuda):
    """N identical ROIs deposit N times one ROI's gradient: the atomics
    lose no update where every block hits the same pixels."""
    feats, _ = _inputs(cuda, torch.float32, b=1, n=3, seed=3)
    rois = torch.tensor([[[20.0, 30.0, 90.0, 120.0]]], device=cuda)
    g = torch.randn((1, 1, 7, 7, 64), device=cuda)
    one = KERNELS.bwd(_zeros_like_levels(feats), rois, g, STRIDES, 7)
    many = KERNELS.bwd(_zeros_like_levels(feats), rois.repeat(1, 64, 1)
                       .contiguous(), g.repeat(1, 64, 1, 1, 1).contiguous(),
                       STRIDES, 7)
    torch.cuda.synchronize()
    for a, b in zip(many, one):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - 64 * b).abs().max()) <= 1e-5 * 64 * scale


def test_copy_kernel_is_bitwise_clone(cuda):
    for shape in [(2, 64, 64, 64), (3, 5, 7), (1,), (4, 33)]:
        src = torch.randn(shape, device=cuda)
        before = KERNELS.copy.launches
        got = KERNELS.copy(src)
        assert KERNELS.copy.launches == before + 1
        assert got.data_ptr() != src.data_ptr()
        assert torch.equal(got.view(torch.int32), src.view(torch.int32))
    # an offset view: 16-byte vectors do not apply, the byte loop does
    base = torch.randn(1001, device=cuda)
    src = base[1:]
    assert torch.equal(KERNELS.copy(src), src.clone())


def _kernels_run(fn, prefix="roi_align_bwd_"):
    """``fn()`` under torch.profiler: its result and the names of the
    kernels whose name holds ``prefix`` that it ran on the card."""
    from torch.profiler import ProfilerActivity, profile

    from eksml_tpu_torch.train import CAPTURE_PRIMERS

    torch.cuda.synchronize()    # no earlier work runs inside the window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # late in a long process a session loses a varying count of its
        # first device records (PERF.md §6): the trainer's primers first
        primer = torch.zeros(1, device="cuda")
        for _ in range(CAPTURE_PRIMERS):
            primer.add_(1)
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key for e in prof.key_averages() if prefix in e.key}


def _assert_levels_close(got, want, dtype):
    assert any(float(w.float().abs().max()) > 0 for w in want)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        _assert_close(a.to(dtype), w, dtype,
                      max(float(w.float().abs().max()), 1e-30))


@pytest.mark.parametrize("out_size,design", [(7, "footprint"),
                                             (80, "rowwise")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 6])
def test_backward_scalar_path_matches_plain_version(cuda, dtype, c,
                                                    out_size, design):
    """C % 4 != 0: one channel per reduction, in the footprint kernel
    and, at an out size whose footprint does not fit in shared memory,
    in the rowwise one."""
    feats, rois = _inputs(cuda, dtype, c=c)
    g = torch.randn((*rois.shape[:2], out_size, out_size, c),
                    device=cuda).to(dtype)
    want = roi_align_backward_plain(feats, rois, g, STRIDES, out_size)
    got, ran = _kernels_run(lambda: KERNELS.bwd(
        _zeros_like_levels(feats), rois, g, STRIDES, out_size))
    assert len(ran) == 1 and f"roi_align_bwd_{design}_kernel" in ran.pop()
    _assert_levels_close(got, want, dtype)


def test_backward_takes_unaligned_accumulators(cuda):
    """Accumulators that start 4 bytes past a 16-byte boundary take the
    scalar path and still match."""
    feats, rois = _inputs(cuda, torch.float32)
    g = torch.randn((*rois.shape[:2], 14, 14, 64), device=cuda)
    accs = [torch.zeros(f.numel() + 1, device=cuda)[1:].view(f.shape)
            for f in feats]
    assert all(a.data_ptr() % 16 == 4 and a.is_contiguous() for a in accs)
    got = KERNELS.bwd(accs, rois, g, STRIDES, 14)
    want = roi_align_backward_plain(feats, rois, g, STRIDES, 14)
    torch.cuda.synchronize()
    _assert_levels_close(got, want, torch.float32)


@pytest.mark.parametrize("roi", [[-500.0, -400.0, 900.0, 1000.0],
                                 [50.0, 60.0, 50.4, 60.7]],
                         ids=["larger_than_the_level", "sub_pixel"])
@pytest.mark.parametrize("out_size", [7, 14])
def test_backward_extreme_rois_match_plain_version(cuda, roi, out_size):
    feats, _ = _inputs(cuda, torch.float32, b=1, n=3, seed=6)
    rois = torch.tensor([[roi]], device=cuda)
    g = torch.randn((1, 1, out_size, out_size, 64), device=cuda)
    got = KERNELS.bwd(_zeros_like_levels(feats), rois, g, STRIDES, out_size)
    want = roi_align_backward_plain(feats, rois, g, STRIDES, out_size)
    torch.cuda.synchronize()
    _assert_levels_close(got, want, torch.float32)


def test_backward_256_copies_of_one_roi_match_plain_version(cuda):
    """Worst contention: every block reduces into the same pixels."""
    feats, _ = _inputs(cuda, torch.float32, b=1, n=3, seed=7)
    rois = torch.tensor([[[20.0, 30.0, 90.0, 120.0]]],
                        device=cuda).repeat(1, 256, 1).contiguous()
    g = torch.randn((1, 256, 7, 7, 64), device=cuda)
    got = KERNELS.bwd(_zeros_like_levels(feats), rois, g, STRIDES, 7)
    want = roi_align_backward_plain(feats, rois, g, STRIDES, 7)
    torch.cuda.synchronize()
    _assert_levels_close(got, want, torch.float32)


def test_backward_takes_the_rowwise_design_where_the_footprint_does_not_fit(
        cuda):
    """At out 64 the footprint's shared memory exceeds a block's: the
    wrapper runs the rowwise kernel, which matches the plain version."""
    feats, rois = _inputs(cuda, torch.float32, c=8, n=4)
    g = torch.randn((*rois.shape[:2], 64, 64, 8), device=cuda)
    want = roi_align_backward_plain(feats, rois, g, STRIDES, 64)
    got, ran = _kernels_run(lambda: KERNELS.bwd(
        _zeros_like_levels(feats), rois, g, STRIDES, 64))
    assert len(ran) == 1 and "roi_align_bwd_rowwise_kernel" in ran.pop()
    _assert_levels_close(got, want, torch.float32)


def test_copy_kernel_is_bitwise_clone_on_any_bytes(cuda):
    """uint8 buffers of 1, 15, 17 and 2^20 + 3 bytes, and a float32 view
    at storage offset 1 (its address 4 bytes past the fresh output's
    alignment: copied byte by byte)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for n in (1, 15, 17, 2 ** 20 + 3):
        src = torch.randint(0, 256, (n,), dtype=torch.uint8, device=cuda,
                            generator=gen)
        assert torch.equal(KERNELS.copy(src), src)
    base = torch.randn(2 ** 20 + 1, device=cuda, generator=gen)
    src = base[1:]
    assert src.storage_offset() == 1
    got = KERNELS.copy(src)
    assert torch.equal(got.view(torch.int32), src.view(torch.int32))


def test_roi_align_on_the_card_has_a_gradient(cuda):
    """The repaired fault: the model's ROIAlign on CUDA tensors is
    differentiable, through the backward kernel, and its feature
    gradient is the plain version's."""
    feats, rois = _inputs(cuda, torch.float32)
    feats = [f.requires_grad_() for f in feats]
    out = dispatch_roi_align(feats, rois, STRIDES, 7)
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    launches = [k.launches for k in KERNELS]
    out.backward(g)
    assert [k.launches for k in KERNELS] == [
        launches[0], launches[1] + 1, launches[2] + len(STRIDES)]
    want = roi_align_backward_plain(feats, rois, g, STRIDES, 7)
    for f, w in zip(feats, want):
        _assert_close(f.grad, w, torch.float32,
                      max(float(w.abs().max()), 1e-30))


def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    feats, rois = _inputs(cuda, torch.float32)
    with pytest.raises(ValueError, match="rois"):
        dispatch_roi_align(feats, rois.cpu(), STRIDES, 7)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dispatch_roi_align(tuple(f.half() for f in feats), rois, STRIDES, 7)
    with pytest.raises(ValueError, match="contiguous"):
        dispatch_roi_align(tuple(f.transpose(1, 2) for f in feats), rois,
                          STRIDES, 7)
    with pytest.raises(ValueError, match="levels"):
        dispatch_roi_align(feats[:2], rois, STRIDES, 7)
    empty = dispatch_roi_align(feats, rois[:, :0].contiguous(), STRIDES, 7)
    assert empty.shape == (2, 0, 7, 7, 64)


def test_model_on_the_card_matches_the_cpu(cuda):
    """One seeded tiny model on the card and on the CPU: features, the
    kernel's ROIAlign against the plain version on the CPU for the same
    boxes, and the box-head logits within 1e-4 of each tensor's largest
    magnitude (true float32 on the card: TF32 is off)."""
    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.serve import InferenceEngine

    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES))
    cfg.freeze()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    eng = InferenceEngine(cfg, params=params)          # default device
    try:
        assert eng.device.type == "cuda"
        assert not torch.backends.cudnn.allow_tf32
        cpu = MaskRCNN.from_config(cfg)
        cpu.load_state_dict(params)
        cpu.eval()
        x = torch.from_numpy(np.random.RandomState(1).randint(
            0, 256, (2, 128, 128, 3)).astype(np.uint8))
        boxes = _inputs("cpu", torch.float32, img=128, n=16, seed=2)[1]
        with torch.inference_mode():
            fg = eng.model._features(x.to(cuda))
            fc = cpu._features(x)
            rg = dispatch_roi_align(fg[:4], boxes.to(cuda), STRIDES, 7)
            rc = dispatch_roi_align(fc[:4], boxes, STRIDES, 7)
            lg, _ = eng.model.fastrcnn(rg.reshape(32, 7, 7, -1))
            lc, _ = cpu.fastrcnn(rc.reshape(32, 7, 7, -1))
        for g, c in list(zip(fg, fc)) + [(rg, rc), (lg, lc)]:
            g = g.float().cpu()
            assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())
        out = eng.infer(x.numpy(), np.asarray([[128, 128], [100, 90]],
                                              np.float32), 0)
        assert out["boxes"].shape == (2, 8, 4)
        assert np.isfinite(out["boxes"]).all()
        assert np.isfinite(out["masks"]).all()
    finally:
        eng.close()


def test_training_step_on_the_card_matches_the_cpu(cuda):
    """``chip_smoke.py``'s card-vs-CPU oracle on a 128² canvas with
    another seed: one step of the tiny model from the same weights,
    batch and priorities; losses and every gradient within 1e-4 of their
    largest magnitude, every update within 1e-3 of its largest
    magnitude (true float32 on the card), the mask targets equal away
    from 0.5."""
    out = chip_smoke.phase_train_reference(seed=5, img=128)
    assert out["gradient_tensors"] > 40


# ---------------------------------------------------------------------
# the forward's footprint design and its second design
# ---------------------------------------------------------------------


def _forward_matches_plain(feats, rois, out_size, sampling=2):
    """The forward kernel on ``feats`` (one launch) against the plain
    version, at the forward tolerances.  Which kernel ran is checked by
    torch.profiler only where the design is the point (out 64): on the
    card's machine the profiler has stopped seeing kernels partway
    through a long test process."""
    before = KERNELS.fwd.launches
    got = KERNELS.fwd(feats, rois, STRIDES, out_size, sampling)
    assert KERNELS.fwd.launches == before + 1
    want = batched_multilevel_roi_align(feats, rois, STRIDES, out_size,
                                        sampling)
    assert got.dtype == feats[0].dtype and got.shape == want.shape
    fmax = max(float(f.float().abs().max()) for f in feats)
    _assert_close(got, want, feats[0].dtype, fmax)
    return got


@pytest.mark.parametrize("roi", [[-500.0, -400.0, 900.0, 1000.0],
                                 [50.0, 60.0, 50.4, 60.7]],
                         ids=["larger_than_the_level", "sub_pixel"])
@pytest.mark.parametrize("out_size", [7, 14])
def test_forward_extreme_rois_match_plain_version(cuda, roi, out_size):
    feats, _ = _inputs(cuda, torch.float32, b=1, n=3, seed=6)
    _forward_matches_plain(feats, torch.tensor([[roi]], device=cuda),
                           out_size)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 6])
def test_forward_scalar_path_matches_plain_version(cuda, dtype, c):
    """C not a multiple of the 16-byte vector: one channel per load."""
    feats, rois = _inputs(cuda, dtype, c=c)
    for out_size in (7, 14):
        _forward_matches_plain(feats, rois, out_size)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_sampling_3_matches_plain_version(cuda, dtype):
    """Three samples per bin and axis: a bin's band reaches up to 6
    footprint columns, past the 4 weights a thread keeps in registers."""
    feats, rois = _inputs(cuda, dtype)
    for out_size in (7, 14):
        _forward_matches_plain(feats, rois, out_size, sampling=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_takes_an_unaligned_level(cuda, dtype):
    """P3 as a contiguous view at storage offset 1 (its address 4 or 2
    bytes past a 16-byte boundary): the scalar path, still matching."""
    feats, rois = _inputs(cuda, dtype)
    p3 = torch.empty(feats[1].numel() + 1, dtype=dtype,
                     device=cuda)[1:].view(feats[1].shape)
    p3.copy_(feats[1])
    assert p3.is_contiguous() and p3.data_ptr() % 16 != 0
    feats = (feats[0], p3) + feats[2:]
    for out_size in (7, 14):
        _forward_matches_plain(feats, rois, out_size)


def test_forward_256_copies_of_one_roi_match_plain_version(cuda):
    """256 blocks on the same footprint: each output equals the others
    bitwise (no atomics in the forward) and the plain version's."""
    feats, _ = _inputs(cuda, torch.float32, b=1, n=3, seed=7)
    rois = torch.tensor([[[20.0, 30.0, 90.0, 120.0]]],
                        device=cuda).repeat(1, 256, 1).contiguous()
    got = _forward_matches_plain(feats, rois, 7)
    assert torch.equal(got, got[:, :1].expand_as(got))


# ---------------------------------------------------------------------
# the trainer's lifecycle on the card
# ---------------------------------------------------------------------


def test_checkpoint_save_snapshots_cuda_tensors(cuda, tmp_path):
    """``save()`` copies every CUDA tensor to the host before it returns:
    the parameters and momentum buffers, changed in place right after it
    (as the next SGD step does), do not reach the committed file."""
    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config
    from eksml_tpu_torch.data.loader import make_synthetic_batch
    from eksml_tpu_torch.train import Trainer

    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + ["TRAIN.BATCH_SIZE_PER_CHIP=1",
                                             "TRAIN.LOG_PERIOD=1"])
    cfg.freeze()
    trainer = Trainer(cfg, str(tmp_path), device="cuda")
    trainer.init_state()
    batch = make_synthetic_batch(cfg, batch_size=1, image_size=128,
                                 gt_mask_size=28)
    trainer.fit(iter([batch]), 1)        # momentum buffers now exist
    want = {k: v.cpu().clone()
            for k, v in trainer.model.state_dict().items()}
    moms = {i: s["momentum_buffer"].cpu().clone()
            for i, s in trainer.optimizer.state_dict()["state"].items()}
    big = torch.randn(64 << 20, device=cuda)       # 256 MB: a long copy
    want["big"] = big.cpu()
    state = trainer.checkpoint_state()
    state["model"]["big"] = big
    assert trainer.ckpt.save(7, state)
    with torch.no_grad():
        big.mul_(-1)
        for p in trainer.model.parameters():
            p.add_(1.0)
        for s in trainer.optimizer.state.values():
            s["momentum_buffer"].mul_(3.0)
    trainer.ckpt.wait()
    got = trainer.ckpt.restore(7)
    for k, v in want.items():
        assert torch.equal(got["model"][k], v), k
    for i, m in moms.items():
        assert torch.equal(got["optimizer"]["state"][i]["momentum_buffer"],
                           m), i
    trainer.close()


def test_prefetcher_orders_copies_before_the_step(cuda):
    """Each batch copied on the prefetcher's stream is complete before
    the consumer's stream reads it, in order, with the host-only entries
    dropped."""
    from eksml_tpu_torch.data.loader import DevicePrefetcher

    n = 6
    shape = (4, 1344, 1344, 3)                    # 87 MB float32
    base = np.random.RandomState(0).rand(*shape).astype(np.float32)
    host = ({"images": base + i, "image_id": np.arange(4)}
            for i in range(n))
    want = [float(np.float64((base + i).sum(dtype=np.float64)))
            for i in range(n)]
    pf = DevicePrefetcher(host, cuda, limit=n)
    got = []
    for batch in pf:
        assert set(batch) == {"images"}
        assert batch["images"].device.type == "cuda"
        got.append(float(batch["images"].double().sum()))   # reads at once
    pf.close()
    assert len(got) == n
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-9)


@pytest.mark.parametrize("strategy", ["replicated", "fsdp"])
def test_wrapped_step_on_the_card_matches_the_unwrapped_model(cuda,
                                                              strategy):
    """A world-size-1 NCCL group: the model under DDP (``replicated``) or
    FSDP2 (``fsdp``) launches the three kernels, the backward's inside
    the wrapper's backward (2 backward, 8 copies), and its gradients
    equal the unwrapped model's on the same batch and priorities within
    the train_reference tolerance (1e-4 of each tensor's largest
    magnitude: the backward's float atomics sum in any order)."""
    import torch.distributed as dist

    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.data.loader import make_synthetic_batch
    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.parallel.sharding import ShardingPlan

    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        "PREPROC.MAX_SIZE=256", "PREPROC.TRAIN_SHORT_EDGE_SIZE=(256,256)",
        f"TRAIN.SHARDING.STRATEGY={strategy}"])
    cfg.freeze()
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in make_synthetic_batch(
        cfg, batch_size=2, image_size=256, seed=0, gt_mask_size=28).items()
        if k not in ("image_scale", "image_id")}
    params = init_params(cfg, torch.Generator().manual_seed(0))
    grads = []
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{chip_smoke._free_port()}",
        world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        for wrap in (False, True):
            model = MaskRCNN.from_config(cfg)
            model.load_state_dict(params)
            model.to(cuda).train()
            pri = model.make_priorities((2, 256, 256, cfg.DATA.MAX_GT_BOXES),
                                        torch.Generator(cuda).manual_seed(0))
            plan = ShardingPlan.from_config(cfg)
            module = plan.wrap(model) if wrap else model
            start = {k.name: k.launches for k in KERNELS}
            losses = module(batch, pri)
            before = {k.name: k.launches for k in KERNELS}
            losses["total_loss"].backward()
            torch.cuda.synchronize()
            forward = {k.name: before[k.name] - start[k.name]
                       for k in KERNELS}
            during = {k.name: k.launches - before[k.name] for k in KERNELS}
            assert forward == {KERNELS.fwd.name: 3, KERNELS.bwd.name: 0,
                               KERNELS.copy.name: 0}, forward
            assert during == {KERNELS.fwd.name: 0, KERNELS.bwd.name: 2,
                              KERNELS.copy.name: 8}, during
            grads.append({n: (p.grad.full_tensor() if hasattr(
                p.grad, "full_tensor") else p.grad).detach().cpu()
                for n, p in model.named_parameters() if p.grad is not None})
        if wrap:
            assert type(module).__name__ == (
                "DistributedDataParallel" if strategy == "replicated"
                else "FSDPMaskRCNN")
    finally:
        dist.destroy_process_group()
    plain, wrapped = grads
    assert set(plain) == set(wrapped) and len(plain) > 40
    for n, want in plain.items():
        err = float((wrapped[n] - want).abs().max()
                    / want.abs().max().clamp(min=1e-12))
        assert err <= 1e-4, (n, err)


# ---------------------------------------------------------------------
# COCO eval on the card
# ---------------------------------------------------------------------


def test_both_host_libraries_load(cuda):
    from eksml_tpu_torch._native import build_all

    libs = build_all()
    assert sorted(libs) == ["imageops", "maskops"]
    for lib in libs.values():
        assert lib.loaded, lib.error


def test_run_evaluation_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``run_evaluation`` at SMOKE widths with ``PREPROC.BUCKETS`` (the
    eval_reference phase's config) over 6 shapes images, from one set of
    weights on the card and on the CPU: equal detections per image and
    classes, boxes to 1e-3 px, scores to 1e-5, masks to 1e-4, AP to
    1e-6."""
    from eksml_tpu_torch.convert import init_params

    cfg = chip_smoke.eval_reference_config()
    records = chip_smoke.shapes_records(str(tmp_path), "val2017", 6, 3,
                                        size=(180, 240))
    params = init_params(cfg, torch.Generator().manual_seed(3))
    errs = chip_smoke.compare_eval(chip_smoke.eval_card_and_cpu(
        cfg, records, params))
    assert errs["boxes"] <= 1e-3 and errs["scores"] <= 1e-5, errs
    assert errs["masks"] <= 1e-4 and errs["AP"] <= 1e-6, errs


def test_eval_under_ddp_at_world_1_matches_the_plain_eval(cuda, tmp_path):
    """``Trainer._run_eval`` under DDP in a world-size-1 NCCL group (the
    detections gathered through CUDA buffers) gives the AP of
    ``run_evaluation`` on the plain model without a group."""
    import torch.distributed as dist

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.evalcoco import make_eval_fn, run_evaluation
    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.train import Trainer

    cfg = chip_smoke.eval_reference_config()
    records = chip_smoke.shapes_records(str(tmp_path), "val2017", 4, 5,
                                        size=(180, 240))
    params = init_params(cfg, torch.Generator().manual_seed(5))
    model = MaskRCNN.from_config(cfg)
    model.load_state_dict(params)
    plain = run_evaluation(model.to(cuda), cfg, records, device="cuda")
    results = {}
    inner = make_eval_fn(cfg, device="cuda", records=records)

    def eval_fn(m, step):
        results.update(inner(m, step))
        results["_module"] = type(m).__name__
        return {k: v for k, v in results.items() if k != "_module"}

    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{chip_smoke._free_port()}",
        world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        trainer = Trainer(cfg, str(tmp_path / "run"), device="cuda",
                          eval_fn=eval_fn)
        trainer.init_state(params)
        assert type(trainer.train_module).__name__ == \
            "DistributedDataParallel"
        trainer._run_eval(0)
        trainer.close()
    finally:
        dist.destroy_process_group()
    assert results.pop("_module") == "MaskRCNN"
    assert set(results) == set(plain) and "segm/AP" in plain
    for k, v in plain.items():
        assert abs(results[k] - v) <= 1e-6, k


# ---------------------------------------------------------------------
# the model variants: bf16 compute, the cascade, REMAT
# ---------------------------------------------------------------------


def test_bf16_training_step_on_the_card_matches_the_cpu(cuda):
    """The card-vs-CPU oracle under ``TRAIN.PRECISION=bfloat16`` on a
    128² canvas: losses and grad_norm within 8 bfloat16 epsilons
    (``chip_smoke.BF16_LOSS_TOL``), each gradient and update tensor
    within twice the CPU's own bf16-vs-float32 difference of that tensor
    on the same step (at least ``chip_smoke.BF16_TENSOR_FLOOR``), the
    CPU step on the card's proposals (bf16 near-ties reorder top-k and
    NMS)."""
    out = chip_smoke.phase_train_reference(
        seed=5, img=128, extra=("TRAIN.PRECISION=bfloat16",),
        loss_tol=chip_smoke.BF16_LOSS_TOL, tag="gpu test bf16",
        share_proposals=True)
    assert out["gradient_tensors"] > 40


def test_cascade_training_step_on_the_card_matches_the_cpu(cuda):
    """The card-vs-CPU oracle with ``MODE_CASCADE=True`` (float32, the
    f32 tolerances): three box stages, four ROIAlign backward calls."""
    out = chip_smoke.phase_train_reference(
        seed=5, img=128, extra=("MODE_CASCADE=True",), tag="gpu test cascade")
    assert "cascade2_box_loss" in out["loss_values"]
    assert out["gradient_tensors"] > 40


def test_remat_on_the_card_keeps_the_losses_and_lowers_peak_memory(cuda):
    """R50 depth at SMOKE widths, 512², batch 2: one forward and backward
    with and without ``TRAIN.REMAT`` from the same weights, batch and
    priorities: the same losses (within 1e-6) and gradients (within 1e-4
    of each tensor's largest magnitude: float atomics in the ROIAlign
    backward), and a lower peak of ``max_memory_allocated`` with REMAT."""
    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.data.loader import make_synthetic_batch
    from eksml_tpu_torch.device import resolve_device
    from eksml_tpu_torch.models import MaskRCNN

    img = 512
    dev = resolve_device("cuda")
    out = {}
    for remat in (False, True):
        cfg = config.clone()
        cfg.freeze(False)
        cfg.update_args(list(SMOKE_OVERRIDES) + [
            "BACKBONE.RESNET_NUM_BLOCKS=(3,4,6,3)",
            f"PREPROC.MAX_SIZE={img}",
            f"PREPROC.TRAIN_SHORT_EDGE_SIZE=({img},{img})",
            f"TRAIN.REMAT={remat}"])
        cfg.freeze()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 make_synthetic_batch(cfg, batch_size=2, image_size=img,
                                      seed=3, gt_mask_size=28).items()
                 if k not in ("image_scale", "image_id")}
        model = MaskRCNN.from_config(cfg)
        model.load_state_dict(init_params(cfg, torch.Generator()
                                          .manual_seed(3)))
        model.to(dev).train()
        pri = {k: v.to(dev) for k, v in model.make_priorities(
            (2, img, img, batch["gt_boxes"].shape[1]),
            torch.Generator().manual_seed(4)).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses = model(batch, pri)
        losses["total_loss"].backward()
        torch.cuda.synchronize()
        out[remat] = {
            "peak": torch.cuda.max_memory_allocated() - base,
            "losses": {k: float(v.detach()) for k, v in losses.items()},
            "grads": {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters() if p.grad is not None}}
        del model, losses, batch
        torch.cuda.empty_cache()
    a, b = out[False], out[True]
    for k, v in a["losses"].items():
        assert b["losses"][k] == pytest.approx(v, rel=1e-6), k
    assert set(a["grads"]) == set(b["grads"])
    for n, g in a["grads"].items():
        scale = float(g.abs().max().clamp(min=1e-12))
        assert float((b["grads"][n] - g).abs().max()) <= 1e-4 * scale, n
    print(f"peak above the weights: no REMAT {a['peak']} B, REMAT "
          f"{b['peak']} B")
    assert b["peak"] < a["peak"], (a["peak"], b["peak"])


# ---------------------------------------------------------------------
# observability on the card
# ---------------------------------------------------------------------


def test_profiled_step_attributes_the_kernels_by_component(cuda, tmp_path):
    """One profiled SMOKE training step through the trainer's capture
    executor (``fit(profile_steps=1)``): the capture sees the ROIAlign
    forward under ``roi-fwd`` and the backward and the accumulator copy
    under ``roi-bwd``, joins every device event to the host op that
    launched it, and leaves at most 30 % of the device time in
    ``other`` (the bound ``tests/test_profiling.py`` holds the
    reference's attribution to)."""
    import json

    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config
    from eksml_tpu_torch.data.loader import make_synthetic_batch
    from eksml_tpu_torch.train import Trainer

    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        "TRAIN.BATCH_SIZE_PER_CHIP=1", "TRAIN.LOG_PERIOD=1",
        "TELEMETRY.PORT=0", "TELEMETRY.TRACING.ENABLED=True"])
    cfg.freeze()
    trainer = Trainer(cfg, str(tmp_path), device="cuda")
    trainer.init_state()
    batch = make_synthetic_batch(cfg, batch_size=1, image_size=128,
                                 gt_mask_size=28)
    trainer.fit(iter([batch, batch]), 2, profile_steps=1)
    cap = trainer.last_capture
    trainer.close()
    assert cap["profiler"] and cap["attribution"]
    with open(cap["attribution"]) as f:
        attr = json.load(f)
    table = attr["component_table"]
    assert table["basis"] == "device" and table["device_events"] > 100
    assert table["unlinked_device_events"] == 0
    assert table["other_pct"] <= 30.0
    want = {"roi_align_fwd_": "roi-fwd", "roi_align_bwd_": "roi-bwd",
            "copy_bulk_kernel": "roi-bwd"}
    for prefix, comp in want.items():
        hits = {k: v for k, v in attr["map"].items() if prefix in k}
        assert hits, prefix
        assert all(set(v) == {comp} for v in hits.values()), hits


# ---------------------------------------------------------------------
# the step's roofline (profiling/predict.py)
# ---------------------------------------------------------------------


def _counted_smoke_step(where, params, batch, pri, cfg, shared):
    """One SMOKE training step on ``where`` under the step counter, the
    RPN proposals of the first such run given to the second (both still
    compute theirs, so the NMS is counted on both)."""
    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.profiling import predict
    from eksml_tpu_torch.train import make_optimizer, make_train_step

    model = MaskRCNN.from_config(cfg)
    model.load_state_dict(params)
    model.to(where).train()
    proposals = model._proposals

    def share(*args, **kwargs):
        out = proposals(*args, **kwargs)
        if shared:
            return tuple(t.to(where) for t in shared)
        shared.extend(t.detach().cpu() for t in out)
        return out

    model._proposals = share
    opt, sched = make_optimizer(model, cfg)
    step = make_train_step(model, opt, sched, float(cfg.TRAIN.GRADIENT_CLIP))
    b = {k: v.to(where) for k, v in batch.items()}
    p = {k: v.to(where) for k, v in pri.items()}
    _, counts = predict.count_train_step(step, b, p, 0, model, opt)
    assert "error" not in counts.meta, counts.meta
    return counts


def _by_component(counts, by_op=False):
    """{component (and op name): [FLOPs, bytes]} without the card's
    copies from the host."""
    from eksml_tpu_torch.profiling import predict

    out = {}
    for o in counts.ops:
        if o.kind == predict.TRANSFER:
            continue
        row = out.setdefault((o.component, o.name) if by_op
                             else o.component, [0, 0])
        row[0] += o.flops
        row[1] += o.bytes
    return out


def test_counted_step_on_the_card_equals_the_cpu(cuda):
    """The step counter on one SMOKE training step (128², batch 2,
    float32) from the same weights, batch, priorities and RPN proposals:
    FLOPs and bytes by component equal on the card and on the CPU (the
    ROIAlign calls by their closed form on both; the card's copies from
    the host left out), and so does the prediction."""
    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.data.loader import make_synthetic_batch
    from eksml_tpu_torch.profiling import predict

    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + ["TRAIN.BATCH_SIZE_PER_CHIP=2"])
    cfg.freeze()
    batch = make_synthetic_batch(cfg, batch_size=2, image_size=128,
                                 seed=7, gt_mask_size=28)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()
             if k not in ("image_scale", "image_id")}
    params = init_params(cfg, torch.Generator().manual_seed(7))
    from eksml_tpu_torch.models import MaskRCNN

    pri = MaskRCNN.from_config(cfg).make_priorities(
        (2, 128, 128, cfg.DATA.MAX_GT_BOXES),
        torch.Generator().manual_seed(7))
    shared = []
    cpu = _counted_smoke_step("cpu", params, batch, pri, cfg, shared)
    card = _counted_smoke_step(cuda, params, batch, pri, cfg, shared)
    got, want = _by_component(card), _by_component(cpu)
    ops_got, ops_want = (_by_component(card, True),
                         _by_component(cpu, True))
    assert got == want, {k: (ops_got.get(k), ops_want.get(k))
                         for k in set(ops_got) | set(ops_want)
                         if ops_got.get(k) != ops_want.get(k)}
    assert [(o.name, o.flops, o.bytes) for o in card.kernel_calls()] == \
        [(o.name, o.flops, o.bytes) for o in cpu.kernel_calls()]
    a = predict.predict_for_step(card, torch.cuda.get_device_name(0))
    b = predict.predict_for_step(cpu)
    assert a["totals"]["flops"] == b["totals"]["flops"]
