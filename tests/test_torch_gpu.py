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


def _backward_kernels_run(fn):
    """``fn()`` under torch.profiler: its result and the names of the
    backward kernels it ran on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key for e in prof.key_averages()
                 if "roi_align_bwd_" in e.key}


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
    got, ran = _backward_kernels_run(lambda: KERNELS.bwd(
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
    got, ran = _backward_kernels_run(lambda: KERNELS.bwd(
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
