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

from eksml_tpu_torch.ops.roi_align import (  # noqa: E402
    batched_multilevel_roi_align, dispatch_roi_align)

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
    before = dispatch_roi_align.launches
    got = dispatch_roi_align(feats, rois, STRIDES, out_size)
    assert dispatch_roi_align.launches == before + 1
    want = batched_multilevel_roi_align(feats, rois, STRIDES, out_size)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    fmax = max(float(f.float().abs().max()) for f in feats)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * fmax
    else:
        w = want.float().abs()
        _, e = torch.frexp(w)
        ulp = torch.where(w == 0, torch.zeros_like(w),
                          torch.ldexp(torch.ones_like(w), e - 8))
        assert bool((diff <= ulp + 1e-5 * fmax).all())


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
