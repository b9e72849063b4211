"""Multilevel ROIAlign: the plain PyTorch version and the dispatch.

Semantics of ``eksml_tpu/ops/roi_align.py`` (Detectron2's
``aligned=True``): every ROI gives ``out × out`` bins of
``sampling²`` bilinear samples at ``y1 - 0.5 + (bin + (j + 0.5)/s)·bin_h``
in level coordinates, a tap outside ``[0, H-1] × [0, W-1]`` counts zero,
and each bin is the mean of its samples.  FPN level per ROI is the
plain heuristic ``k = 4 + log2(√area / 224)`` clipped to the levels.

The plain version follows the CUDA kernel (``ops/cuda/roi_align_kernel``)
rather than the reference's XLA path in one respect: coordinates,
weights and sums are float32 whatever the feature dtype, and only the
result is cast to the feature dtype.  The reference casts the ROIs to
the feature dtype first (``roi_align.py:92``), so the two agree exactly
in float32 and differ by design in bfloat16.

The model's ROIAlign call is ``dispatch_roi_align``, the kernel's
wrapper (``ops/cuda/roi_align_kernel.RoiAlignForward``): it launches the
kernel for CUDA tensors and returns the plain version for CPU tensors
(the tests).  On the card the plain version is the kernel's oracle.
"""

from __future__ import annotations

from typing import Sequence

import torch

from eksml_tpu_torch.ops.cuda.roi_align_kernel import RoiAlignForward


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as IEEE division on every device: PyTorch's
    CUDA ``div`` by a host scalar multiplies by the rounded reciprocal,
    one ulp off the kernel's (and the reference's) division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _bilinear_gather(feat: torch.Tensor, bidx: torch.Tensor,
                     y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample ``feat [B, H, W, C]`` of image ``bidx`` at float32 coords
    ``y, x`` (``bidx`` broadcast against them) with bilinear weights; a
    tap outside the map contributes 0.  Returns float32 ``[..., C]``."""
    H, W = feat.shape[1], feat.shape[2]
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly = y - y0
    lx = x - x0
    hy = 1.0 - ly
    hx = 1.0 - lx

    def tap(yi, xi, w):
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        vals = feat[bidx, yc, xc].float()
        return vals * (w * inb)[..., None]

    return (tap(y0, x0, hy * hx) + tap(y0, x0 + 1, hy * lx)
            + tap(y0 + 1, x0, ly * hx) + tap(y0 + 1, x0 + 1, ly * lx))


def _align(feat: torch.Tensor, bidx: torch.Tensor, rois: torch.Tensor,
           spatial_scale: float, out_size: int,
           sampling_ratio: int) -> torch.Tensor:
    """ROIAlign of ``rois [N, 4]`` on ``feat [B, H, W, C]`` (ROI ``i``
    reads image ``bidx[i]``) → ``[N, out, out, C]`` in the feature
    dtype."""
    rois = rois.float() * spatial_scale
    x1, y1, x2, y2 = rois[:, 0], rois[:, 1], rois[:, 2], rois[:, 3]
    bin_w = _div((x2 - x1).clamp(min=1e-4), out_size)
    bin_h = _div((y2 - y1).clamp(min=1e-4), out_size)
    s = sampling_ratio
    dev = rois.device
    frac = _div(torch.arange(s, dtype=torch.float32, device=dev) + 0.5, s)
    bins = torch.arange(out_size, dtype=torch.float32, device=dev)
    # [N, out, s]
    ys = (y1[:, None, None] - 0.5
          + (bins[None, :, None] + frac[None, None, :]) * bin_h[:, None, None])
    xs = (x1[:, None, None] - 0.5
          + (bins[None, :, None] + frac[None, None, :]) * bin_w[:, None, None])
    n = rois.shape[0]
    shape = (n, out_size, s, out_size, s)
    yy = ys[:, :, :, None, None].expand(shape)
    xx = xs[:, None, None, :, :].expand(shape)
    vals = _bilinear_gather(feat, bidx.view(n, 1, 1, 1, 1), yy, xx)
    return vals.mean(dim=(2, 4)).to(feat.dtype)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              out_size: int, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign on one level: feat ``[H, W, C]``, rois ``[N, 4]``
    (x1, y1, x2, y2 in image coords) → ``[N, out, out, C]``."""
    bidx = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return _align(feat[None], bidx, rois, spatial_scale, out_size,
                  sampling_ratio)


def assign_fpn_levels(rois: torch.Tensor, min_level: int = 2,
                      max_level: int = 5, canonical_size: float = 224.0,
                      canonical_level: int = 4) -> torch.Tensor:
    """FPN heuristic level per ROI (int32 ``[N]``),
    k = k0 + log2(√area / 224)."""
    rois = rois.float()
    w = (rois[:, 2] - rois[:, 0]).clamp(min=0.0)
    h = (rois[:, 3] - rois[:, 1]).clamp(min=0.0)
    scale = torch.sqrt((w * h).clamp(min=1e-8))
    lvl = torch.floor(canonical_level
                      + torch.log2(_div(scale, canonical_size) + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int32)


def batched_multilevel_roi_align(feats: Sequence[torch.Tensor],
                                 rois: torch.Tensor, strides: Sequence[int],
                                 out_size: int, sampling_ratio: int = 2,
                                 min_level: int = 2) -> torch.Tensor:
    """FPN ROIAlign: feats ``[(B, Hl, Wl, C), ...]`` for levels
    P_min.., rois ``[B, N, 4]`` → ``[B, N, out, out, C]``.  Each ROI is
    aligned on its assigned level only (the reference aligns on every
    level and selects by a one-hot mask, which gives the same values)."""
    b, n = rois.shape[0], rois.shape[1]
    c = feats[0].shape[-1]
    flat = rois.reshape(b * n, 4)
    levels = assign_fpn_levels(
        flat, min_level=min_level,
        max_level=min_level + len(feats) - 1) - min_level
    bidx = torch.arange(b, device=rois.device).repeat_interleave(n)
    out = feats[0].new_zeros((b * n, out_size, out_size, c))
    for i, (feat, stride) in enumerate(zip(feats, strides)):
        sel = torch.nonzero(levels == i).squeeze(1)
        if sel.numel():
            out[sel] = _align(feat, bidx[sel], flat[sel], 1.0 / stride,
                              out_size, sampling_ratio)
    return out.reshape(b, n, out_size, out_size, c)


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], out_size: int,
                         sampling_ratio: int = 2,
                         min_level: int = 2) -> torch.Tensor:
    """One image: feats ``[(Hl, Wl, C), ...]``, rois ``[N, 4]`` →
    ``[N, out, out, C]``."""
    return batched_multilevel_roi_align(
        [f[None] for f in feats], rois[None], strides, out_size,
        sampling_ratio, min_level)[0]


# the model's ROIAlign call, and the only place that routes by device
dispatch_roi_align = RoiAlignForward(batched_multilevel_roi_align)
