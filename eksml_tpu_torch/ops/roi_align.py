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

The model's ROIAlign call is ``dispatch_roi_align``, which is
``ops/cuda/roi_align_kernel.RoiAlignFunction`` over ``KERNELS``: its
forward and backward call the kernels' wrappers, which launch the
hand-written kernels on CUDA tensors and run the plain versions here
(``batched_multilevel_roi_align``, ``accumulate_roi_align_backward``)
on CPU tensors.  On the card the plain versions
(``batched_multilevel_roi_align`` and ``roi_align_backward_plain``) are
the kernels' oracles.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from eksml_tpu_torch.ops.cuda.roi_align_kernel import (RoiAlignFunction,
                                                       RoiAlignKernels)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as IEEE division on every device: PyTorch's
    CUDA ``div`` by a host scalar multiplies by the rounded reciprocal,
    one ulp off the kernel's (and the reference's) division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _taps(y: torch.Tensor, x: torch.Tensor, H: int, W: int):
    """The four bilinear taps of samples at float32 coords ``y, x`` on an
    ``H × W`` map: ``(row, column, weight)`` each, rows and columns
    clamped into the map and the weight 0 for a tap outside it."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly = y - y0
    lx = x - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    for yi, xi, w in ((y0, x0, hy * hx), (y0, x0 + 1, hy * lx),
                      (y0 + 1, x0, ly * hx), (y0 + 1, x0 + 1, ly * lx)):
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        yield (yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long(),
               w * inb)


def _bilinear_gather(feat: torch.Tensor, bidx: torch.Tensor,
                     y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample ``feat [B, H, W, C]`` of image ``bidx`` at float32 coords
    ``y, x`` (``bidx`` broadcast against them) with bilinear weights; a
    tap outside the map contributes 0.  Returns float32 ``[..., C]``."""
    out = None
    for yc, xc, w in _taps(y, x, feat.shape[1], feat.shape[2]):
        v = feat[bidx, yc, xc].float() * w[..., None]
        out = v if out is None else out + v
    return out


def _sample_coords(rois: torch.Tensor, spatial_scale: float, out_size: int,
                   sampling_ratio: int):
    """Sample coordinates ``y, x [N, out, s, out, s]`` of ``rois
    [N, 4]``: ``y1 - 0.5 + (bin + (j + 0.5)/s) · bin_h`` in level
    coordinates, in float32."""
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
    shape = (rois.shape[0], out_size, s, out_size, s)
    return (ys[:, :, :, None, None].expand(shape),
            xs[:, None, None, :, :].expand(shape))


def _align(feat: torch.Tensor, bidx: torch.Tensor, rois: torch.Tensor,
           spatial_scale: float, out_size: int,
           sampling_ratio: int) -> torch.Tensor:
    """ROIAlign of ``rois [N, 4]`` on ``feat [B, H, W, C]`` (ROI ``i``
    reads image ``bidx[i]``) → ``[N, out, out, C]`` in the feature
    dtype."""
    y, x = _sample_coords(rois, spatial_scale, out_size, sampling_ratio)
    vals = _bilinear_gather(feat, bidx.view(-1, 1, 1, 1, 1), y, x)
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


def _align_backward(acc: torch.Tensor, bidx: torch.Tensor,
                    rois: torch.Tensor, g: torch.Tensor,
                    spatial_scale: float, out_size: int,
                    sampling_ratio: int) -> None:
    """Adds the gradient of :func:`_align`'s output, ``g [N, out, out,
    C]``, into the float32 map ``acc [B, H, W, C]`` (ROI ``i`` of image
    ``bidx[i]``), in place: each sample's four taps get ``w · g / s²``,
    and taps outside the map get nothing."""
    y, x = _sample_coords(rois, spatial_scale, out_size, sampling_ratio)
    _, H, W, C = acc.shape
    s = sampling_ratio
    # [N, out, 1, out, 1, C]: one bin's gradient, shared by its samples
    gs = _div(g.float(), s * s)[:, :, None, :, None, :]
    b = bidx.view(-1, 1, 1, 1, 1)
    flat = acc.view(-1, C)
    for yc, xc, w in _taps(y, x, H, W):
        flat.index_add_(0, ((b * H + yc) * W + xc).reshape(-1),
                        (gs * w[..., None]).reshape(-1, C))


def accumulate_roi_align_backward(accs: Sequence[torch.Tensor],
                                  rois: torch.Tensor, g: torch.Tensor,
                                  strides: Sequence[int], out_size: int,
                                  sampling_ratio: int = 2,
                                  min_level: int = 2):
    """Adds the feature gradient of :func:`batched_multilevel_roi_align`
    for its output gradient ``g [B, N, out, out, C]`` into the float32
    per-level maps ``accs [(B, Hl, Wl, C), ...]``, in place; returns
    them.  The plain version of the backward kernel's wrapper."""
    b, n = rois.shape[0], rois.shape[1]
    c = g.shape[-1]
    flat = rois.reshape(b * n, 4)
    levels = assign_fpn_levels(
        flat, min_level=min_level,
        max_level=min_level + len(accs) - 1) - min_level
    bidx = torch.arange(b, device=rois.device).repeat_interleave(n)
    g_flat = g.reshape(b * n, out_size, out_size, c)
    for i, (acc, stride) in enumerate(zip(accs, strides)):
        sel = torch.nonzero(levels == i).squeeze(1)
        if sel.numel():
            _align_backward(acc, bidx[sel], flat[sel], g_flat[sel],
                            1.0 / stride, out_size, sampling_ratio)
    return tuple(accs)


def roi_align_backward_plain(feats: Sequence[torch.Tensor],
                             rois: torch.Tensor, g: torch.Tensor,
                             strides: Sequence[int], out_size: int,
                             sampling_ratio: int = 2,
                             min_level: int = 2) -> Tuple[torch.Tensor, ...]:
    """The VJP of :func:`batched_multilevel_roi_align` with respect to
    the features, written out with ``index_add_``: per-level gradients
    summed in float32 and cast to the feature dtype.  The oracle of the
    backward kernel."""
    accs = tuple(torch.zeros(f.shape, dtype=torch.float32, device=f.device)
                 for f in feats)
    accumulate_roi_align_backward(accs, rois, g, strides, out_size,
                                  sampling_ratio, min_level)
    return tuple(a.to(f.dtype) for a, f in zip(accs, feats))


# the kernels of the model's ROIAlign, with their launch counts
KERNELS = RoiAlignKernels(batched_multilevel_roi_align,
                          accumulate_roi_align_backward)


def dispatch_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                       strides: Sequence[int], out_size: int,
                       sampling_ratio: int = 2,
                       min_level: int = 2) -> torch.Tensor:
    """The model's differentiable ROIAlign (predict and training alike):
    ``RoiAlignFunction`` over ``KERNELS``, whose wrappers route by
    device."""
    return RoiAlignFunction.apply(KERNELS, rois, tuple(strides), out_size,
                                  sampling_ratio, min_level, *feats)
