"""Box ops: IoU, encode/decode, clipping (``eksml_tpu/ops/boxes.py``).

Boxes are ``[..., 4]`` (x1, y1, x2, y2) tensors in image coordinates;
every function broadcasts over leading dims.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Box areas, clamped at 0 for degenerate (padding) boxes."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix ``[..., N, M]`` for boxes1 ``[..., N, 4]`` × boxes2
    ``[..., M, 4]``."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(boxes1)[..., :, None] + area(boxes2)[..., None, :] - inter
    return inter / union.clamp(min=EPS)


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Target ``boxes`` relative to ``anchors`` as (dx, dy, dw, dh)."""
    aw = (anchors[..., 2] - anchors[..., 0]).clamp(min=EPS)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp(min=EPS)
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    bw = (boxes[..., 2] - boxes[..., 0]).clamp(min=EPS)
    bh = (boxes[..., 3] - boxes[..., 1]).clamp(min=EPS)
    bx = boxes[..., 0] + 0.5 * bw
    by = boxes[..., 1] + 0.5 * bh
    wx, wy, ww, wh = weights
    return torch.stack([
        wx * (bx - ax) / aw,
        wy * (by - ay) / ah,
        ww * torch.log(bw / aw),
        wh * torch.log(bh / ah),
    ], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 clip_exp: float = 4.135) -> torch.Tensor:
    """Inverse of :func:`encode_boxes`; ``clip_exp`` (log(1000/16))
    bounds dw/dh so padded or garbage deltas cannot produce inf boxes."""
    aw = (anchors[..., 2] - anchors[..., 0]).clamp(min=EPS)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp(min=EPS)
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=clip_exp)
    dh = (deltas[..., 3] / wh).clamp(max=clip_exp)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip to [0, width] × [0, height]; ``height``/``width`` may be
    scalars or tensors broadcastable against ``boxes[..., 0]`` (per-image
    true sizes inside the fixed pad)."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    height = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    width = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), width)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), height)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), width)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), height)
    return torch.stack([x1, y1, x2, y2], dim=-1)
