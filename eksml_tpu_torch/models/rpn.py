"""Region Proposal Network head and proposal generation
(``eksml_tpu/models/rpn.py``: ``RPNHead``, ``generate_proposals``).
Anchor matching, sampling and the RPN losses belong to training."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eksml_tpu_torch.models.resnet import SameConv2d, to_nchw
from eksml_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from eksml_tpu_torch.ops.nms import nms_mask, top_k


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / box-delta convs over every
    level.  Outputs flatten in (row, column, anchor) order, the order of
    ``ops.anchors.generate_fpn_anchors``."""

    def __init__(self, num_anchors: int = 3, channels: int = 256):
        super().__init__()
        self.conv0 = SameConv2d(channels, channels, 3)
        setattr(self, "class", SameConv2d(channels, num_anchors, 1))
        self.box = SameConv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """NHWC levels → logits ``[(B, A_l)]`` and deltas
        ``[(B, A_l, 4)]``."""
        cls = getattr(self, "class")
        logits, deltas = [], []
        for f in feats:
            h = F.relu(self.conv0(to_nchw(f)))
            b = h.shape[0]
            logits.append(cls(h).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.box(h).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return logits, deltas


def generate_proposals(per_level_logits: Sequence[torch.Tensor],
                       per_level_deltas: Sequence[torch.Tensor],
                       per_level_anchors: Sequence[torch.Tensor],
                       image_hw: torch.Tensor, pre_nms_topk: int,
                       post_nms_topk: int, nms_thresh: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-count proposals for a batch: per level top-k by score →
    decode → clip to each image's true size → NMS; then the global
    top ``post_nms_topk``.  logits ``[(B, A_l)]``, deltas
    ``[(B, A_l, 4)]``, anchors ``[(A_l, 4)]``, image_hw ``[B, 2]``.
    Returns boxes ``[B, P, 4]`` and scores ``[B, P]`` (``-inf`` marks
    padding)."""
    height = image_hw[:, 0:1]
    width = image_hw[:, 1:2]
    all_boxes, all_scores = [], []
    for logits, deltas, anchors in zip(per_level_logits, per_level_deltas,
                                       per_level_anchors):
        k = min(pre_nms_topk, logits.shape[1])
        scores, idx = top_k(logits, k)
        sel = torch.gather(deltas, 1, idx[..., None].expand(*idx.shape, 4))
        boxes = clip_boxes(decode_boxes(sel, anchors[idx]), height, width)
        wh_ok = ((boxes[..., 2] - boxes[..., 0]) > 1e-3) \
            & ((boxes[..., 3] - boxes[..., 1]) > 1e-3)
        all_boxes.append(boxes)
        all_scores.append(torch.where(
            wh_ok, scores, torch.full_like(scores, float("-inf"))))
    # all levels (and images) through ONE batched NMS: short levels pad
    # with zero-area / -inf rows, inert under NMS
    kmax = max(b.shape[1] for b in all_boxes)
    boxes_lv = torch.stack([F.pad(b, (0, 0, 0, kmax - b.shape[1]))
                            for b in all_boxes], 1)
    scores_lv = torch.stack([
        F.pad(s, (0, kmax - s.shape[1]), value=float("-inf"))
        for s in all_scores], 1)
    keep = nms_mask(boxes_lv, scores_lv, nms_thresh)
    scores_lv = torch.where(keep, scores_lv,
                            torch.full_like(scores_lv, float("-inf")))
    b = boxes_lv.shape[0]
    boxes = boxes_lv.reshape(b, -1, 4)
    top_scores, top_idx = top_k(scores_lv.reshape(b, -1), post_nms_topk)
    top_boxes = torch.gather(boxes, 1,
                             top_idx[..., None].expand(*top_idx.shape, 4))
    return top_boxes, top_scores
