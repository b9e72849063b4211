"""Cascade R-CNN second stage (``eksml_tpu/models/cascade.py``): three
box heads at increasing IoU quality.

- 3 stages with IoU thresholds ``CASCADE.IOUS`` and per-stage
  box-encoding weights ``CASCADE.BBOX_REG_WEIGHTS``;
- class-agnostic box regression per stage (one delta set per ROI);
- stage 1 trains on the sampled proposals, stages 2 and 3 on the
  previous stage's refined boxes, re-labeled at the stage's threshold
  with no re-sampling;
- inference refines the boxes stage by stage and averages the three
  stages' class probabilities (``MaskRCNN._cascade_predict``).

Every stage runs on the same static ``[B, S]`` ROI set; the training
functions take a leading batch dim where the reference vmaps over
images.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from eksml_tpu_torch.models.heads import BoxHead, _take
from eksml_tpu_torch.models.rpn import smooth_l1
from eksml_tpu_torch.ops.boxes import (clip_boxes, decode_boxes,
                                      encode_boxes, pairwise_iou)


class CascadeBoxHead(BoxHead):
    """2-FC head with per-class logits and class-agnostic deltas, both
    float32 (the matmuls in the compute ``dtype``)."""

    def __init__(self, in_dim: int, num_classes: int = 81,
                 fc_dim: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, num_classes, fc_dim, dtype, box_dim=4)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[N, P, P, C]`` → logits ``[N, K]``, deltas ``[N, 4]``."""
        return self.fc_outputs(roi_feats)


def relabel_rois(rois: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                 gt_crowd: torch.Tensor, iou_thresh: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(labels, matched_gt, fg_mask)`` ``[B, S]`` of a fixed ROI set
    ``rois [B, S, 4]`` at a stage's IoU threshold: the best valid
    non-crowd GT per ROI (the first of tied maxima), fg at or above
    ``iou_thresh``."""
    target_ok = (gt_valid > 0) & (gt_crowd == 0)
    iou = pairwise_iou(rois, gt_boxes) * target_ok[:, None, :].to(rois.dtype)
    best, matched = iou.amax(dim=2), iou.argmax(dim=2)
    fg = best >= iou_thresh
    labels = torch.where(fg, torch.gather(gt_classes, 1, matched),
                         torch.zeros_like(matched, dtype=gt_classes.dtype))
    return labels, matched, fg


def refine_boxes(rois: torch.Tensor, deltas: torch.Tensor,
                 reg_weights: Sequence[float],
                 image_hw: torch.Tensor) -> torch.Tensor:
    """Class-agnostic decode of ``deltas [B, S, 4]`` on ``rois
    [B, S, 4]``, clipped to each image's ``image_hw [B, 2]``; detached
    (the reference's ``stop_gradient``: each stage takes its input boxes
    as data)."""
    boxes = decode_boxes(deltas, rois, reg_weights)
    boxes = clip_boxes(boxes, image_hw[:, 0:1], image_hw[:, 1:2])
    return boxes.detach().contiguous()


def cascade_stage_losses(logits: torch.Tensor, deltas: torch.Tensor,
                         rois: torch.Tensor, labels: torch.Tensor,
                         matched_gt: torch.Tensor, gt_boxes: torch.Tensor,
                         fg_mask: torch.Tensor, valid_mask: torch.Tensor,
                         reg_weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image softmax CE and class-agnostic smooth-L1 of one stage
    (``[B]`` each), both normalized by the number of sampled proposals.
    logits ``[B, S, K]``, deltas ``[B, S, 4]``."""
    n_valid = valid_mask.sum(dim=-1).clamp(min=1)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 2, labels.long()[..., None])[..., 0]
    cls_loss = torch.where(valid_mask, ce, zero).sum(dim=-1) / n_valid
    targets = encode_boxes(_take(gt_boxes, matched_gt), rois, reg_weights)
    reg = smooth_l1(deltas - targets, beta=1.0).sum(dim=-1)
    box_loss = torch.where(fg_mask & valid_mask, reg,
                           zero).sum(dim=-1) / n_valid
    return cls_loss, box_loss
