"""Second-stage heads (``eksml_tpu/models/heads.py``): ``BoxHead``,
``MaskHead``, and for training proposal-target sampling and the head
losses.  The training functions take a leading batch dim where the
reference vmaps over images."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eksml_tpu_torch.models.resnet import SameConv2d, to_nchw
from eksml_tpu_torch.models.rpn import (sigmoid_binary_cross_entropy,
                                        smooth_l1)
from eksml_tpu_torch.ops.boxes import encode_boxes, pairwise_iou
from eksml_tpu_torch.ops.sampling import sample_by_priority


class BoxHead(nn.Module):
    """2-FC head → per-class logits and per-class box deltas.  ROI
    features flatten in (row, column, channel) order, as in the
    reference."""

    def __init__(self, in_dim: int, num_classes: int = 81,
                 fc_dim: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.fc6 = nn.Linear(in_dim, fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc_dim)
        setattr(self, "class", nn.Linear(fc_dim, num_classes))
        self.box = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[N, P, P, C]`` → logits ``[N, K]``, deltas ``[N, K, 4]``."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        logits = getattr(self, "class")(x)
        return logits, self.box(x).reshape(-1, self.num_classes, 4)


class MaskHead(nn.Module):
    """4x conv3x3 + 2x2/2 transposed conv + 1x1 per-class logits."""

    def __init__(self, in_ch: int, num_classes: int = 81, dim: int = 256):
        super().__init__()
        for i in range(4):
            setattr(self, f"fcn{i}", SameConv2d(in_ch if i == 0 else dim,
                                                dim, 3))
        self.deconv = nn.ConvTranspose2d(dim, dim, 2, stride=2)
        self.conv = SameConv2d(dim, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """``[N, P, P, C]`` NHWC → logits ``[N, 2P, 2P, K]`` NHWC."""
        x = to_nchw(roi_feats)
        for i in range(4):
            x = F.relu(getattr(self, f"fcn{i}")(x))
        x = F.relu(self.deconv(x))
        return self.conv(x).permute(0, 2, 3, 1)


def max_fg_proposals(batch_per_im: int, fg_ratio: float) -> int:
    """Static cap on fg proposals per image: the sampler compacts the
    taken fg into this many leading slots and the mask head slices
    exactly this prefix.  ``fg_ratio=0`` means a pure-background head
    batch (0); any positive ratio keeps at least one fg slot."""
    n = int(batch_per_im * fg_ratio)
    return max(1, n) if fg_ratio > 0 else 0


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i]]`` for x ``[B, M, ...]`` and idx ``[B, K]``."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def sample_proposal_targets(
        proposals: torch.Tensor, proposal_scores: torch.Tensor,
        gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
        gt_valid: torch.Tensor, fg_priorities: torch.Tensor,
        bg_priorities: torch.Tensor, batch_per_im: int, fg_thresh: float,
        fg_ratio: float, gt_crowd: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, ...]:
    """Sample a fixed ``batch_per_im`` of proposals per image for head
    training.  proposals ``[B, P, 4]`` with scores ``[B, P]`` (``-inf``
    padding), padded GT ``[B, G, ...]``, priorities ``[B, P + G]`` (the
    reference's key splits at ``heads.py:121``).  GT boxes join the
    pool, crowd GT never yields positives, and proposals mostly covered
    by a crowd region are not sampled as background.

    Returns ``(rois [B, S, 4], roi_labels [B, S] int, matched_gt [B, S],
    fg_mask [B, S], valid_mask [B, S])``, S = ``batch_per_im``, with the
    taken fg in the leading slots, then the taken bg, then padding."""
    crowd = torch.zeros_like(gt_valid) if gt_crowd is None else gt_crowd
    target_ok = (gt_valid > 0) & (crowd == 0)
    pool_boxes = torch.cat([proposals, gt_boxes], dim=1)
    pool_valid = torch.cat([torch.isfinite(proposal_scores), target_ok],
                           dim=1)
    iou_all = pairwise_iou(pool_boxes, gt_boxes)           # [B, P+G, G]
    iou = iou_all * target_ok[:, None, :].to(iou_all.dtype)
    best_iou, matched = iou.amax(dim=2), iou.argmax(dim=2)
    crowd_cols = ((gt_valid > 0) & (crowd > 0))[:, None, :]
    crowd_iou = (iou_all * crowd_cols.to(iou_all.dtype)).amax(dim=2)

    fg_cand = (best_iou >= fg_thresh) & pool_valid
    bg_cand = (best_iou < fg_thresh) & pool_valid & (crowd_iou < fg_thresh)

    max_fg = max_fg_proposals(batch_per_im, fg_ratio)
    fg_idx, fg_take = sample_by_priority(fg_cand, fg_priorities, max_fg)
    num_bg = batch_per_im - fg_take.sum(dim=-1)
    bg_idx, bg_take = sample_by_priority(bg_cand, bg_priorities,
                                         batch_per_im, limit=num_bg)

    idx = torch.cat([fg_idx, bg_idx], dim=1)       # [B, max_fg + S]
    take = torch.cat([fg_take, bg_take], dim=1)
    # compact to S slots, taken first: the reference's argsort(~take)
    # relies on a stable sort, and the mask head slices the fg prefix
    order = torch.argsort((~take).to(torch.uint8), dim=1,
                          stable=True)[:, :batch_per_im]
    idx = torch.gather(idx, 1, order)
    take = torch.gather(take, 1, order)
    is_fg = order < max_fg

    rois = _take(pool_boxes, idx)
    matched_sel = torch.gather(matched, 1, idx)
    fg = is_fg & take
    labels = torch.where(fg, torch.gather(gt_classes, 1, matched_sel),
                         torch.zeros_like(matched_sel, dtype=gt_classes.dtype))
    return rois, labels, matched_sel, fg, take


def box_head_losses(logits: torch.Tensor, deltas: torch.Tensor,
                    rois: torch.Tensor, roi_labels: torch.Tensor,
                    matched_gt: torch.Tensor, gt_boxes: torch.Tensor,
                    fg_mask: torch.Tensor, valid_mask: torch.Tensor,
                    reg_weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image softmax CE over the sampled proposals and smooth-L1 on
    the fg boxes' GT-class deltas (``[B]`` each), both normalized by the
    number of sampled proposals.  logits ``[B, S, K]``, deltas
    ``[B, S, K, 4]``."""
    n_valid = valid_mask.sum(dim=-1).clamp(min=1)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    labels = roi_labels.long()
    ce = -torch.gather(logp, 2, labels[..., None])[..., 0]
    cls_loss = torch.where(valid_mask, ce, zero).sum(dim=-1) / n_valid
    targets = encode_boxes(_take(gt_boxes, matched_gt), rois, reg_weights)
    sel = torch.gather(deltas, 2, labels.clamp(min=0)[..., None, None]
                       .expand(*labels.shape, 1, 4))[:, :, 0]
    reg = smooth_l1(sel - targets, beta=1.0).sum(dim=-1)
    box_loss = torch.where(fg_mask, reg, zero).sum(dim=-1) / n_valid
    return cls_loss, box_loss


def mask_head_loss(mask_logits: torch.Tensor, roi_labels: torch.Tensor,
                   mask_targets: torch.Tensor,
                   fg_mask: torch.Tensor) -> torch.Tensor:
    """Per-image BCE of each fg ROI's GT-class mask channel, averaged
    over pixels, then over the fg ROIs (``[B]``).  mask_logits
    ``[B, S, M, M, K]``, targets ``[B, S, M, M]`` in {0, 1}."""
    b, s, m = mask_logits.shape[:3]
    pick = roi_labels.long().reshape(b, s, 1, 1, 1).expand(b, s, m, m, 1)
    sel = torch.gather(mask_logits, 4, pick)[..., 0]
    bce = sigmoid_binary_cross_entropy(sel, mask_targets)
    per_roi = bce.mean(dim=(2, 3))
    n_fg = fg_mask.sum(dim=-1).clamp(min=1)
    zero = torch.zeros((), dtype=per_roi.dtype, device=per_roi.device)
    return torch.where(fg_mask, per_roi, zero).sum(dim=-1) / n_fg
