"""Region Proposal Network (``eksml_tpu/models/rpn.py``): the head,
proposal generation, and for training anchor matching, anchor sampling
and the RPN losses.  The training functions take a leading batch dim
where the reference vmaps over images."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eksml_tpu_torch.models.resnet import SameConv2d, to_nchw
from eksml_tpu_torch.ops.boxes import (clip_boxes, decode_boxes,
                                      encode_boxes, pairwise_iou)
from eksml_tpu_torch.ops.nms import nms_mask, top_k
from eksml_tpu_torch.ops.sampling import sample_mask_by_priority
from eksml_tpu_torch.profiling.scopes import named_scope


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / box-delta convs over every
    level.  Outputs flatten in (row, column, anchor) order, the order of
    ``ops.anchors.generate_fpn_anchors``.  The convolutions run in the
    compute ``dtype``; logits and deltas return in float32, so proposal
    decoding, NMS and the losses keep full precision."""

    def __init__(self, num_anchors: int = 3, channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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
            h = F.relu(self.conv0(to_nchw(f.to(self.dtype))))
            b = h.shape[0]
            logits.append(cls(h).permute(0, 2, 3, 1).reshape(b, -1).float())
            deltas.append(self.box(h).permute(0, 2, 3, 1)
                          .reshape(b, -1, 4).float())
        return logits, deltas


@named_scope("rpn_nms")
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


@named_scope("matching")
def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, pos_thresh: float,
                  neg_thresh: float, gt_crowd: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label ``anchors [A, 4]`` against padded GT ``gt_boxes [B, G, 4]``.

    Returns ``labels [B, A]`` (1 fg, 0 bg, -1 ignore, int32) and
    ``matched_gt [B, A]`` (index of the best GT).  Padded GT rows
    (``gt_valid`` 0) never create positives; crowd rows never become
    positives and turn the background they overlap above ``neg_thresh``
    into ignore.  The IoU matrix is ``[B, G, A]``: A is ~451k at 1344 px
    while G ≤ ``MAX_GT_BOXES``.

    Force-match: every valid non-crowd GT makes its best anchor positive.
    The reference scatters ``where(force, 1, labels[best])`` over all G
    rows (``rpn.py:92-96``), duplicates included, and a scatter with
    duplicate indices has no defined order on CUDA.  Here only the rows
    with ``force`` write, and they all write 1.  That equals the
    reference whenever no two GT rows share a best anchor, and also when
    only valid rows share one (both write 1 there); it can differ only
    where a padded or crowd row's best anchor is a valid row's, and the
    reference's own result then depends on its scatter order."""
    b = gt_boxes.shape[0]
    crowd = torch.zeros_like(gt_valid) if gt_crowd is None else gt_crowd
    target_ok = (gt_valid > 0) & (crowd == 0)
    iou_all = pairwise_iou(gt_boxes, anchors)             # [B, G, A]
    iou = iou_all * target_ok[..., None].to(iou_all.dtype)
    # argmax: the first of tied maxima, as the reference's argmax
    best_iou, matched_gt = iou.amax(dim=1), iou.argmax(dim=1)
    labels = torch.full(best_iou.shape, -1, dtype=torch.int32,
                        device=anchors.device)
    labels = torch.where(best_iou < neg_thresh, 0, labels)
    labels = torch.where(best_iou >= pos_thresh, 1, labels)
    crowd_rows = ((gt_valid > 0) & (crowd > 0))[..., None].to(iou_all.dtype)
    crowd_iou = (iou_all * crowd_rows).amax(dim=1)
    labels = torch.where((labels == 0) & (crowd_iou >= neg_thresh), -1,
                         labels)
    gt_best_iou, best_anchor = iou.amax(dim=2), iou.argmax(dim=2)  # [B, G]
    force = target_ok & (gt_best_iou > 1e-3)
    rows = torch.arange(b, device=anchors.device)[:, None].expand_as(force)
    labels = labels.index_put((rows[force], best_anchor[force]),
                              torch.ones((), dtype=torch.int32,
                                         device=anchors.device))
    has_gt = target_ok.any(dim=1, keepdim=True)
    labels = torch.where(has_gt, labels,
                         torch.where(labels == 1, 0, labels))
    return labels, matched_gt


@named_scope("sampling")
def sample_anchors(labels: torch.Tensor, fg_priorities: torch.Tensor,
                   bg_priorities: torch.Tensor, batch_per_im: int,
                   fg_ratio: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size fg/bg anchor subsample for the loss (``[B, A]`` masks
    with at most ``batch_per_im`` bits per image); the priorities
    ``[B, A]`` stand for the reference's two key splits at
    ``rpn.py:111``."""
    max_fg = int(batch_per_im * fg_ratio)
    fg_mask = sample_mask_by_priority(labels == 1, fg_priorities, max_fg)
    num_bg = batch_per_im - fg_mask.sum(dim=-1)
    bg_mask = sample_mask_by_priority(labels == 0, bg_priorities,
                                      batch_per_im, limit=num_bg)
    return fg_mask, bg_mask


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy`` in its log-sigmoid form."""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


@named_scope("rpn_loss")
def rpn_losses(logits: torch.Tensor, deltas: torch.Tensor,
               anchors: torch.Tensor, labels: torch.Tensor,
               matched_gt: torch.Tensor, gt_boxes: torch.Tensor,
               fg_mask: torch.Tensor, bg_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image RPN objectness BCE and box smooth-L1 (``[B]`` each),
    both normalized by the number of sampled anchors.  logits ``[B, A]``,
    deltas ``[B, A, 4]``, anchors ``[A, 4]``, labels / matched_gt /
    masks ``[B, A]``, gt_boxes ``[B, G, 4]``."""
    sel = fg_mask | bg_mask
    cls_all = sigmoid_binary_cross_entropy(logits, labels == 1)
    n_sel = sel.sum(dim=-1).clamp(min=1)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    cls_loss = torch.where(sel, cls_all, zero).sum(dim=-1) / n_sel
    gt_for_anchor = torch.gather(
        gt_boxes, 1, matched_gt[..., None].expand(*matched_gt.shape, 4))
    targets = encode_boxes(gt_for_anchor, anchors)
    box_all = smooth_l1(deltas - targets, beta=1.0 / 9).sum(dim=-1)
    box_loss = torch.where(fg_mask, box_all, zero).sum(dim=-1) / n_sel
    return cls_loss, box_loss
