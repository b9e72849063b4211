"""Mask-RCNN R50/R101-FPN and Cascade R-CNN
(``eksml_tpu/models/mask_rcnn.py``): the training forward (``forward``,
the reference's ``__call__``, ``_cascade_train`` and ``_mask_targets``)
and inference (``predict``, ``_cascade_predict``).

Static shapes as in the reference: padded GT with validity masks,
fixed proposal and sample counts, and ``TEST.RESULTS_PER_IM`` detection
rows with a ``valid`` mask, so a batch's shapes depend only on the
canvas and the batch size.  Every ROIAlign call (box head, mask head,
mask targets) goes through ``dispatch_roi_align``: the CUDA kernels for
CUDA tensors, forward and backward.

Variants (every value the reference's config accepts):
``BACKBONE.NORM`` FreezeBN or GN, ``BACKBONE.RESNET_NUM_BLOCKS``
(R50, R101), ``MODE_CASCADE`` (three class-agnostic box stages,
``models/cascade.py``; the mask head keeps the stage-1 proposals),
``TRAIN.PRECISION`` (the compute dtype: images are normalized in
float32 and cast once, the features stay in it through ROIAlign and the
heads, every head returns float32) and ``TRAIN.REMAT`` (the backbone and
the FPN, each as a whole, under non-reentrant
``torch.utils.checkpoint``: their inner activations are recomputed in
the backward, as ``nn.remat`` does).  ``TRAIN.PARAM_DTYPE`` is the
trainer's (``train.cast_for_storage``).

Profiler scopes: each top-level module runs inside a ``named_scope``
range under its Flax name (``backbone``, ``fpn``, ``rpn``,
``fastrcnn`` / ``cascade<i>``, ``maskrcnn``), beside the reference's
``jax.named_scope`` names (``input_norm``, ``mask_targets`` here,
the rest in ``rpn.py``, ``heads.py``, ``ops/``), so a
``torch.profiler`` capture names every kernel by component
(``profiling/attribution.py``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from eksml_tpu_torch.models.cascade import (CascadeBoxHead,
                                            cascade_stage_losses,
                                            refine_boxes, relabel_rois)
from eksml_tpu_torch.models.fpn import FPN
from eksml_tpu_torch.models.heads import (BoxHead, MaskHead,
                                          box_head_losses, mask_head_loss,
                                          max_fg_proposals,
                                          sample_proposal_targets)
from eksml_tpu_torch.models.resnet import ResNetBackbone
from eksml_tpu_torch.models.rpn import (RPNHead, generate_proposals,
                                        match_anchors, rpn_losses,
                                        sample_anchors)
from eksml_tpu_torch.ops.anchors import (generate_fpn_anchors,
                                        num_anchors_per_level)
from eksml_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from eksml_tpu_torch.ops.nms import class_aware_nms
from eksml_tpu_torch.ops.roi_align import dispatch_roi_align
from eksml_tpu_torch.profiling.scopes import named_scope

#: TRAIN.PRECISION / TRAIN.PARAM_DTYPE → torch dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}: one of {sorted(DTYPES)}")
    return DTYPES[name]


class MaskRCNN(nn.Module):
    def __init__(self, num_classes: int = 81, with_masks: bool = True,
                 resnet_blocks: Sequence[int] = (3, 4, 6, 3),
                 norm: str = "FreezeBN", freeze_at: int = 2,
                 fpn_channels: int = 256,
                 anchor_strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 rpn_pos_thresh: float = 0.7,
                 rpn_neg_thresh: float = 0.3,
                 rpn_batch_per_im: int = 256,
                 rpn_fg_ratio: float = 0.5,
                 rpn_nms_thresh: float = 0.7,
                 pre_nms_topk: int = 2000,
                 post_nms_topk: int = 1000,
                 test_pre_nms_topk: int = 1000,
                 test_post_nms_topk: int = 1000,
                 frcnn_batch_per_im: int = 512,
                 frcnn_fg_thresh: float = 0.5,
                 frcnn_fg_ratio: float = 0.25,
                 bbox_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0),
                 fc_head_dim: int = 1024, mask_head_dim: int = 256,
                 mask_resolution: int = 28, test_nms_thresh: float = 0.5,
                 test_score_thresh: float = 0.05,
                 test_results_per_im: int = 100,
                 pixel_mean: Sequence[float] = (123.675, 116.28, 103.53),
                 pixel_std: Sequence[float] = (58.395, 57.12, 57.375),
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, cascade: bool = False,
                 cascade_ious: Sequence[float] = (0.5, 0.6, 0.7),
                 cascade_reg_weights: Sequence[Sequence[float]] = (
                     (10., 10., 5., 5.), (20., 20., 10., 10.),
                     (30., 30., 15., 15.))):
        super().__init__()
        self.num_classes = num_classes
        self.with_masks = with_masks
        self.anchor_strides = tuple(anchor_strides)
        self.anchor_sizes = tuple(anchor_sizes)
        self.anchor_ratios = tuple(anchor_ratios)
        self.rpn_pos_thresh = rpn_pos_thresh
        self.rpn_neg_thresh = rpn_neg_thresh
        self.rpn_batch_per_im = rpn_batch_per_im
        self.rpn_fg_ratio = rpn_fg_ratio
        self.rpn_nms_thresh = rpn_nms_thresh
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.frcnn_batch_per_im = frcnn_batch_per_im
        self.frcnn_fg_thresh = frcnn_fg_thresh
        self.frcnn_fg_ratio = frcnn_fg_ratio
        self.test_pre_nms_topk = test_pre_nms_topk
        self.test_post_nms_topk = test_post_nms_topk
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        self.mask_resolution = mask_resolution
        self.test_nms_thresh = test_nms_thresh
        self.test_score_thresh = test_score_thresh
        self.test_results_per_im = test_results_per_im
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.cascade = cascade
        self.cascade_ious = tuple(cascade_ious)
        self.cascade_reg_weights = tuple(tuple(w)
                                         for w in cascade_reg_weights)

        self.backbone = ResNetBackbone(resnet_blocks, freeze_at, norm,
                                       compute_dtype)
        self.fpn = FPN(num_channels=fpn_channels, dtype=compute_dtype)
        self.rpn = RPNHead(len(self.anchor_ratios), fpn_channels,
                           compute_dtype)
        if cascade:
            for i in range(len(self.cascade_ious)):
                setattr(self, f"cascade{i}", CascadeBoxHead(
                    fpn_channels * 7 * 7, num_classes, fc_head_dim,
                    compute_dtype))
        else:
            self.fastrcnn = BoxHead(fpn_channels * 7 * 7, num_classes,
                                    fc_head_dim, compute_dtype)
        if with_masks:
            self.maskrcnn = MaskHead(fpn_channels, num_classes,
                                     mask_head_dim, compute_dtype)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std),
                             persistent=False)
        self._anchor_cache: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}

    @classmethod
    def from_config(cls, cfg) -> "MaskRCNN":
        return cls(
            num_classes=cfg.DATA.NUM_CLASSES,
            with_masks=cfg.MODE_MASK,
            resnet_blocks=tuple(cfg.BACKBONE.RESNET_NUM_BLOCKS),
            norm=cfg.BACKBONE.NORM,
            freeze_at=cfg.BACKBONE.FREEZE_AT,
            fpn_channels=cfg.FPN.NUM_CHANNEL,
            anchor_strides=tuple(cfg.FPN.ANCHOR_STRIDES),
            anchor_sizes=tuple(cfg.RPN.ANCHOR_SIZES),
            anchor_ratios=tuple(cfg.RPN.ANCHOR_RATIOS),
            rpn_pos_thresh=cfg.RPN.POSITIVE_ANCHOR_THRESH,
            rpn_neg_thresh=cfg.RPN.NEGATIVE_ANCHOR_THRESH,
            rpn_batch_per_im=cfg.RPN.BATCH_PER_IM,
            rpn_fg_ratio=cfg.RPN.FG_RATIO,
            rpn_nms_thresh=cfg.RPN.PROPOSAL_NMS_THRESH,
            pre_nms_topk=cfg.RPN.TRAIN_PRE_NMS_TOPK,
            post_nms_topk=cfg.RPN.TRAIN_POST_NMS_TOPK,
            test_pre_nms_topk=cfg.RPN.TEST_PRE_NMS_TOPK,
            test_post_nms_topk=cfg.RPN.TEST_POST_NMS_TOPK,
            frcnn_batch_per_im=cfg.FRCNN.BATCH_PER_IM,
            frcnn_fg_thresh=cfg.FRCNN.FG_THRESH,
            frcnn_fg_ratio=cfg.FRCNN.FG_RATIO,
            bbox_reg_weights=tuple(cfg.FRCNN.BBOX_REG_WEIGHTS),
            fc_head_dim=cfg.FPN.FRCNN_FC_HEAD_DIM,
            mask_head_dim=cfg.MRCNN.HEAD_DIM,
            mask_resolution=cfg.MRCNN.RESOLUTION,
            test_nms_thresh=cfg.TEST.FRCNN_NMS_THRESH,
            test_score_thresh=cfg.TEST.RESULT_SCORE_THRESH,
            test_results_per_im=cfg.TEST.RESULTS_PER_IM,
            pixel_mean=tuple(cfg.PREPROC.PIXEL_MEAN),
            pixel_std=tuple(cfg.PREPROC.PIXEL_STD),
            compute_dtype=dtype_of(cfg.TRAIN.PRECISION),
            remat=bool(cfg.TRAIN.REMAT),
            cascade=bool(cfg.MODE_CASCADE),
            cascade_ious=tuple(cfg.CASCADE.IOUS),
            cascade_reg_weights=tuple(
                tuple(w) for w in cfg.CASCADE.BBOX_REG_WEIGHTS),
        )

    # ---- shared trunk ------------------------------------------------

    def _features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """NHWC images → P2..P6 NHWC in the compute dtype.  uint8 input is
        normalized here in float32 (PREPROC.DEVICE_NORMALIZE); float input
        is taken as already normalized.  With ``remat`` and autograd on,
        the backbone and the FPN each run under ``checkpoint``."""
        x = images
        if x.dtype == torch.uint8:
            with named_scope("input_norm"):
                x = (x.float() - self.pixel_mean) / self.pixel_std
        x = x.to(self.compute_dtype)
        remat = self.remat and torch.is_grad_enabled()
        with named_scope("backbone"):
            c_feats = (checkpoint(self.backbone, x, use_reentrant=False)
                       if remat else self.backbone(x))
        with named_scope("fpn"):
            return (checkpoint(self.fpn, c_feats, use_reentrant=False)
                    if remat else self.fpn(c_feats))

    def _anchors(self, image_hw: Tuple[int, int], device
                 ) -> Tuple[torch.Tensor, ...]:
        key = (int(image_hw[0]), int(image_hw[1]), str(device))
        anchors = self._anchor_cache.get(key)
        if anchors is None:
            anchors = tuple(
                torch.from_numpy(a).to(device) for a in generate_fpn_anchors(
                    key[:2], self.anchor_strides, self.anchor_sizes,
                    self.anchor_ratios))
            self._anchor_cache[key] = anchors
        return anchors

    def _proposals(self, rpn_logits, rpn_deltas, anchors, image_hw,
                   pre_topk: int, post_topk: int):
        return generate_proposals(rpn_logits, rpn_deltas, anchors, image_hw,
                                  pre_topk, post_topk, self.rpn_nms_thresh)

    # ---- training ----------------------------------------------------

    def make_priorities(self, batch_shape: Tuple[int, int, int, int],
                        generator: torch.Generator
                        ) -> Dict[str, torch.Tensor]:
        """The sampling priorities of one training step, uniform in
        [0, 1) from ``generator`` and on its device, for a batch of
        ``batch_shape = (B, H, W, G)``: B canvases of H x W with G padded
        GT rows.  ``rpn_fg`` and ``rpn_bg`` are ``[B, A]`` (A anchors),
        ``frcnn_fg`` and ``frcnn_bg`` ``[B, P + G]`` (P =
        ``TRAIN_POST_NMS_TOPK``).  They stand for the reference's key
        splits (``mask_rcnn.py:217``, ``rpn.py:111``,
        ``heads.py:121``)."""
        b, h, w, g = batch_shape
        a = sum(num_anchors_per_level((h, w), self.anchor_strides,
                                      len(self.anchor_ratios)))
        n = self.post_nms_topk + g
        return {name: torch.rand((b, size), generator=generator,
                                 device=generator.device)
                for name, size in (("rpn_fg", a), ("rpn_bg", a),
                                   ("frcnn_fg", n), ("frcnn_bg", n))}

    def forward(self, batch: Dict[str, torch.Tensor],
                priorities: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Training forward → loss dict (``rpn_cls_loss``,
        ``rpn_box_loss``, ``frcnn_cls_loss`` and ``frcnn_box_loss`` or
        under the cascade ``cascade{i}_cls_loss`` and
        ``cascade{i}_box_loss``, with masks ``mrcnn_loss``, and
        ``total_loss``), all float32.

        batch: images ``[B, H, W, 3]`` (uint8 or normalized float),
        image_hw ``[B, 2]`` true sizes, gt_boxes ``[B, G, 4]``,
        gt_classes ``[B, G]``, gt_valid ``[B, G]``, optional gt_crowd
        ``[B, G]`` and gt_masks ``[B, G, MR0, MR0]`` (bbox-cropped
        binary).  priorities: see :meth:`make_priorities`."""
        images = batch["images"]
        b, H, W, _ = images.shape
        image_hw = batch["image_hw"].float()
        gt_boxes = batch["gt_boxes"]
        gt_valid = batch["gt_valid"]
        gt_crowd = batch.get("gt_crowd")
        if gt_crowd is None:
            gt_crowd = torch.zeros_like(gt_valid)
        feats = self._features(images)
        with named_scope("rpn"):
            rpn_logits, rpn_deltas = self.rpn(feats)
        anchors = self._anchors((H, W), images.device)
        anchors_cat = torch.cat(anchors, dim=0)
        logits_cat = torch.cat(rpn_logits, dim=1)      # [B, A]
        deltas_cat = torch.cat(rpn_deltas, dim=1)      # [B, A, 4]

        # --- RPN losses ---
        labels, matched = match_anchors(
            anchors_cat, gt_boxes, gt_valid, self.rpn_pos_thresh,
            self.rpn_neg_thresh, gt_crowd=gt_crowd)
        fg, bg = sample_anchors(labels, priorities["rpn_fg"],
                                priorities["rpn_bg"], self.rpn_batch_per_im,
                                self.rpn_fg_ratio)
        rpn_cls, rpn_box = rpn_losses(logits_cat, deltas_cat, anchors_cat,
                                      labels, matched, gt_boxes, fg, bg)

        # --- proposals (no gradient, as the reference's stop_gradient)
        # and target sampling ---
        with torch.no_grad():
            prop_boxes, prop_scores = self._proposals(
                [x.detach() for x in rpn_logits],
                [x.detach() for x in rpn_deltas], anchors, image_hw,
                self.pre_nms_topk, self.post_nms_topk)
            rois, roi_labels, matched_gt, fg_mask, valid_mask = \
                sample_proposal_targets(
                    prop_boxes, prop_scores, gt_boxes, batch["gt_classes"],
                    gt_valid, priorities["frcnn_fg"],
                    priorities["frcnn_bg"], self.frcnn_batch_per_im,
                    self.frcnn_fg_thresh, self.frcnn_fg_ratio,
                    gt_crowd=gt_crowd)
            rois = rois.contiguous()

        losses = {"rpn_cls_loss": rpn_cls.mean(),
                  "rpn_box_loss": rpn_box.mean()}

        s = self.frcnn_batch_per_im
        strides = self.anchor_strides[:4]
        if self.cascade:
            losses.update(self._cascade_train(
                feats, rois, roi_labels, matched_gt, fg_mask, valid_mask,
                batch, image_hw, gt_crowd))
        else:
            # --- box head ---
            roi_feats = dispatch_roi_align(feats[:4], rois, strides, 7)
            with named_scope("fastrcnn"):
                logits, deltas = self.fastrcnn(
                    roi_feats.reshape(b * s, 7, 7, -1))
            frcnn_cls, frcnn_box = box_head_losses(
                logits.reshape(b, s, -1),
                deltas.reshape(b, s, self.num_classes, 4), rois,
                roi_labels, matched_gt, gt_boxes, fg_mask, valid_mask,
                self.bbox_reg_weights)
            losses["frcnn_cls_loss"] = frcnn_cls.mean()
            losses["frcnn_box_loss"] = frcnn_box.mean()

        # --- mask head, on the fg prefix the sampler compacted (under
        # the cascade: of the stage-1 proposals, as the reference) ---
        if self.with_masks and "gt_masks" in batch:
            mr = self.mask_resolution
            ma = mr // 2
            k = max(1, max_fg_proposals(s, self.frcnn_fg_ratio))
            rois_m = rois[:, :k].contiguous()
            mask_feats = dispatch_roi_align(feats[:4], rois_m, strides, ma)
            with named_scope("maskrcnn"):
                mask_logits = self.maskrcnn(
                    mask_feats.reshape(b * k, ma, ma, -1))
            targets = self._mask_targets(rois_m, matched_gt[:, :k],
                                         gt_boxes, batch["gt_masks"])
            losses["mrcnn_loss"] = mask_head_loss(
                mask_logits.reshape(b, k, mr, mr, -1), roi_labels[:, :k],
                targets, fg_mask[:, :k]).mean()

        losses["total_loss"] = sum(losses.values())
        return losses

    def _cascade_heads(self):
        return [getattr(self, f"cascade{i}")
                for i in range(len(self.cascade_ious))]

    def _cascade_train(self, feats, rois, roi_labels, matched_gt, fg_mask,
                       valid_mask, batch, image_hw, gt_crowd
                       ) -> Dict[str, torch.Tensor]:
        """The three stages' losses (``cascade{i}_cls_loss``,
        ``cascade{i}_box_loss``): stage 1 on the sampled proposals, each
        later stage on the previous stage's refined boxes re-labeled at
        its own IoU threshold."""
        b, s = rois.shape[:2]
        strides = self.anchor_strides[:4]
        losses = {}
        heads = self._cascade_heads()
        for i, head in enumerate(heads):
            roi_feats = dispatch_roi_align(feats[:4], rois, strides, 7)
            with named_scope(f"cascade{i}"):
                logits, deltas = head(roi_feats.reshape(b * s, 7, 7, -1))
            deltas = deltas.reshape(b, s, 4)
            cls_l, box_l = cascade_stage_losses(
                logits.reshape(b, s, -1), deltas, rois, roi_labels,
                matched_gt, batch["gt_boxes"], fg_mask, valid_mask,
                self.cascade_reg_weights[i])
            losses[f"cascade{i}_cls_loss"] = cls_l.mean()
            losses[f"cascade{i}_box_loss"] = box_l.mean()
            if i + 1 < len(heads):
                rois = refine_boxes(rois, deltas.detach(),
                                    self.cascade_reg_weights[i], image_hw)
                roi_labels, matched_gt, fg_mask = relabel_rois(
                    rois, batch["gt_boxes"], batch["gt_classes"],
                    batch["gt_valid"], gt_crowd, self.cascade_ious[i + 1])
        return losses

    def _cascade_predict(self, feats, prop_boxes: torch.Tensor,
                         image_hw: torch.Tensor):
        """Sequential refinement of ``prop_boxes [B, P, 4]``; returns the
        final boxes and the class probabilities ``[B, P, K]`` averaged
        over the stages."""
        b, p = prop_boxes.shape[:2]
        strides = self.anchor_strides[:4]
        boxes = prop_boxes.contiguous()
        probs_sum = None
        heads = self._cascade_heads()
        for i, head in enumerate(heads):
            roi_feats = dispatch_roi_align(feats[:4], boxes, strides, 7)
            with named_scope(f"cascade{i}"):
                logits, deltas = head(roi_feats.reshape(b * p, 7, 7, -1))
            probs = torch.softmax(logits.reshape(b, p, -1), dim=-1)
            probs_sum = probs if probs_sum is None else probs_sum + probs
            boxes = refine_boxes(boxes, deltas.reshape(b, p, 4),
                                 self.cascade_reg_weights[i], image_hw)
        return boxes, probs_sum / len(heads)

    @torch.no_grad()
    @named_scope("mask_targets")
    def _mask_targets(self, rois: torch.Tensor, matched_gt: torch.Tensor,
                      gt_boxes: torch.Tensor,
                      gt_masks: torch.Tensor) -> torch.Tensor:
        """Resample the bbox-cropped GT masks ``[B, G, MR0, MR0]`` to the
        mask-head targets ``[B, K, mr, mr]`` of ``rois [B, K, 4]``: each
        ROI, expressed in its matched GT's stored-mask pixel frame, is
        aligned on that mask (one level, one channel, stride 1) through
        ``dispatch_roi_align``, then thresholded at 0.5."""
        b, k = rois.shape[:2]
        mr = self.mask_resolution
        bi = torch.arange(b, device=rois.device)[:, None]
        g_boxes = gt_boxes[bi, matched_gt]                   # [B, K, 4]
        g_masks = gt_masks[bi, matched_gt].float()           # [B, K, M0, M0]
        mr0 = g_masks.shape[-1]
        gw = (g_boxes[..., 2] - g_boxes[..., 0]).clamp(min=1e-4)
        gh = (g_boxes[..., 3] - g_boxes[..., 1]).clamp(min=1e-4)
        mask_rois = torch.stack([
            (rois[..., 0] - g_boxes[..., 0]) / gw * mr0,
            (rois[..., 1] - g_boxes[..., 1]) / gh * mr0,
            (rois[..., 2] - g_boxes[..., 0]) / gw * mr0,
            (rois[..., 3] - g_boxes[..., 1]) / gh * mr0], dim=-1)
        sampled = dispatch_roi_align(
            (g_masks.reshape(b * k, mr0, mr0, 1),),
            mask_rois.reshape(b * k, 1, 4), (1,), mr)
        return (sampled.reshape(b, k, mr, mr) >= 0.5).float()

    # ---- inference ---------------------------------------------------

    @torch.inference_mode()
    def predict(self, images: torch.Tensor,
                image_hw: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images ``[B, H, W, 3]`` (uint8 or normalized float), image_hw
        ``[B, 2]`` true content sizes → boxes ``[B, D, 4]``, scores
        ``[B, D]``, classes ``[B, D]`` int32, valid ``[B, D]`` and (with
        masks) masks ``[B, D, mr, mr]`` sigmoid probabilities."""
        b, H, W, _ = images.shape
        image_hw = image_hw.float()
        feats = self._features(images)
        with named_scope("rpn"):
            rpn_logits, rpn_deltas = self.rpn(feats)
        anchors = self._anchors((H, W), images.device)
        prop_boxes, prop_scores = self._proposals(
            rpn_logits, rpn_deltas, anchors, image_hw,
            self.test_pre_nms_topk, self.test_post_nms_topk)
        p = prop_boxes.shape[1]
        d = self.test_results_per_im
        strides = self.anchor_strides[:4]

        if self.cascade:
            boxes, probs = self._cascade_predict(feats, prop_boxes,
                                                 image_hw)
            score, cls = probs[..., 1:].max(dim=-1)
            cls = cls + 1
        else:
            roi_feats = dispatch_roi_align(feats[:4], prop_boxes, strides, 7)
            with named_scope("fastrcnn"):
                logits, deltas = self.fastrcnn(
                    roi_feats.reshape(b * p, 7, 7, -1))
            probs = torch.softmax(logits, dim=-1).reshape(b, p, -1)
            deltas = deltas.reshape(b, p, self.num_classes, 4)

            # best foreground class per proposal and its own deltas
            score, cls = probs[..., 1:].max(dim=-1)
            cls = cls + 1
            sel = torch.gather(deltas, 2, cls[:, :, None, None]
                               .expand(b, p, 1, 4))[:, :, 0]
            boxes = clip_boxes(decode_boxes(sel, prop_boxes,
                                            self.bbox_reg_weights),
                               image_hw[:, 0:1], image_hw[:, 1:2])
        neg_inf = torch.full_like(score, float("-inf"))
        score = torch.where(torch.isfinite(prop_scores), score, neg_inf)
        score = torch.where(score >= self.test_score_thresh, score, neg_inf)
        idx, top_sc, valid = class_aware_nms(
            boxes, score, self.test_nms_thresh, d, class_ids=cls)
        out_boxes = torch.gather(boxes, 1, idx[..., None].expand(b, d, 4))
        classes = torch.gather(cls, 1, idx)
        out = {"boxes": out_boxes, "scores": top_sc,
               "classes": classes.to(torch.int32), "valid": valid}

        if self.with_masks:
            mr = self.mask_resolution
            ma = mr // 2
            mask_feats = dispatch_roi_align(feats[:4], out_boxes.contiguous(),
                                            strides, ma)
            with named_scope("maskrcnn"):
                mask_logits = self.maskrcnn(
                    mask_feats.reshape(b * d, ma, ma, -1))
            pick = classes.reshape(b * d, 1, 1, 1).expand(b * d, mr, mr, 1)
            sel_logits = torch.gather(mask_logits, 3, pick)
            out["masks"] = torch.sigmoid(sel_logits).reshape(b, d, mr, mr)
        return out
