"""Mask-RCNN R50-FPN inference (``eksml_tpu/models/mask_rcnn.py``:
``_features``, ``_anchors``, ``_proposals``, ``predict``).

Static shapes as in the reference: every image yields
``TEST.RESULTS_PER_IM`` detection rows with a ``valid`` mask, so a
batch's shapes depend only on the canvas and the batch size.  Both
ROIAlign calls go through ``dispatch_roi_align`` — the CUDA kernel for
CUDA tensors.  This slice covers the non-cascade FrozenBN model in
float32; training, the cascade heads, GroupNorm and bfloat16 compute
come with later slices.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from eksml_tpu_torch.models.fpn import FPN
from eksml_tpu_torch.models.heads import BoxHead, MaskHead
from eksml_tpu_torch.models.resnet import ResNetBackbone
from eksml_tpu_torch.models.rpn import RPNHead, generate_proposals
from eksml_tpu_torch.ops.anchors import generate_fpn_anchors
from eksml_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from eksml_tpu_torch.ops.nms import class_aware_nms
from eksml_tpu_torch.ops.roi_align import dispatch_roi_align


class MaskRCNN(nn.Module):
    def __init__(self, num_classes: int = 81, with_masks: bool = True,
                 resnet_blocks: Sequence[int] = (3, 4, 6, 3),
                 fpn_channels: int = 256,
                 anchor_strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 rpn_nms_thresh: float = 0.7,
                 test_pre_nms_topk: int = 1000,
                 test_post_nms_topk: int = 1000,
                 bbox_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0),
                 fc_head_dim: int = 1024, mask_head_dim: int = 256,
                 mask_resolution: int = 28, test_nms_thresh: float = 0.5,
                 test_score_thresh: float = 0.05,
                 test_results_per_im: int = 100,
                 pixel_mean: Sequence[float] = (123.675, 116.28, 103.53),
                 pixel_std: Sequence[float] = (58.395, 57.12, 57.375)):
        super().__init__()
        self.num_classes = num_classes
        self.with_masks = with_masks
        self.anchor_strides = tuple(anchor_strides)
        self.anchor_sizes = tuple(anchor_sizes)
        self.anchor_ratios = tuple(anchor_ratios)
        self.rpn_nms_thresh = rpn_nms_thresh
        self.test_pre_nms_topk = test_pre_nms_topk
        self.test_post_nms_topk = test_post_nms_topk
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        self.mask_resolution = mask_resolution
        self.test_nms_thresh = test_nms_thresh
        self.test_score_thresh = test_score_thresh
        self.test_results_per_im = test_results_per_im

        self.backbone = ResNetBackbone(resnet_blocks)
        self.fpn = FPN(num_channels=fpn_channels)
        self.rpn = RPNHead(len(self.anchor_ratios), fpn_channels)
        self.fastrcnn = BoxHead(fpn_channels * 7 * 7, num_classes,
                                fc_head_dim)
        if with_masks:
            self.maskrcnn = MaskHead(fpn_channels, num_classes,
                                     mask_head_dim)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std),
                             persistent=False)
        self._anchor_cache: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}

    @classmethod
    def from_config(cls, cfg) -> "MaskRCNN":
        unsupported = {
            "MODE_CASCADE": bool(cfg.MODE_CASCADE),
            "BACKBONE.NORM": cfg.BACKBONE.NORM != "FreezeBN",
            "TRAIN.PRECISION": cfg.TRAIN.PRECISION != "float32",
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"{', '.join(bad)}: this slice of the port runs the "
                "non-cascade FrozenBN model in float32 (ROADMAP.md "
                "Queue 1 lists the variants)")
        return cls(
            num_classes=cfg.DATA.NUM_CLASSES,
            with_masks=cfg.MODE_MASK,
            resnet_blocks=tuple(cfg.BACKBONE.RESNET_NUM_BLOCKS),
            fpn_channels=cfg.FPN.NUM_CHANNEL,
            anchor_strides=tuple(cfg.FPN.ANCHOR_STRIDES),
            anchor_sizes=tuple(cfg.RPN.ANCHOR_SIZES),
            anchor_ratios=tuple(cfg.RPN.ANCHOR_RATIOS),
            rpn_nms_thresh=cfg.RPN.PROPOSAL_NMS_THRESH,
            test_pre_nms_topk=cfg.RPN.TEST_PRE_NMS_TOPK,
            test_post_nms_topk=cfg.RPN.TEST_POST_NMS_TOPK,
            bbox_reg_weights=tuple(cfg.FRCNN.BBOX_REG_WEIGHTS),
            fc_head_dim=cfg.FPN.FRCNN_FC_HEAD_DIM,
            mask_head_dim=cfg.MRCNN.HEAD_DIM,
            mask_resolution=cfg.MRCNN.RESOLUTION,
            test_nms_thresh=cfg.TEST.FRCNN_NMS_THRESH,
            test_score_thresh=cfg.TEST.RESULT_SCORE_THRESH,
            test_results_per_im=cfg.TEST.RESULTS_PER_IM,
            pixel_mean=tuple(cfg.PREPROC.PIXEL_MEAN),
            pixel_std=tuple(cfg.PREPROC.PIXEL_STD),
        )

    # ---- shared trunk ------------------------------------------------

    def _features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """NHWC images → P2..P6 NHWC.  uint8 input is normalized here in
        float32 (PREPROC.DEVICE_NORMALIZE); float input is taken as
        already normalized."""
        x = images
        if x.dtype == torch.uint8:
            x = (x.float() - self.pixel_mean) / self.pixel_std
        return self.fpn(self.backbone(x.float()))

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
        rpn_logits, rpn_deltas = self.rpn(feats)
        anchors = self._anchors((H, W), images.device)
        prop_boxes, prop_scores = self._proposals(
            rpn_logits, rpn_deltas, anchors, image_hw,
            self.test_pre_nms_topk, self.test_post_nms_topk)
        p = prop_boxes.shape[1]
        d = self.test_results_per_im
        strides = self.anchor_strides[:4]

        roi_feats = dispatch_roi_align(feats[:4], prop_boxes, strides, 7)
        logits, deltas = self.fastrcnn(roi_feats.reshape(b * p, 7, 7, -1))
        probs = torch.softmax(logits, dim=-1).reshape(b, p, -1)
        deltas = deltas.reshape(b, p, self.num_classes, 4)

        # best foreground class per proposal and its own deltas
        score, cls = probs[..., 1:].max(dim=-1)
        cls = cls + 1
        sel = torch.gather(deltas, 2,
                           cls[:, :, None, None].expand(b, p, 1, 4))[:, :, 0]
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
            mask_logits = self.maskrcnn(
                mask_feats.reshape(b * d, ma, ma, -1))
            pick = classes.reshape(b * d, 1, 1, 1).expand(b * d, mr, mr, 1)
            sel_logits = torch.gather(mask_logits, 3, pick)
            out["masks"] = torch.sigmoid(sel_logits).reshape(b, d, mr, mr)
        return out
