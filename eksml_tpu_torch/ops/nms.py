"""Fixed-shape greedy NMS (``eksml_tpu/ops/nms.py``).

Same formulation as the reference: a keep *mask* over a fixed K boxes
(padding rows carry score ``-inf``), computed by walking score-sorted
tiles; inside a tile the synchronous fixed point

    keep_i ← alive_i ∧ ¬∃j: rank_j < rank_i ∧ IoU(j, i) > t ∧ keep_j

iterates until unchanged.  Every function takes any number of leading
batch dims: the reference vmaps one image (and one FPN level) at a time,
while here all of them iterate together.  The fixed point is idempotent
once reached, so a batch member that converged early is unchanged by
the extra sweeps and the result equals per-member NMS.  Each sweep reads
one "anything changed" flag on the host — one device sync per sweep.
"""

from __future__ import annotations

import torch

from eksml_tpu_torch.ops.boxes import pairwise_iou
from eksml_tpu_torch.profiling.scopes import named_scope

NMS_TILE = 256


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order, ties broken toward the LOWER index (a stable
    descending sort; ``torch.topk`` promises no tie order, and ``-inf``
    padding rows are exactly such ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _scatter_back(order: torch.Tensor, keep_sorted: torch.Tensor):
    """``zeros.at[order].set(keep_sorted)``: rank order → input order."""
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


# "nms" scope → the rpn-nms attribution component (SCOPE_RULES)
@named_scope("nms")
def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float, tile: int = NMS_TILE) -> torch.Tensor:
    """Greedy NMS keep-mask for boxes ``[..., K, 4]`` (any order) →
    bool ``[..., K]`` in the input order.  Padding entries (score
    ``-inf``) neither keep nor suppress."""
    if tile <= 0:
        raise ValueError(f"NMS tile size must be positive, got {tile}")
    k = boxes.shape[-2]
    lead = boxes.shape[:-2]
    order = torch.argsort(-scores, dim=-1, stable=True)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    sscores = torch.gather(scores, -1, order)
    pad = (-k) % tile
    if pad:
        # zero-area padding boxes with -inf scores: IoU 0 against
        # everything, not finite — they neither keep nor suppress
        sboxes = torch.cat([sboxes, sboxes.new_zeros(*lead, pad, 4)], -2)
        sscores = torch.cat(
            [sscores, sscores.new_full((*lead, pad), float("-inf"))], -1)
    kp = k + pad
    svalid = torch.isfinite(sscores)
    rank_t = torch.arange(tile, device=boxes.device)
    # before[j, i]: j ranks before i inside the tile
    before = rank_t[:, None] < rank_t[None, :]
    keep = torch.zeros_like(svalid)
    for t0 in range(0, kp, tile):
        rows = sboxes[..., t0:t0 + tile, :]
        iou_tk = pairwise_iou(rows, sboxes[..., :t0 + tile, :])
        alive = svalid[..., t0:t0 + tile]
        if t0:
            # suppression by FINAL keeps of earlier tiles
            sup_prev = (iou_tk[..., :t0] > iou_threshold) \
                & keep[..., None, :t0]
            alive = alive & ~sup_prev.any(-1)
        sup = (iou_tk[..., t0:t0 + tile] > iou_threshold) & before
        cur = alive
        prv = torch.zeros_like(alive)
        it = 0
        while it < tile and bool((cur != prv).any()):
            new = alive & ~(sup & cur[..., :, None]).any(-2)
            prv, cur = cur, new
            it += 1
        keep[..., t0:t0 + tile] = cur
    return _scatter_back(order, keep[..., :k])


def nms_mask_sequential(boxes: torch.Tensor, scores: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """The textbook K-step greedy recurrence over one ``[K, 4]`` set;
    kept to cross-check :func:`nms_mask`."""
    k = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    sboxes = boxes[order]
    keep = torch.isfinite(scores[order])
    iou = pairwise_iou(sboxes, sboxes)
    later = torch.arange(k, device=boxes.device)
    for i in range(k):
        suppress = (iou[i] > iou_threshold) & (later > i) & keep[i]
        keep = keep & ~suppress
    return _scatter_back(order, keep)


def _topk_nms(boxes, scores, iou_threshold: float, max_outputs: int):
    """NMS, then the ``max_outputs`` best kept boxes: ``(indices,
    scores, valid)``, each ``[..., max_outputs]``; invalid slots score
    ``-inf``."""
    keep = nms_mask(boxes, scores, iou_threshold)
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_scores, idx = top_k(masked, max_outputs)
    return idx, top_scores, torch.isfinite(top_scores)


@named_scope("nms")
def class_aware_nms(boxes, scores, iou_threshold: float, max_outputs: int,
                    class_ids=None):
    """Per-class NMS via the coordinate-offset trick: each class's boxes
    shift to a disjoint region so one class never suppresses another.
    The offset stride is ``max coordinate + 1`` of each set (torchvision's
    rule; the reference takes it per image under vmap)."""
    if class_ids is not None:
        stride = boxes.amax(dim=(-2, -1), keepdim=True) + 1.0
        boxes = boxes + class_ids.to(boxes.dtype)[..., None] * stride
    return _topk_nms(boxes, scores, iou_threshold, max_outputs)
