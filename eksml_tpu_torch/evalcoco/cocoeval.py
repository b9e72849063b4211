"""COCOeval-semantics mAP computation in vectorized numpy (a copy of
``eksml_tpu/evalcoco/cocoeval.py``).

Implements the evaluation protocol of COCO's official toolkit (the
C/Cython pycocotools the reference images install,
container/Dockerfile:12): per-(image, category) greedy matching of
score-sorted detections to GT at IoU thresholds 0.50:0.05:0.95, crowd
GT as ignore regions (IoF overlap), area-range filtering, then
accumulation into 101-point interpolated precision and the standard
metric set (AP, AP50, AP75, APs/m/l, AR@100).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRESHS = np.linspace(0.5, 0.95, 10)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
# official areaRng values; the in-range test is INCLUSIVE of the upper
# bound (lo <= area <= hi), matching COCOeval's
# ``area < aRng[0] or area > aRng[1]`` ignore predicate
AREA_RANGES = {
    "all": (0.0, 1e5 ** 2),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e5 ** 2),
}


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray,
                 gt_crowd: np.ndarray) -> np.ndarray:
    """IoU matrix [D, G] for xywh boxes; crowd GT uses IoF
    (intersection over detection area), per COCO convention."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float64)
    d = dets[:, None, :]
    g = gts[None, :, :]
    ix = (np.minimum(d[..., 0] + d[..., 2], g[..., 0] + g[..., 2])
          - np.maximum(d[..., 0], g[..., 0])).clip(min=0)
    iy = (np.minimum(d[..., 1] + d[..., 3], g[..., 1] + g[..., 3])
          - np.maximum(d[..., 1], g[..., 1])).clip(min=0)
    inter = ix * iy
    area_d = (d[..., 2] * d[..., 3])
    area_g = (g[..., 2] * g[..., 3])
    union = np.where(gt_crowd[None, :] > 0, area_d,
                     area_d + area_g - inter)
    return np.where(union > 0, inter / union, 0.0)


def mask_iou(det_masks: Sequence, gt_masks: Sequence,
             gt_crowd: np.ndarray) -> np.ndarray:
    """IoU matrix for binary masks.  Accepts dense [H, W] arrays or COCO
    RLE dicts ({'size': [h, w], 'counts': [...]}); RLE stays compressed
    end-to-end through the C++ path (evalcoco/native_src/maskops.cc),
    the format pycocotools' C extension works in."""
    if len(det_masks) == 0 or len(gt_masks) == 0:
        return np.zeros((len(det_masks), len(gt_masks)), np.float64)
    if isinstance(det_masks[0], dict) or isinstance(gt_masks[0], dict):
        from eksml_tpu_torch.evalcoco.native import rle_iou_masks

        return rle_iou_masks(det_masks, gt_masks, gt_crowd)
    from eksml_tpu_torch.evalcoco.native import mask_iou_native

    out = mask_iou_native(det_masks, gt_masks, gt_crowd)
    if out is not None:
        return out
    d_n, g_n = len(det_masks), len(gt_masks)
    ious = np.zeros((d_n, g_n), np.float64)
    for j in range(g_n):
        g = gt_masks[j].astype(bool)
        ga = g.sum()
        for i in range(d_n):
            d = det_masks[i].astype(bool)
            inter = np.logical_and(d, g).sum()
            if gt_crowd[j]:
                union = d.sum()
            else:
                union = d.sum() + ga - inter
            ious[i, j] = inter / union if union > 0 else 0.0
    return ious


def _mask_area(m) -> float:
    """Area of one detection mask: foreground pixel count, accepting
    dense [H, W] arrays or uncompressed COCO RLE dicts (counts
    alternate background/foreground runs starting with background)."""
    if isinstance(m, dict):
        counts = m["counts"]
        return float(sum(counts[1::2]))
    return float(np.asarray(m).astype(bool).sum())


class COCOEvaluator:
    """Accumulates detections against a ground-truth record list.

    ``gt_records``: list of dicts with image_id, boxes (xyxy, original
    image coordinates), classes, iscrowd, areas, and (for segm)
    full-image binary masks or callables producing them.
    """

    def __init__(self, gt_records: List[Dict], num_classes: int,
                 iou_type: str = "bbox", max_dets: int = 100):
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type
        self.max_dets = max_dets
        self.num_classes = num_classes
        # index GT per (image, class)
        self.gt: Dict = {}
        self.image_ids = []
        for rec in gt_records:
            iid = rec["image_id"]
            self.image_ids.append(iid)
            boxes = np.asarray(rec["boxes"], np.float64).reshape(-1, 4)
            xywh = np.stack([boxes[:, 0], boxes[:, 1],
                             boxes[:, 2] - boxes[:, 0],
                             boxes[:, 3] - boxes[:, 1]], axis=1)
            classes = np.asarray(rec["classes"], np.int64)
            crowd = np.asarray(rec.get("iscrowd",
                                       np.zeros(len(classes))), np.int64)
            areas = np.asarray(rec.get(
                "areas", xywh[:, 2] * xywh[:, 3]), np.float64)
            masks = rec.get("masks")
            for c in np.unique(classes):
                sel = classes == c
                entry = {
                    "xywh": xywh[sel], "crowd": crowd[sel],
                    "area": areas[sel],
                    "masks": ([masks[i] for i in np.nonzero(sel)[0]]
                              if masks is not None else None),
                }
                self.gt[(iid, int(c))] = entry
        self.dets: Dict = {}

    def add_detections(self, image_id: int, boxes_xyxy: np.ndarray,
                       scores: np.ndarray, classes: np.ndarray,
                       masks: Optional[Sequence] = None) -> None:
        """Register predictions for one image (original coordinates)."""
        boxes_xyxy = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
        xywh = np.stack([boxes_xyxy[:, 0], boxes_xyxy[:, 1],
                         boxes_xyxy[:, 2] - boxes_xyxy[:, 0],
                         boxes_xyxy[:, 3] - boxes_xyxy[:, 1]], axis=1)
        scores = np.asarray(scores, np.float64)
        classes = np.asarray(classes, np.int64)
        for c in np.unique(classes):
            sel = classes == c
            entry = self.dets.setdefault((image_id, int(c)),
                                         {"xywh": [], "score": [],
                                          "masks": []})
            entry["xywh"].append(xywh[sel])
            entry["score"].append(scores[sel])
            if masks is not None:
                entry["masks"].extend(
                    [masks[i] for i in np.nonzero(sel)[0]])

    # -- the match/accumulate pipeline --------------------------------

    def _pair_ious(self, iid: int, cls: int):
        """IoU matrix + sorted det/gt data for one (image, class) —
        range-independent, computed ONCE and reused by every area
        range's matching pass (official COCOeval computes IoUs in
        computeIoU, separate from the per-range evaluateImg)."""
        g = self.gt.get((iid, cls))
        d = self.dets.get((iid, cls))
        if g is None and d is None:
            return None
        g_xywh = g["xywh"] if g else np.zeros((0, 4))
        g_crowd = g["crowd"] if g else np.zeros((0,), np.int64)
        g_area = g["area"] if g else np.zeros((0,))
        if d:
            d_xywh = np.concatenate(d["xywh"])
            d_score = np.concatenate(d["score"])
        else:
            d_xywh = np.zeros((0, 4))
            d_score = np.zeros((0,))
        order = np.argsort(-d_score, kind="mergesort")[: self.max_dets]
        d_xywh, d_score = d_xywh[order], d_score[order]

        if self.iou_type == "bbox":
            ious = box_iou_xywh(d_xywh, g_xywh, g_crowd)
            d_area = d_xywh[:, 2] * d_xywh[:, 3]
        else:
            d_masks = [d["masks"][i] for i in order] if d else []
            ious = mask_iou(d_masks, g["masks"] if g else [], g_crowd)
            # official: a segm detection's area is its MASK area
            d_area = np.asarray([_mask_area(m) for m in d_masks],
                                np.float64)
        return {
            "ious": ious, "score": d_score, "dt_area": d_area,
            "gt_area": g_area, "gt_crowd": g_crowd.astype(bool),
        }

    def _evaluate_pair(self, pair, lo: float, hi: float):
        """The official evaluateImg for one (image, class, area range):
        gt ignore = crowd OR area outside [lo, hi] (inclusive hi), gt
        visited ignored-LAST, matching prefers unignored gt (the scan
        breaks at the first ignored gt once an unignored match is
        held), crowd gt may absorb multiple detections, and unmatched
        out-of-range detections are ignored.  Matching once globally
        and reclassifying per range skews range-restricted
        metrics: a det whose best global match is out-of-range would
        have matched a different, in-range gt here (cross-validated
        against tests/coco_oracle.py)."""
        ious = pair["ious"]
        g_crowd = pair["gt_crowd"]
        g_area = pair["gt_area"]
        g_ignore = g_crowd | (g_area < lo) | (g_area > hi)
        g_order = np.argsort(g_ignore, kind="mergesort")

        T = len(IOU_THRESHS)
        D, G = ious.shape
        native = None
        if D and G:
            from eksml_tpu_torch.evalcoco.native import greedy_match_native

            native = greedy_match_native(ious, g_crowd, g_ignore,
                                         g_order, IOU_THRESHS)
        if native is not None:
            dt_match, dt_ignore, gt_match = native
        else:
            dt_match = np.zeros((T, D), np.int64) - 1   # matched gt idx
            dt_ignore = np.zeros((T, D), bool)          # matched ignored
            gt_match = np.zeros((T, G), bool)
            for t, thr in enumerate(IOU_THRESHS):
                for di in range(D):
                    best = min(thr, 1 - 1e-10)
                    best_g = -1
                    for gj in g_order:
                        if gt_match[t, gj] and not g_crowd[gj]:
                            continue
                        # unignored match held; stop at ignored gt
                        if (best_g > -1 and not g_ignore[best_g]
                                and g_ignore[gj]):
                            break
                        if ious[di, gj] < best:
                            continue
                        best = ious[di, gj]
                        best_g = gj
                    if best_g >= 0:
                        dt_match[t, di] = best_g
                        dt_ignore[t, di] = bool(g_ignore[best_g])
                        if not g_crowd[best_g]:
                            gt_match[t, best_g] = True
        d_out = (pair["dt_area"] < lo) | (pair["dt_area"] > hi)
        dt_ignore = dt_ignore | ((dt_match < 0) & d_out[None, :])
        return {
            "score": pair["score"],
            "matched": dt_match >= 0,
            "ignore": dt_ignore,
            "npig": int((~g_ignore).sum()),
        }

    def accumulate(self) -> Dict[str, float]:
        classes = sorted({c for (_, c) in
                          list(self.gt.keys()) + list(self.dets.keys())})
        image_ids = sorted(set(self.image_ids))
        T = len(IOU_THRESHS)
        results = {}
        # IoUs once per (image, class); matching per area range below
        pair_ious = {}
        for c in classes:
            for iid in image_ids:
                p = self._pair_ious(iid, c)
                if p is not None:
                    pair_ious[(iid, c)] = p

        for range_name, (lo, hi) in AREA_RANGES.items():
            ap_per_class = []
            ar_per_class = []
            for c in classes:
                scores, matched, ignored = [], [], []
                n_gt = 0
                for iid in image_ids:
                    p = pair_ious.get((iid, c))
                    if p is None:
                        continue
                    r = self._evaluate_pair(p, lo, hi)
                    n_gt += r["npig"]
                    scores.append(r["score"])
                    matched.append(r["matched"])
                    ignored.append(r["ignore"])
                if n_gt == 0:
                    continue
                if scores:
                    sc = np.concatenate(scores)
                    order = np.argsort(-sc, kind="mergesort")
                    m = np.concatenate(matched, axis=1)[:, order]
                    ig = np.concatenate(ignored, axis=1)[:, order]
                else:
                    m = np.zeros((T, 0), bool)
                    ig = np.zeros((T, 0), bool)
                ap_t, ar_t = [], []
                for t in range(T):
                    # a det matched to an IGNORED gt is excluded
                    # entirely (neither TP nor FP), per official tps/fps
                    keep = ~ig[t]
                    tp = np.cumsum(m[t][keep])
                    fp = np.cumsum(~m[t][keep])
                    if len(tp) == 0:  # GT exists, no detections kept
                        ap_t.append(0.0)
                        ar_t.append(0.0)
                        continue
                    rec = tp / n_gt
                    prec = tp / (tp + fp + np.spacing(1))
                    # monotone non-increasing interpolation
                    for i in range(len(prec) - 1, 0, -1):
                        prec[i - 1] = max(prec[i - 1], prec[i])
                    idx = np.searchsorted(rec, RECALL_POINTS, side="left")
                    p101 = np.where(idx < len(prec),
                                    prec[np.clip(idx, 0, max(len(prec) - 1,
                                                             0))], 0.0)
                    ap_t.append(p101.mean() if len(prec) else 0.0)
                    ar_t.append(rec[-1] if len(rec) else 0.0)
                ap_per_class.append(ap_t)
                ar_per_class.append(ar_t)
            if ap_per_class:
                ap = np.asarray(ap_per_class)  # [C, T]
                ar = np.asarray(ar_per_class)
                results[f"AP_{range_name}"] = float(ap.mean())
                results[f"AR_{range_name}"] = float(ar.mean())
                if range_name == "all":
                    results["AP"] = float(ap.mean())
                    results["AP50"] = float(ap[:, 0].mean())
                    results["AP75"] = float(ap[:, 5].mean())
            else:
                results[f"AP_{range_name}"] = -1.0
                results[f"AR_{range_name}"] = -1.0
        for k in ("AP", "AP50", "AP75"):
            results.setdefault(k, -1.0)
        return results
