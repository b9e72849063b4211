"""COCO-2017 dataset reader (no pycocotools dependency; a copy of
``eksml_tpu/data/coco.py``).  It imports no torch: ``load_image`` is the
target of the loader's ``spawn`` decode workers.

Parity target: TensorPack's ``dataset/register_coco`` + COCODetection
(external, container/Dockerfile:16-19), reading the directory layout the
reference stages onto the shared filesystem:
``<basedir>/{train2017,val2017}`` images and
``<basedir>/annotations/instances_{split}.json``
(eks-cluster/prepare-s3-bucket.sh:21-31, stage-data.yaml:30-36,
charts/maskrcnn/values.yaml:13,17-18).

Category ids are remapped to contiguous [1..80] exactly as pycocotools
consumers do (sorted by original id); class 0 is background.

Trust boundary: staged data is user-supplied bytes on a shared
filesystem, so nothing here may crash mid-epoch deep in a producer
thread.  Unknown ``category_id``s are skipped with a warning (or raise
in strict mode) instead of KeyError-ing, and :meth:`preflight` audits
the annotation file + a sampled file-existence probe up front
(``RESILIENCE.DATA.VALIDATE`` = off | warn | strict).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger(__name__)


def _valid_bbox(bbox) -> bool:
    """Four real numbers — element types are user-supplied too (a
    ``null`` in the JSON must not TypeError mid-epoch)."""
    return (isinstance(bbox, (list, tuple)) and len(bbox) == 4
            and all(isinstance(v, (int, float))
                    and not isinstance(v, bool) for v in bbox))


def _valid_image_entry(im: Dict) -> bool:
    """file_name present, height/width real positive numbers — a
    record cannot be built (or its path probed) without them."""
    return (bool(im.get("file_name"))
            and isinstance(im.get("file_name"), str)
            and all(isinstance(im.get(k), (int, float))
                    and not isinstance(im.get(k), bool)
                    and im.get(k) > 0 for k in ("height", "width")))


def _valid_segmentation(seg) -> bool:
    """None, an RLE dict, or polygons (flat even-length numeric lists,
    ≥3 points each) — anything else would crash the mask rasterizer
    deep in a decode thread."""
    if seg is None:
        return True
    if isinstance(seg, dict):
        return "counts" in seg and "size" in seg
    if isinstance(seg, (list, tuple)):
        return all(
            isinstance(p, (list, tuple)) and len(p) >= 6
            and len(p) % 2 == 0
            and all(isinstance(v, (int, float))
                    and not isinstance(v, bool) for v in p)
            for p in seg)
    return False


class CocoDataset:
    def __init__(self, basedir: str, split: str,
                 annotation_file: Optional[str] = None,
                 validate: str = "off", validate_sample: int = 64):
        assert validate in ("off", "warn", "strict"), validate
        self.basedir = basedir
        self.split = split
        self.strict = validate == "strict"
        self.image_dir = os.path.join(basedir, split)
        ann = annotation_file or os.path.join(
            basedir, "annotations", f"instances_{split}.json")
        with open(ann) as f:
            data = json.load(f)

        cats = sorted(data["categories"], key=lambda c: c["id"])
        # original id → contiguous [1..K]
        self.cat_id_to_class = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self.class_to_cat_id = {v: k for k, v in self.cat_id_to_class.items()}
        self.class_names = ["BG"] + [c["name"] for c in cats]

        self.images: Dict[int, Dict] = {im["id"]: im for im in data["images"]}
        anns_by_image: Dict[int, List[Dict]] = {}
        for a in data.get("annotations", []):
            anns_by_image.setdefault(a["image_id"], []).append(a)
        self.anns_by_image = anns_by_image
        self.image_ids = sorted(self.images.keys())
        self._warned_categories: set = set()
        # set by a preflight that found zero MALFORMED annotations:
        # record() then skips re-validating every bbox/segmentation
        # (the deep per-vertex scan is linear in total polygon
        # coordinates — worth paying once, not twice)
        self._anns_verified = False
        self._malformed_ann_count = 0

        if validate != "off":
            issues = self.preflight(sample_files=validate_sample)
            self._anns_verified = self._malformed_ann_count == 0
            if issues:
                msg = (f"{len(issues)} dataset issue(s) in {ann}:\n  "
                       + "\n  ".join(issues[:20])
                       + ("" if len(issues) <= 20 else
                          f"\n  … and {len(issues) - 20} more"))
                if self.strict:
                    raise ValueError(
                        msg + "\n(RESILIENCE.DATA.VALIDATE=strict; use "
                        "'warn' to train anyway — bad annotations are "
                        "dropped, unreadable images quarantine at load)")
                log.warning("%s", msg)

    def __len__(self) -> int:
        return len(self.image_ids)

    # -- preflight validation -----------------------------------------

    def preflight(self, sample_files: int = 64) -> List[str]:
        """Audit the annotation file before training starts: unknown
        categories, degenerate/missing fields, dangling image refs,
        and a deterministic sampled file-existence probe (catching a
        partially-staged image dir without stat-ing 118k files).
        Returns human-readable issue strings; raising is the caller's
        policy decision."""
        issues: List[str] = []
        malformed_anns = 0
        for iid, im in self.images.items():
            if not _valid_image_entry(im):
                issues.append(f"image {iid}: missing/invalid "
                              "file_name/height/width")
        unknown: Dict[int, int] = {}
        for iid, anns in self.anns_by_image.items():
            if iid not in self.images:
                issues.append(
                    f"annotations reference unknown image_id {iid}")
            for a in anns:
                cid = a.get("category_id")
                if cid not in self.cat_id_to_class:
                    unknown[cid] = unknown.get(cid, 0) + 1
                bbox = a.get("bbox")
                if not _valid_bbox(bbox):
                    issues.append(f"annotation {a.get('id')}: malformed "
                                  f"bbox {bbox!r}")
                    malformed_anns += 1
                elif bbox[2] <= 0 or bbox[3] <= 0:
                    # degenerate but well-typed: record()'s clipping
                    # drops it regardless, so it does not count against
                    # _anns_verified
                    issues.append(f"annotation {a.get('id')}: degenerate"
                                  f" bbox (w={bbox[2]}, h={bbox[3]})")
                if not _valid_segmentation(a.get("segmentation")):
                    issues.append(f"annotation {a.get('id')}: malformed "
                                  "segmentation")
                    malformed_anns += 1
        for cid, n in sorted(unknown.items(), key=lambda kv: str(kv[0])):
            issues.append(f"unknown category_id {cid!r} on {n} "
                          "annotation(s) (not in the categories table)")
        if sample_files > 0 and self.image_ids:
            # deterministic sample: evenly spaced over the sorted ids,
            # identical on every host — no RNG to disturb
            stride = max(1, len(self.image_ids) // sample_files)
            missing = 0
            probed = 0
            for iid in self.image_ids[::stride][:sample_files]:
                fn = self.images[iid].get("file_name")
                if not isinstance(fn, str) or not fn:
                    continue  # already reported as missing/invalid
                probed += 1
                path = os.path.join(self.image_dir, fn)
                if not os.path.exists(path):
                    missing += 1
                    if missing <= 5:
                        issues.append(f"image file missing: {path}")
            if missing:
                issues.append(
                    f"file-existence probe: {missing}/{probed} sampled "
                    f"images missing under {self.image_dir} — is the "
                    "dataset fully staged / the mount healthy?")
        # annotation-content verdict alone gates record()'s deep
        # re-validation skip — a missing image file says nothing about
        # whether the bboxes/polygons are well-formed
        self._malformed_ann_count = malformed_anns
        return issues

    # -- records ------------------------------------------------------

    def record(self, image_id: int, with_anns: bool = True) -> Dict:
        """One training record: path, size, boxes (xyxy), classes,
        iscrowd flags, raw segmentations."""
        im = self.images[image_id]
        if not _valid_image_entry(im):
            # records() skips these; a direct call gets one actionable
            # error instead of a KeyError/TypeError downstream
            raise ValueError(
                f"image {image_id}: missing/invalid file_name/height/"
                "width — cannot build a record (preflight reports "
                "these; records() skips them)")
        rec = {
            "image_id": image_id,
            "path": os.path.join(self.image_dir, im["file_name"]),
            "height": im["height"],
            "width": im["width"],
        }
        if not with_anns:
            return rec
        boxes, classes, iscrowd, segs, areas = [], [], [], [], []
        for a in self.anns_by_image.get(image_id, []):
            if a.get("ignore", 0):
                continue
            cid = a.get("category_id")
            cls = self.cat_id_to_class.get(cid)
            if cls is None:
                # user-supplied bytes: never KeyError mid-epoch in the
                # producer thread — skip-and-warn (once per category).
                # Strict mode already raised during __init__'s
                # preflight, which checks a superset of these guards.
                if cid not in self._warned_categories:
                    self._warned_categories.add(cid)
                    log.warning(
                        "skipping annotation(s) with unknown "
                        "category_id %r (first seen on image %s)",
                        cid, image_id)
                continue
            bbox = a.get("bbox")
            if not self._anns_verified and not _valid_bbox(bbox):
                # drop-and-continue, never crash mid-epoch
                log.warning("skipping annotation %s on image %s: "
                            "malformed bbox %r", a.get("id"), image_id,
                            bbox)
                continue
            seg = a.get("segmentation")
            if not self._anns_verified and not _valid_segmentation(seg):
                # a malformed polygon would crash the mask rasterizer
                # deep in a decode thread — same drop-and-continue
                log.warning("skipping annotation %s on image %s: "
                            "malformed segmentation", a.get("id"),
                            image_id)
                continue
            x, y, w, h = bbox
            x2 = min(x + w, im["width"])
            y2 = min(y + h, im["height"])
            x, y = max(x, 0), max(y, 0)
            if x2 <= x + 1e-3 or y2 <= y + 1e-3:
                continue
            boxes.append([x, y, x2, y2])
            classes.append(cls)
            iscrowd.append(a.get("iscrowd", 0))
            segs.append(a.get("segmentation"))
            # segmentation area, the quantity COCOeval buckets by
            areas.append(a.get("area", (x2 - x) * (y2 - y)))
        rec["boxes"] = np.asarray(boxes, np.float32).reshape(-1, 4)
        rec["classes"] = np.asarray(classes, np.int32)
        rec["iscrowd"] = np.asarray(iscrowd, np.int32)
        rec["segmentation"] = segs
        rec["area"] = np.asarray(areas, np.float64)
        return rec

    def records(self, with_anns: bool = True,
                skip_empty: bool = True) -> List[Dict]:
        out = []
        for iid in self.image_ids:
            try:  # record() owns the image-entry guard: validate once
                r = self.record(iid, with_anns)
            except ValueError as e:
                log.warning("skipping image %s: %s", iid, e)
                continue
            if with_anns and skip_empty and len(r["boxes"]) == 0:
                continue
            out.append(r)
        return out


def load_image(path: str) -> np.ndarray:
    """Decode an image file → uint8 RGB [H, W, 3].  PIL is imported here,
    at first use: an environment without it raises ``ImportError`` from
    the first read (which the robust reader lets propagate)."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))
