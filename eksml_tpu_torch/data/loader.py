"""Host-side data (numpy copy of parts of ``eksml_tpu/data/loader.py``):
image resize/pad and bucket assignment for serving, and for training
``SyntheticDataset``, an in-memory ``DetectionLoader`` and
``make_synthetic_batch``.  For the same records, config and seed the
loader yields byte-identical batches to the reference's.

The loader reads records that hold their decoded image (``_image``),
pads every image to the square ``PREPROC.MAX_SIZE`` canvas and builds
batches in the calling thread: the reference's robust file reads,
quarantine, decode pools, prefetch thread and aspect-ratio buckets
(``PREPROC.BUCKETS``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from eksml_tpu_torch.data.masks import polygons_to_bbox_mask, rle_decode


def quantize_uint8(image_f: np.ndarray) -> np.ndarray:
    """Resized float image → raw uint8 bytes for device-side
    normalization (PREPROC.DEVICE_NORMALIZE)."""
    return np.clip(np.round(image_f), 0, 255).astype(np.uint8)


def _resized_hw(h: int, w: int, short_edge: int, max_size: int):
    """(scale, nh, nw) of the standard resize: short edge to
    ``short_edge``, long edge capped at ``max_size``."""
    scale = short_edge / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    return scale, int(round(h * scale)), int(round(w * scale))


def resize_and_pad(image: np.ndarray, short_edge: int, max_size: int,
                   pad_hw: Optional[Tuple[int, int]] = None):
    """Resize keeping aspect (short edge to ``short_edge``, long edge
    capped at ``max_size``), then zero-pad bottom/right to ``pad_hw``
    (default the square ``(max_size, max_size)``).  A ``pad_hw`` tighter
    than the standard resize scales the image further down to fit
    (force-fit).

    Returns (padded float32 image, scale, (new_h, new_w))."""
    h, w = image.shape[:2]
    scale, nh, nw = _resized_hw(h, w, short_edge, max_size)
    pad_h, pad_w = pad_hw or (max_size, max_size)
    if scale > min(pad_h / h, pad_w / w):  # force-fit: shrink more
        scale = min(pad_h / h, pad_w / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
    nh, nw = min(nh, pad_h), min(nw, pad_w)  # rounding guard
    resized = _bilinear_resize(image.astype(np.float32), nh, nw)
    out = np.zeros((pad_h, pad_w, image.shape[2]), np.float32)
    out[:nh, :nw] = resized
    return out, scale, (nh, nw)


def assign_bucket(h: int, w: int, short_edge: int, max_size: int,
                  buckets) -> int:
    """Index of the smallest-area bucket (``buckets`` sorted by area)
    that holds ``(h, w)`` resized at ``short_edge``; the largest bucket
    (force-fit) if none does."""
    _, nh, nw = _resized_hw(h, w, short_edge, max_size)
    for i, (bh, bw) in enumerate(buckets):
        if nh <= bh and nw <= bw:
            return i
    return len(buckets) - 1


def _bilinear_resize(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Separable bilinear resize with half-pixel sampling: blend rows,
    then columns."""
    h, w = img.shape[:2]
    yy = (np.arange(nh) + 0.5) * h / nh - 0.5
    xx = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(yy).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xx).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    ly = np.clip(yy - y0, 0, 1).astype(img.dtype)[:, None, None]
    lx = np.clip(xx - x0, 0, 1).astype(img.dtype)[None, :, None]
    rows = img[y0] * (1 - ly) + img[y1] * ly          # [nh, w, C]
    return rows[:, x0] * (1 - lx) + rows[:, x1] * lx  # [nh, nw, C]


class SyntheticDataset:
    """Seeded records with random boxes, classes and uint8 images (no
    segmentation: each GT mask is its full box)."""

    def __init__(self, num_images: int = 64, height: int = 320,
                 width: int = 320, max_boxes: int = 8, num_classes: int = 81,
                 seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self._records = []
        for i in range(num_images):
            n = self.rng.randint(1, max_boxes + 1)
            xy = self.rng.rand(n, 2) * np.array([width, height]) * 0.6
            wh = self.rng.rand(n, 2) * np.array([width, height]) * 0.3 + 8
            boxes = np.concatenate(
                [xy, np.minimum(xy + wh, [width - 1, height - 1])], axis=1)
            self._records.append({
                "image_id": i,
                "path": None,
                "height": height, "width": width,
                "boxes": boxes.astype(np.float32),
                "classes": self.rng.randint(1, num_classes, n)
                .astype(np.int32),
                "iscrowd": np.zeros(n, np.int32),
                "segmentation": [None] * n,
                "_image": self.rng.randint(
                    0, 255, (height, width, 3)).astype(np.uint8),
            })

    def records(self, with_anns: bool = True, skip_empty: bool = True):
        return list(self._records)


class DetectionLoader:
    """Fixed-shape training batches over (a shard of) in-memory records:
    random short edge in ``PREPROC.TRAIN_SHORT_EDGE_SIZE``, random
    horizontal flip, square ``PREPROC.MAX_SIZE`` canvas, GT padded to
    ``DATA.MAX_GT_BOXES`` (crowds last), bbox-cropped GT masks of
    ``gt_mask_size``²."""

    def __init__(self, records: List[Dict], cfg, batch_size: int,
                 is_training: bool = True, num_hosts: int = 1,
                 host_id: int = 0, seed: int = 0, with_masks: bool = True,
                 gt_mask_size: int = 56):
        if not records:
            raise ValueError("empty dataset")
        if tuple(getattr(cfg.PREPROC, "BUCKETS", ()) or ()) and is_training:
            raise NotImplementedError(
                "PREPROC.BUCKETS: the port's loader pads to the square "
                "PREPROC.MAX_SIZE canvas only (ROADMAP.md Queue 1)")
        self.records = records[host_id::num_hosts] or records[:1]
        for rec in self.records:
            if rec.get("_image") is None:
                raise NotImplementedError(
                    f"record {rec.get('image_id')}: the port's loader takes "
                    "records that hold their decoded image ('_image')")
        self.cfg = cfg
        self.batch_size = batch_size
        self.is_training = is_training
        self.rng = np.random.RandomState(seed + host_id)
        self.with_masks = with_masks
        self.gt_mask_size = gt_mask_size
        self.mean = np.asarray(cfg.PREPROC.PIXEL_MEAN, np.float32)
        self.std = np.asarray(cfg.PREPROC.PIXEL_STD, np.float32)
        self.device_normalize = bool(
            getattr(cfg.PREPROC, "DEVICE_NORMALIZE", False))
        self.max_gt = cfg.DATA.MAX_GT_BOXES
        self._order = np.arange(len(self.records))
        self._pos = 0

    def _draw(self):
        """Per-example random short edge and flip."""
        short_edges = self.cfg.PREPROC.TRAIN_SHORT_EDGE_SIZE \
            if self.is_training \
            else (self.cfg.PREPROC.TEST_SHORT_EDGE_SIZE,) * 2
        short = int(self.rng.randint(min(short_edges), max(short_edges) + 1))
        do_flip = self.is_training and bool(self.rng.rand() < 0.5)
        return short, do_flip

    def _load_example(self, rec: Dict, short: int,
                      do_flip: bool) -> Dict[str, np.ndarray]:
        image = rec["_image"]
        boxes = rec["boxes"].copy()
        classes = rec["classes"]
        # crowd boxes are kept as ignore regions; non-crowd first so the
        # MAX_GT truncation drops crowds first
        crowd = rec["iscrowd"].astype(np.float32)
        order = np.argsort(crowd, kind="stable")
        boxes, classes, crowd = boxes[order], classes[order], crowd[order]
        segs = [rec["segmentation"][i] for i in order]

        image_f, scale, (nh, nw) = resize_and_pad(
            image, short, self.cfg.PREPROC.MAX_SIZE)
        boxes = boxes * scale
        flipped = bool(do_flip)
        if flipped:
            image_f[:, :nw] = image_f[:, :nw][:, ::-1]
            x1 = nw - boxes[:, 2]
            x2 = nw - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)
        if self.device_normalize:
            image_f = quantize_uint8(image_f)
        else:
            image_f = (image_f - self.mean) / self.std

        g = self.max_gt
        n = min(len(boxes), g)
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_classes = np.zeros((g,), np.int32)
        gt_valid = np.zeros((g,), np.float32)
        gt_crowd = np.zeros((g,), np.float32)
        gt_boxes[:n] = boxes[:n]
        gt_classes[:n] = classes[:n]
        gt_valid[:n] = 1.0
        gt_crowd[:n] = crowd[:n]
        ex = {
            "images": image_f,
            "image_hw": np.asarray([nh, nw], np.float32),
            "image_scale": np.float32(scale),
            "image_id": np.int64(rec["image_id"]),
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "gt_crowd": gt_crowd,
        }
        if self.with_masks:
            ms = self.gt_mask_size
            gt_masks = np.zeros((g, ms, ms), np.float32)
            for i in range(n):
                if crowd[i]:
                    continue  # crowds are never mask-training targets
                gt_masks[i] = self._seg_to_crop(
                    segs[i], rec, boxes[i] / scale, flipped, nw / scale)
            ex["gt_masks"] = gt_masks
        return ex

    def _seg_to_crop(self, seg, rec, box, flipped, orig_w):
        """Segmentation → bbox-cropped binary mask.  ``box`` is the GT box
        at the original resolution, already mirrored when ``flipped``,
        so the segmentation is mirrored about ``orig_w`` to match."""
        ms = self.gt_mask_size
        if seg is None:
            return np.ones((ms, ms), np.float32)  # synthetic: full box
        if isinstance(seg, dict):  # RLE
            full = rle_decode(seg, rec["height"], rec["width"])
            if flipped:
                full = full[:, ::-1]
            m = _crop_resize_binary(full, box, ms)
        else:
            if flipped:
                polys = [np.asarray(p, np.float64).reshape(-1, 2)
                         for p in seg]
                seg = [np.stack([orig_w - p[:, 0], p[:, 1]], 1).reshape(-1)
                       for p in polys]
            m = polygons_to_bbox_mask(seg, box, ms)
        return m.astype(np.float32)

    def _next_indices(self) -> List[int]:
        out = []
        for _ in range(self.batch_size):
            if self._pos == 0 and self.is_training:
                self.rng.shuffle(self._order)
            out.append(self._order[self._pos])
            self._pos = (self._pos + 1) % len(self._order)
        return out

    def batches(self, num_steps: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield ``num_steps`` batches (wrapping around the records;
        endless if None)."""
        produced = 0
        while num_steps is None or produced < num_steps:
            idx = self._next_indices()
            draws = [self._draw() for _ in idx]
            exs = [self._load_example(self.records[i], s, f)
                   for i, (s, f) in zip(idx, draws)]
            yield {k: np.stack([e[k] for e in exs]) for k in exs[0]}
            produced += 1


def _crop_resize_binary(mask: np.ndarray, box, out_size: int) -> np.ndarray:
    x1, y1, x2, y2 = box
    h, w = mask.shape
    ys = np.clip(((np.arange(out_size) + 0.5) / out_size * (y2 - y1) + y1)
                 .astype(int), 0, h - 1)
    xs = np.clip(((np.arange(out_size) + 0.5) / out_size * (x2 - x1) + x1)
                 .astype(int), 0, w - 1)
    return mask[np.ix_(ys, xs)]


def make_synthetic_batch(cfg, batch_size: int = 1, image_size: int = 256,
                         seed: int = 0, with_masks: bool = True,
                         gt_mask_size: int = 56) -> Dict[str, np.ndarray]:
    """One fixed batch on a square ``image_size`` canvas, for tests."""
    ds = SyntheticDataset(num_images=batch_size * 2, height=image_size,
                          width=image_size,
                          num_classes=cfg.DATA.NUM_CLASSES, seed=seed)
    saved = (cfg.PREPROC.MAX_SIZE, cfg.PREPROC.TRAIN_SHORT_EDGE_SIZE,
             cfg.PREPROC.BUCKETS)
    cfg.freeze(False)
    cfg.PREPROC.MAX_SIZE = image_size
    cfg.PREPROC.TRAIN_SHORT_EDGE_SIZE = (image_size, image_size)
    cfg.PREPROC.BUCKETS = ()
    try:
        loader = DetectionLoader(ds.records(), cfg, batch_size,
                                 with_masks=with_masks, seed=seed,
                                 gt_mask_size=gt_mask_size)
        return next(iter(loader.batches(1)))
    finally:
        (cfg.PREPROC.MAX_SIZE, cfg.PREPROC.TRAIN_SHORT_EDGE_SIZE,
         cfg.PREPROC.BUCKETS) = saved
        cfg.freeze()
