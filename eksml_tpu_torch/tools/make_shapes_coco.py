"""A learnable COCO-format dataset of geometric shapes (the port's copy of
``tools/make_shapes_coco.py``): solid shapes on textured backgrounds,
each with its exact polygon mask, so that class identity follows
appearance and a detector that learns anything reaches nonzero AP within
a few hundred steps:

  class 1 "box":   axis-aligned warm-coloured rectangle
  class 2 "blob":  cool-coloured ellipse (a 16-gon)
  class 3 "wedge": green-ish triangle

The random stream, its order, the ids, the file names, the boxes and the
area formula are the reference's, so the annotation JSON is the
reference's byte for byte.  The pixels differ in one place: each shape
is drawn with the port's ``data/masks.polygon_fill``, which fills a
triangle, where the reference's fills a polygon of an odd vertex count
inside out (a wedge there paints the whole canvas but its triangle).

The layout is the staged-data contract (``train2017/``, ``val2017/``,
``annotations/``).  :func:`make_split` writes the annotation JSON, the
JPEGs where PIL imports, and returns the split as the port's records,
each carrying its pixels on ``_image`` (the loader and the evaluator
read them there, so no JPEG is decoded and none need exist)::

    python -m eksml_tpu_torch.tools.make_shapes_coco --dst DIR \\
        [--num-train 200] [--num-val 40] [--size 320] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from eksml_tpu_torch.data.masks import polygon_fill
from eksml_tpu_torch.fsio import atomic_write_text

CATEGORIES = [{"id": 1, "name": "box"}, {"id": 2, "name": "blob"},
              {"id": 3, "name": "wedge"}]


def _shape_polygon(cls: int, x: float, y: float, w: float, h: float,
                   rng) -> list:
    """Closed polygon (COCO flat [x0,y0,x1,y1,...]) for one shape."""
    if cls == 1:  # rectangle
        pts = [(x, y), (x + w, y), (x + w, y + h), (x, y + h)]
    elif cls == 2:  # ellipse, 16-gon approximation
        t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
        cx, cy = x + w / 2, y + h / 2
        pts = list(zip(cx + np.cos(t) * w / 2, cy + np.sin(t) * h / 2))
    else:  # triangle
        pts = [(x + w * rng.uniform(0.3, 0.7), y),
               (x + w, y + h), (x, y + h)]
    return [float(v) for p in pts for v in p]


def _rasterize(poly: list, canvas: np.ndarray, color) -> None:
    h, w = canvas.shape[:2]
    m = polygon_fill(np.asarray(poly, np.float64).reshape(-1, 2), h, w)
    canvas[m.astype(bool)] = color


def _color(cls: int, rng) -> tuple:
    if cls == 1:   # warm
        return (int(rng.randint(180, 256)), int(rng.randint(0, 90)),
                int(rng.randint(0, 90)))
    if cls == 2:   # cool
        return (int(rng.randint(0, 90)), int(rng.randint(0, 90)),
                int(rng.randint(180, 256)))
    return (int(rng.randint(0, 90)), int(rng.randint(180, 256)),
            int(rng.randint(0, 90)))


def shapes_split(split: str, n_img: int, size: int, seed: int,
                 id_base: int) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """``n_img`` square images of ``size`` px: ``(COCO annotation dict,
    {file_name: uint8 [size, size, 3] image})``."""
    rng = np.random.RandomState(seed)
    images, anns, pixels = [], [], {}
    aid = id_base * 10
    for i in range(n_img):
        h = w = size
        # textured background: low-contrast noise around a random gray
        bg = rng.randint(90, 160)
        img = (bg + rng.randint(-25, 25, (h, w, 3))).clip(0, 255) \
            .astype(np.uint8)
        iid = id_base + i
        name = f"{split}_{i:04d}.jpg"
        images.append({"id": iid, "file_name": name, "height": h,
                       "width": w})
        for _ in range(int(rng.randint(1, 4))):
            cls = int(rng.randint(1, 4))
            bw = float(rng.randint(size // 6, size // 2))
            bh = float(rng.randint(size // 6, size // 2))
            x = float(rng.randint(0, int(w - bw)))
            y = float(rng.randint(0, int(h - bh)))
            poly = _shape_polygon(cls, x, y, bw, bh, rng)
            _rasterize(poly, img, _color(cls, rng))
            xs = poly[0::2]
            ys = poly[1::2]
            x0, y0 = min(xs), min(ys)
            bbw, bbh = max(xs) - x0, max(ys) - y0
            anns.append({
                "id": aid, "image_id": iid, "category_id": cls,
                "bbox": [x0, y0, bbw, bbh], "iscrowd": 0,
                "area": bbw * bbh * (0.5 if cls == 3 else
                                     0.78 if cls == 2 else 1.0),
                "segmentation": [poly],
            })
            aid += 1
        pixels[name] = img
    return ({"images": images, "annotations": anns,
             "categories": CATEGORIES}, pixels)


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def make_split(dst: str, split: str, n_img: int, size: int, seed: int,
               id_base: int, skip_empty: bool = True) -> List[Dict]:
    """Write ``dst/annotations/instances_<split>.json`` (atomically) and,
    where PIL imports, ``dst/<split>/*.jpg``; return the split read back
    through the port's ``CocoDataset`` (``skip_empty`` as its
    ``records``), each record's pixels on ``_image``."""
    from eksml_tpu_torch.data.coco import CocoDataset

    data, pixels = shapes_split(split, n_img, size, seed, id_base)
    image_cls = _pil_image()
    if image_cls is not None:
        os.makedirs(os.path.join(dst, split), exist_ok=True)
        for name, img in pixels.items():
            image_cls.fromarray(img).save(os.path.join(dst, split, name),
                                          quality=92)
    os.makedirs(os.path.join(dst, "annotations"), exist_ok=True)
    atomic_write_text(os.path.join(dst, "annotations",
                                   f"instances_{split}.json"),
                      json.dumps(data))
    records = CocoDataset(dst, split).records(skip_empty=skip_empty)
    for rec in records:
        rec["_image"] = pixels[os.path.basename(rec["path"])]
    return records


def main(argv=None):
    p = argparse.ArgumentParser(
        description="the shapes dataset in COCO layout")
    p.add_argument("--dst", required=True)
    p.add_argument("--num-train", type=int, default=200)
    p.add_argument("--num-val", type=int, default=40)
    p.add_argument("--size", type=int, default=320)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    make_split(args.dst, "train2017", args.num_train, args.size,
               args.seed, 1000)
    make_split(args.dst, "val2017", args.num_val, args.size,
               args.seed + 1, 100000)
    jpegs = "JPEGs" if _pil_image() is not None else "no JPEGs (no PIL)"
    print(f"shapes dataset at {args.dst}: {args.num_train} train / "
          f"{args.num_val} val, {args.size}px, {jpegs}")


if __name__ == "__main__":
    main()
