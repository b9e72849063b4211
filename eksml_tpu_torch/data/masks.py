"""Mask utilities (numpy copy of ``eksml_tpu/data/masks.py``): polygon
rasterization and RLE decoding for the training loader's GT crops,
``paste_mask`` and ``rle_encode`` for serving."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def polygon_fill(poly_xy: np.ndarray, height: int, width: int) -> np.ndarray:
    """Rasterize one polygon (``[N, 2]`` float xy) with the even-odd
    rule at pixel centers (x + 0.5, y + 0.5)."""
    ys = np.arange(height, dtype=np.float64) + 0.5
    xs = np.arange(width, dtype=np.float64) + 0.5
    px = poly_xy[:, 0]
    py = poly_xy[:, 1]
    qx = np.roll(px, -1)
    qy = np.roll(py, -1)
    y = ys[:, None]                                  # [H, 1]
    cond = ((py[None, :] <= y) & (qy[None, :] > y)) | \
           ((qy[None, :] <= y) & (py[None, :] > y))  # [H, V]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (y - py[None, :]) / (qy[None, :] - py[None, :])
    xcross = px[None, :] + t * (qx[None, :] - px[None, :])  # [H, V]
    xcross = np.where(cond, xcross, np.inf)
    crossings = (xcross[:, None, :] > xs[None, :, None]).sum(axis=2)
    return (crossings % 2 == 1).astype(np.uint8)


def polygons_to_bbox_mask(polygons: Sequence[Sequence[float]],
                          bbox_xyxy: Sequence[float],
                          out_size: int) -> np.ndarray:
    """COCO polygon segmentation → binary ``out_size²`` mask covering
    ``bbox_xyxy`` (the bbox-cropped GT-mask format of the batches)."""
    x1, y1, x2, y2 = bbox_xyxy
    w = max(x2 - x1, 1e-4)
    h = max(y2 - y1, 1e-4)
    out = np.zeros((out_size, out_size), np.uint8)
    for poly in polygons:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        p[:, 0] = (p[:, 0] - x1) / w * out_size
        p[:, 1] = (p[:, 1] - y1) / h * out_size
        out |= polygon_fill(p, out_size, out_size)
    return out


def rle_decode(rle: Dict, height: int = None, width: int = None) -> np.ndarray:
    """COCO RLE ``{'size': [h, w], 'counts': ...}`` (uncompressed list or
    compressed string) → binary ``[h, w]`` mask, column-major as
    pycocotools."""
    h, w = rle.get("size", (height, width))
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _uncompress_counts(
            counts.encode() if isinstance(counts, str) else counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T


def _uncompress_counts(s: bytes) -> List[int]:
    """pycocotools' modified-LEB128 string → run-length list."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_encode(mask: np.ndarray) -> Dict:
    """Binary ``[h, w]`` mask → uncompressed COCO RLE (column-major run
    lengths, starting with a run of zeros)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1)
    diffs = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def paste_mask(mask28: np.ndarray, box_xyxy: Sequence[float],
               height: int, width: int,
               threshold: float = 0.5) -> np.ndarray:
    """Paste a fixed-resolution mask into the full image: bilinear
    resize into the box, then threshold."""
    x1, y1, x2, y2 = [int(round(v)) for v in box_xyxy]
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, width), min(y2, height)
    out = np.zeros((height, width), np.uint8)
    bw, bh = x2 - x1, y2 - y1
    if bw <= 0 or bh <= 0:
        return out
    m = mask28.shape[0]
    yy = (np.arange(bh) + 0.5) / bh * m - 0.5
    xx = (np.arange(bw) + 0.5) / bw * m - 0.5
    y0 = np.clip(np.floor(yy).astype(int), 0, m - 1)
    x0 = np.clip(np.floor(xx).astype(int), 0, m - 1)
    y1i = np.clip(y0 + 1, 0, m - 1)
    x1i = np.clip(x0 + 1, 0, m - 1)
    ly = np.clip(yy - y0, 0, 1)[:, None]
    lx = np.clip(xx - x0, 0, 1)[None, :]
    patch = (mask28[np.ix_(y0, x0)] * (1 - ly) * (1 - lx)
             + mask28[np.ix_(y1i, x0)] * ly * (1 - lx)
             + mask28[np.ix_(y0, x1i)] * (1 - ly) * lx
             + mask28[np.ix_(y1i, x1i)] * ly * lx)
    out[y1:y2, x1:x2] = (patch >= threshold).astype(np.uint8)
    return out
