"""Mask postprocess for serving (numpy copy of ``paste_mask`` and
``rle_encode`` from ``eksml_tpu/data/masks.py``)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


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
