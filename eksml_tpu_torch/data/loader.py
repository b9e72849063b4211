"""Image resize/pad and bucket assignment for serving (numpy copy of
``eksml_tpu/data/loader.py:51-141``).  The training loader comes with
the trainer slice."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
                   pad_hw: Tuple[int, int]):
    """Resize keeping aspect (short edge to ``short_edge``, long edge
    capped at ``max_size``), then zero-pad bottom/right to ``pad_hw``.
    A ``pad_hw`` tighter than the standard resize scales the image
    further down to fit (force-fit).

    Returns (padded float32 image, scale, (new_h, new_w))."""
    h, w = image.shape[:2]
    scale, nh, nw = _resized_hw(h, w, short_edge, max_size)
    pad_h, pad_w = pad_hw
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
