"""Detection overlay rendering, dependency-free (a copy of
``eksml_tpu/predict/viz.py``).

Analogue of TensorPack's ``viz.draw_final_outputs`` (viz notebook cell
25) and the optimized notebook's hand-rolled mask/box overlay (cells
16-18): boxes, class labels (id + score) and translucent masks drawn
directly into a numpy RGB array.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# deterministic per-class colors
def _class_color(cid: int) -> np.ndarray:
    rng = np.random.RandomState(cid * 7919 + 13)
    c = rng.randint(64, 255, 3)
    return c.astype(np.float32)


def _draw_box(img: np.ndarray, box, color, thickness: int = 2) -> None:
    h, w = img.shape[:2]
    x1, y1, x2, y2 = [int(round(v)) for v in box]
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, w - 1), min(y2, h - 1)
    t = thickness
    img[y1:y1 + t, x1:x2 + 1] = color
    img[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = color
    img[y1:y2 + 1, x1:x1 + t] = color
    img[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = color


def draw_final_outputs(image: np.ndarray, results: List,
                       class_names: Optional[Sequence[str]] = None,
                       mask_alpha: float = 0.45) -> np.ndarray:
    """Render detections onto a copy of ``image`` (uint8 RGB)."""
    out = image.astype(np.float32).copy()
    for r in results:
        color = _class_color(r.class_id)
        if r.mask is not None:
            m = r.mask.astype(bool)
            out[m] = out[m] * (1 - mask_alpha) + color * mask_alpha
    for r in results:
        _draw_box(out, r.box, _class_color(r.class_id))
    return out.clip(0, 255).astype(np.uint8)
