"""Multi-level FPN anchor generation (numpy copy of
``eksml_tpu/ops/anchors.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _cell_anchors(size: float, ratios: Sequence[float]) -> np.ndarray:
    """Anchors centered at origin for one size across aspect ratios."""
    out = []
    for r in ratios:
        w = size / np.sqrt(r)
        h = size * np.sqrt(r)
        out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


def generate_fpn_anchors(
    image_size: Tuple[int, int],
    strides: Sequence[int],
    sizes: Sequence[float],
    ratios: Sequence[float],
) -> Tuple[np.ndarray, ...]:
    """Per-level anchor arrays ``[(Hl*Wl*A, 4), ...]`` for a padded
    ``image_size=(H, W)``, in (row, column, ratio) order — the order the
    RPN head flattens its outputs in."""
    assert len(strides) == len(sizes)
    H, W = image_size
    levels = []
    for stride, size in zip(strides, sizes):
        fh, fw = H // stride, W // stride
        cell = _cell_anchors(size, ratios)  # [A, 4]
        shift_x = (np.arange(fw, dtype=np.float32) + 0.5) * stride
        shift_y = (np.arange(fh, dtype=np.float32) + 0.5) * stride
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx, sy, sx, sy], axis=-1)  # [fh, fw, 4]
        anchors = shifts[:, :, None, :] + cell[None, None, :, :]
        levels.append(anchors.reshape(-1, 4).astype(np.float32))
    return tuple(levels)


def num_anchors_per_level(
    image_size: Tuple[int, int], strides: Sequence[int], num_ratios: int
) -> Tuple[int, ...]:
    H, W = image_size
    return tuple((H // s) * (W // s) * num_ratios for s in strides)
