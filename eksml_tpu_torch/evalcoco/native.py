"""ctypes bridge to the mask-ops library (``eksml_tpu/evalcoco/native.py``).

``native_src/maskops.cc`` (dense IoU, RLE encode, RLE IoU and the greedy
match of COCOeval) is built with g++ by ``eksml_tpu_torch/_native.py``
at first use and bound over its C ABI.  Each entry returns None (or
runs its python loop) when the library is unavailable, and the callers
in ``cocoeval.py`` / ``data/masks.py`` then take their numpy versions.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Optional, Sequence

import numpy as np

from eksml_tpu_torch._native import NativeLib

log = logging.getLogger(__name__)


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.mask_iou_dense.argtypes = [u8p, ctypes.c_int64, u8p,
                                   ctypes.c_int64, u8p, ctypes.c_int64,
                                   f64p]
    lib.mask_iou_dense.restype = None
    lib.rle_encode_dense.argtypes = [u8p, ctypes.c_int64,
                                     ctypes.c_int64, u32p]
    lib.rle_encode_dense.restype = ctypes.c_int64
    lib.rle_iou.argtypes = [u32p, i64p, ctypes.c_int64, u32p, i64p,
                            ctypes.c_int64, u8p, f64p]
    lib.rle_iou.restype = None
    lib.greedy_match.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64,
                                 u8p, u8p, i64p, f64p, ctypes.c_int64,
                                 i64p, u8p, u8p]
    lib.greedy_match.restype = None


_LIB = NativeLib(
    "maskops",
    os.path.join(os.path.dirname(__file__), "native_src", "maskops.cc"),
    _declare)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building on first use / source change) the native library."""
    return _LIB.get()


def _as_u8(m: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(m, dtype=np.uint8)


def mask_iou_native(det_masks: Sequence, gt_masks: Sequence,
                    gt_crowd: np.ndarray) -> Optional[np.ndarray]:
    """IoU matrix [D, G] over dense binary masks, or None when the
    native library is unavailable (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    d_n, g_n = len(det_masks), len(gt_masks)
    out = np.zeros((d_n, g_n), np.float64)
    if d_n == 0 or g_n == 0:
        return out
    h, w = np.asarray(det_masks[0]).shape
    dets = _as_u8(np.stack([np.asarray(m) for m in det_masks]))
    gts = _as_u8(np.stack([np.asarray(m) for m in gt_masks]))
    if gts.shape[1:] != (h, w):
        return None  # shape mismatch; let numpy path handle/raise
    crowd = _as_u8(np.asarray(gt_crowd))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mask_iou_dense(
        dets.ctypes.data_as(u8p), d_n, gts.ctypes.data_as(u8p), g_n,
        crowd.ctypes.data_as(u8p), h * w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def _rle_counts(m) -> np.ndarray:
    """Normalize a mask (RLE dict or dense array) to uint32 counts."""
    if isinstance(m, dict):
        counts = m["counts"]
        if isinstance(counts, (bytes, str)):
            from eksml_tpu_torch.data.masks import _uncompress_counts

            counts = _uncompress_counts(
                counts.encode() if isinstance(counts, str) else counts)
        return np.asarray(counts, np.uint32)
    from eksml_tpu_torch.data.masks import rle_encode

    return np.asarray(rle_encode(np.asarray(m))["counts"], np.uint32)


def _rle_inter_py(a: np.ndarray, b: np.ndarray) -> int:
    ia = ib = 0
    ca = int(a[0]) if len(a) else 0
    cb = int(b[0]) if len(b) else 0
    va = vb = 0
    inter = 0
    while ia < len(a) and ib < len(b):
        step = min(ca, cb)
        if va and vb:
            inter += step
        ca -= step
        cb -= step
        if ca == 0:
            ia += 1
            va ^= 1
            if ia < len(a):
                ca = int(a[ia])
        if cb == 0:
            ib += 1
            vb ^= 1
            if ib < len(b):
                cb = int(b[ib])
    return inter


def rle_iou_masks(det_masks: Sequence, gt_masks: Sequence,
                  gt_crowd: np.ndarray) -> np.ndarray:
    """IoU matrix over RLE masks; native C++ when built, python merge
    loop otherwise.  Crowd GT uses IoF per COCO convention."""
    d_counts = [_rle_counts(m) for m in det_masks]
    g_counts = [_rle_counts(m) for m in gt_masks]
    crowd = np.ascontiguousarray(np.asarray(gt_crowd), dtype=np.uint8)
    out = np.zeros((len(d_counts), len(g_counts)), np.float64)
    if not len(d_counts) or not len(g_counts):
        return out
    lib = get_lib()
    if lib is not None:
        d_flat = np.ascontiguousarray(
            np.concatenate(d_counts), dtype=np.uint32)
        g_flat = np.ascontiguousarray(
            np.concatenate(g_counts), dtype=np.uint32)
        d_off = np.zeros(len(d_counts) + 1, np.int64)
        np.cumsum([len(c) for c in d_counts], out=d_off[1:])
        g_off = np.zeros(len(g_counts) + 1, np.int64)
        np.cumsum([len(c) for c in g_counts], out=g_off[1:])
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.rle_iou(
            d_flat.ctypes.data_as(u32p), d_off.ctypes.data_as(i64p),
            len(d_counts), g_flat.ctypes.data_as(u32p),
            g_off.ctypes.data_as(i64p), len(g_counts),
            crowd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out
    for i, dc in enumerate(d_counts):
        da = int(dc[1::2].sum())
        for j, gc in enumerate(g_counts):
            ga = int(gc[1::2].sum())
            inter = _rle_inter_py(dc, gc)
            union = da if crowd[j] else da + ga - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def rle_encode_native(mask: np.ndarray) -> Optional[list]:
    """Column-major RLE counts of a dense mask via the native path."""
    lib = get_lib()
    if lib is None:
        return None
    m = _as_u8(mask)
    h, w = m.shape
    buf = np.zeros(h * w + 1, np.uint32)
    n = lib.rle_encode_dense(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return buf[:n].tolist()


def greedy_match_native(ious: np.ndarray, crowd: np.ndarray,
                        ignore: np.ndarray, g_order: np.ndarray,
                        threshs: np.ndarray):
    """Greedy det→gt matching at every IoU threshold via the C++ path
    (official evaluateImg semantics: ``ignore`` = crowd OR out of the
    current area range, ``g_order`` ignored-last); None when the
    library is unavailable (caller falls back to the python loop in
    cocoeval.py).  Returns (dt_match [T,D] int64, dt_ignore [T,D]
    bool, gt_match [T,G] bool)."""
    lib = get_lib()
    if lib is None:
        return None
    ious = np.ascontiguousarray(ious, np.float64)
    d_n, g_n = ious.shape
    crowd = np.ascontiguousarray(crowd, np.uint8)
    ignore = np.ascontiguousarray(ignore, np.uint8)
    g_order = np.ascontiguousarray(g_order, np.int64)
    threshs = np.ascontiguousarray(threshs, np.float64)
    t_n = len(threshs)
    dt_match = np.empty((t_n, d_n), np.int64)
    dt_ignore = np.zeros((t_n, d_n), np.uint8)
    gt_match = np.zeros((t_n, g_n), np.uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.greedy_match(
        ious.ctypes.data_as(f64p), d_n, g_n,
        crowd.ctypes.data_as(u8p), ignore.ctypes.data_as(u8p),
        g_order.ctypes.data_as(i64p),
        threshs.ctypes.data_as(f64p), t_n,
        dt_match.ctypes.data_as(i64p), dt_ignore.ctypes.data_as(u8p),
        gt_match.ctypes.data_as(u8p))
    return dt_match, dt_ignore.astype(bool), gt_match.astype(bool)
