"""ctypes bridge to the image-ops library (``eksml_tpu/data/native.py``).

``native_src/imageops.cc`` (the half-pixel bilinear resize of every
image to its canvas) is built with g++ by ``eksml_tpu_torch/_native.py``
at first use and releases the GIL for the call, so the loader's worker
threads scale with host cores.  ``resize_bilinear_native`` returns None
when the library is unavailable and ``loader._bilinear_resize`` takes
its numpy version.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from eksml_tpu_torch._native import NativeLib


def _declare(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.resize_bilinear_f32.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.resize_bilinear_f32.restype = None


_LIB = NativeLib(
    "imageops",
    os.path.join(os.path.dirname(__file__), "native_src", "imageops.cc"),
    _declare)


def get_lib() -> Optional[ctypes.CDLL]:
    return _LIB.get()


def resize_bilinear_native(img: np.ndarray, nh: int, nw: int,
                           n_threads: int = 1) -> Optional[np.ndarray]:
    """Half-pixel bilinear resize of an ``[H, W, C]`` f32 image, or
    None when the native library is unavailable.  ``n_threads=1`` by
    default: the loader already parallelizes across images."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(img, dtype=np.float32)
    h, w, c = src.shape
    dst = np.empty((nh, nw, c), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.resize_bilinear_f32(
        src.ctypes.data_as(f32p), h, w, c,
        dst.ctypes.data_as(f32p), nh, nw, int(n_threads))
    return dst
