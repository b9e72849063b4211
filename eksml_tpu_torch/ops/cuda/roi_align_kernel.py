"""Wrapper of the hand-written CUDA ROIAlign forward (``csrc/roi_align_fwd.cu``).

It replaces the Pallas TPU kernel
``eksml_tpu/ops/pallas/roi_align_kernel.py::_kernel``; the source file
states its bound on the H100 and its design.  A call on CPU tensors
returns the plain PyTorch version it was built with; a call on CUDA
tensors launches the kernel on the current stream, without
synchronising, or raises.  ``launches`` counts kernel launches and
nothing else.  The model's instance is
``eksml_tpu_torch.ops.roi_align.dispatch_roi_align``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from eksml_tpu_torch.ops.cuda import build

MAX_LEVELS = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class RoiAlignForward:
    """Callable with the signature of ``batched_multilevel_roi_align``,
    which it is given as ``plain`` for CPU tensors."""

    name = "roi_align_fwd"
    source = "eksml_tpu_torch/csrc/roi_align_fwd.cu"
    replaces = "eksml_tpu/ops/pallas/roi_align_kernel.py:288"

    def __init__(self, plain: Callable[..., torch.Tensor]):
        self.launches = 0
        self._plain = plain
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    def _entry(self):
        with self._lock:
            if self._fn is None:
                lib = build.load(self.name)
                fn = lib.eksml_roi_align_fwd
                fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                               + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                err = lib.eksml_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
            return self._fn

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 strides: Sequence[int], out_size: int,
                 sampling_ratio: int = 2, min_level: int = 2) -> torch.Tensor:
        feats = tuple(feats)
        kinds = {t.device.type for t in feats + (rois,)}
        if kinds == {"cpu"}:
            return self._plain(feats, rois, strides, out_size,
                               sampling_ratio, min_level)
        self._check(feats, rois, strides)
        b, n = rois.shape[0], rois.shape[1]
        c = feats[0].shape[-1]
        out = torch.empty((b, n, out_size, out_size, c),
                          dtype=feats[0].dtype, device=rois.device)
        if b * n == 0:
            return out
        fn = self._entry()
        # host-side level table, alive until the call returns
        ptrs = np.asarray([f.data_ptr() for f in feats], np.uint64)
        hw = np.asarray([[f.shape[1], f.shape[2]] for f in feats], np.int32)
        scales = np.asarray([1.0 / s for s in strides], np.float32)
        with torch.cuda.device(rois.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(ptrs.ctypes.data, hw.ctypes.data, scales.ctypes.data,
                      len(feats), rois.data_ptr(), out.data_ptr(), b, n, c,
                      out_size, sampling_ratio, min_level,
                      _DTYPE_CODES[feats[0].dtype], stream)
        if code != 0:
            raise RuntimeError(
                f"{self.name} launch failed: "
                f"{self._err(code).decode(errors='replace')} ({code})")
        self.launches += 1
        return out

    @staticmethod
    def _check(feats, rois, strides):
        dev = rois.device
        if dev.type != "cuda":
            raise ValueError(f"rois on {dev} but features on CUDA: the "
                             "kernel takes CUDA tensors only")
        if rois.dtype != torch.float32 or rois.dim() != 3 \
                or rois.shape[-1] != 4 or not rois.is_contiguous():
            raise ValueError("rois must be a contiguous float32 [B, N, 4] "
                             f"tensor, got {rois.dtype} {tuple(rois.shape)}")
        if not 1 <= len(feats) <= MAX_LEVELS or len(feats) != len(strides):
            raise ValueError(f"need 1..{MAX_LEVELS} levels with one stride "
                             f"each, got {len(feats)} and {len(strides)}")
        dtype = feats[0].dtype
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"features must be float32 or bfloat16, got "
                             f"{dtype}")
        b, c = rois.shape[0], feats[0].shape[-1]
        for f in feats:
            if f.device != dev or f.dtype != dtype or f.dim() != 4 \
                    or f.shape[0] != b or f.shape[-1] != c \
                    or not f.is_contiguous():
                raise ValueError(
                    "every level must be a contiguous [B, H, W, C] tensor "
                    f"on {dev} in {dtype} with B={b}, C={c}; got "
                    f"{f.dtype} {tuple(f.shape)} on {f.device}")

