"""Wrappers of the hand-written CUDA ROIAlign kernels, and the autograd
function that joins them.

- ``RoiAlignForward`` (``csrc/roi_align_fwd.cu``) replaces the Pallas
  TPU kernel ``eksml_tpu/ops/pallas/roi_align_kernel.py::_kernel``;
- ``RoiAlignBackward`` (``csrc/roi_align_bwd.cu``) replaces
  ``_bwd_kernel``;
- ``CopyToGlobal`` (``csrc/roi_align_bwd.cu``) replaces the copy kernel
  ``k`` inside ``_to_hbm``, which seeds the backward's zeroed float32
  accumulators.

The sources state each kernel's bound on the H100 and its design.  The
wrappers are the only place that routes by device: a call on CPU
tensors returns the plain PyTorch version; a call on CUDA tensors
launches the kernel on the current stream, without synchronising, or
raises.  ``launches`` counts kernel launches and nothing else.
``RoiAlignFunction`` joins the wrappers into the model's differentiable
ROIAlign on either device (it is
``eksml_tpu_torch.ops.roi_align.dispatch_roi_align``).
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Callable, Dict, Sequence, Tuple

import torch

from eksml_tpu_torch.ops.cuda import build
from eksml_tpu_torch.profiling.scopes import counted_call, uncounted

MAX_LEVELS = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# (level pointers, level (H, W), 1/strides, levels, rois, in/out,
#  batch, rois per image, channels, out size, sampling, min level, dtype,
#  stream): the signature of both ROIAlign entry points
_ROI_ALIGN_ARGTYPES = ([_PTR] * 3 + [_INT] + [_PTR] * 2 + [_INT] * 7
                       + [_PTR])


class _CudaKernel:
    """One ``extern "C"`` entry point of ``csrc/<library>.cu``, loaded at
    first launch, with its launch count."""

    name: str
    source: str
    replaces: str
    library: str
    symbol: str
    argtypes: list

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    def _launch(self, *args) -> None:
        with self._lock:
            if self._fn is None:
                lib = build.load(self.library)
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.eksml_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name} launch failed: "
                f"{self._err(code).decode(errors='replace')} ({code})")
        self.launches += 1


def _level_table(levels: Sequence[torch.Tensor], strides: Sequence[int]):
    """Host-side level table: one 8-byte-aligned buffer holding the
    pointers (uint64), the (H, W) pairs (int32) and 1/stride (float32),
    alive until the launch returns, and the address of each part.  One
    ``struct.pack`` in place of three numpy arrays and their ctypes
    views shortens the launch path, which outlasts the kernel on the
    small mask-target call."""
    n = len(levels)
    raw = struct.pack(f"{n}Q{2 * n}i{n}f", *[t.data_ptr() for t in levels],
                      *[d for t in levels for d in t.shape[1:3]],
                      *[1.0 / s for s in strides])
    buf = (ctypes.c_uint64 * (-(-len(raw) // 8))).from_buffer_copy(
        raw.ljust(-(-len(raw) // 8) * 8, b"\0"))
    base = ctypes.addressof(buf)
    return buf, base, base + 8 * n, base + 16 * n


def _check_rois(rois: torch.Tensor, dev: torch.device) -> None:
    if rois.device != dev or dev.type != "cuda":
        raise ValueError(f"rois on {rois.device} but the maps on {dev}: the "
                         "kernel takes CUDA tensors on one device only")
    if rois.dtype != torch.float32 or rois.dim() != 3 \
            or rois.shape[-1] != 4 or not rois.is_contiguous():
        raise ValueError("rois must be a contiguous float32 [B, N, 4] "
                         f"tensor, got {rois.dtype} {tuple(rois.shape)}")


def _check_levels(levels, strides, dtypes, b: int, c: int, what: str):
    dev = levels[0].device
    if not 1 <= len(levels) <= MAX_LEVELS or len(levels) != len(strides):
        raise ValueError(f"need 1..{MAX_LEVELS} levels with one stride "
                         f"each, got {len(levels)} and {len(strides)}")
    dtype = levels[0].dtype
    if dtype not in dtypes:
        raise ValueError(f"{what} must be "
                         f"{' or '.join(str(d)[6:] for d in dtypes)}, got "
                         f"{dtype}")
    for t in levels:
        if t.device != dev or t.dtype != dtype or t.dim() != 4 \
                or t.shape[0] != b or t.shape[-1] != c \
                or not t.is_contiguous():
            raise ValueError(
                f"every level of the {what} must be a contiguous "
                f"[B, H, W, C] tensor on {dev} in {dtype} with B={b}, "
                f"C={c}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return {t.device.type for t in tensors} == {"cpu"}


class RoiAlignForward(_CudaKernel):
    """Callable with the signature of ``batched_multilevel_roi_align``,
    which it is given as ``plain`` for CPU tensors."""

    name = "roi_align_fwd"
    source = "eksml_tpu_torch/csrc/roi_align_fwd.cu"
    replaces = "eksml_tpu/ops/pallas/roi_align_kernel.py:288"
    library = "roi_align_fwd"
    symbol = "eksml_roi_align_fwd"
    argtypes = _ROI_ALIGN_ARGTYPES

    def __init__(self, plain: Callable[..., torch.Tensor]):
        super().__init__()
        self._plain = plain

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 strides: Sequence[int], out_size: int,
                 sampling_ratio: int = 2, min_level: int = 2) -> torch.Tensor:
        feats = tuple(feats)
        if _on_cpu(*feats, rois):
            return self._plain(feats, rois, strides, out_size,
                               sampling_ratio, min_level)
        if feats[0].device.type != "cuda":
            raise ValueError(f"features on {feats[0].device} but rois on "
                             f"{rois.device}: the kernel takes CUDA tensors "
                             "only")
        _check_rois(rois, feats[0].device)
        b, n = rois.shape[0], rois.shape[1]
        c = feats[0].shape[-1]
        _check_levels(feats, strides, _DTYPE_CODES, b, c, "features")
        out = torch.empty((b, n, out_size, out_size, c),
                          dtype=feats[0].dtype, device=rois.device)
        if b * n == 0:
            return out
        table, ptrs, hw, scales = _level_table(feats, strides)
        with torch.cuda.device(rois.device):
            stream = torch.cuda.current_stream().cuda_stream
            self._launch(ptrs, hw, scales, len(feats), rois.data_ptr(),
                         out.data_ptr(), b, n, c, out_size, sampling_ratio,
                         min_level, _DTYPE_CODES[feats[0].dtype], stream)
        return out


class RoiAlignBackward(_CudaKernel):
    """``(accs, rois, g, strides, out_size, sampling_ratio, min_level)``:
    adds the feature gradient of ``batched_multilevel_roi_align`` for
    its output gradient ``g`` ``[B, N, out, out, C]`` into the float32
    per-level accumulators ``accs`` ``[(B, H_l, W_l, C), ...]``, in
    place, and returns them.  ``plain`` (same signature) serves CPU
    tensors."""

    name = "roi_align_bwd"
    source = "eksml_tpu_torch/csrc/roi_align_bwd.cu"
    replaces = "eksml_tpu/ops/pallas/roi_align_kernel.py:389"
    library = "roi_align_bwd"
    symbol = "eksml_roi_align_bwd"
    argtypes = _ROI_ALIGN_ARGTYPES

    def __init__(self, plain: Callable[..., Sequence[torch.Tensor]]):
        super().__init__()
        self._plain = plain

    def __call__(self, accs: Sequence[torch.Tensor], rois: torch.Tensor,
                 g: torch.Tensor, strides: Sequence[int], out_size: int,
                 sampling_ratio: int = 2, min_level: int = 2
                 ) -> Tuple[torch.Tensor, ...]:
        accs = tuple(accs)
        if _on_cpu(*accs, rois, g):
            return tuple(self._plain(accs, rois, g, strides, out_size,
                                     sampling_ratio, min_level))
        if accs[0].device.type != "cuda":
            raise ValueError(f"accumulators on {accs[0].device} but rois on "
                             f"{rois.device}: the kernel takes CUDA tensors "
                             "only")
        _check_rois(rois, accs[0].device)
        b, n = rois.shape[0], rois.shape[1]
        c = accs[0].shape[-1]
        _check_levels(accs, strides, (torch.float32,), b, c,
                      "gradient accumulators")
        if g.device != rois.device or g.dtype not in _DTYPE_CODES \
                or tuple(g.shape) != (b, n, out_size, out_size, c) \
                or not g.is_contiguous():
            raise ValueError(
                "g must be a contiguous float32 or bfloat16 "
                f"[{b}, {n}, {out_size}, {out_size}, {c}] tensor on "
                f"{rois.device}, got {g.dtype} {tuple(g.shape)} on "
                f"{g.device}")
        if b * n == 0:
            return accs
        table, ptrs, hw, scales = _level_table(accs, strides)
        with torch.cuda.device(rois.device):
            stream = torch.cuda.current_stream().cuda_stream
            self._launch(ptrs, hw, scales, len(accs), rois.data_ptr(),
                         g.data_ptr(), b, n, c, out_size, sampling_ratio,
                         min_level, _DTYPE_CODES[g.dtype], stream)
        return accs


class CopyToGlobal(_CudaKernel):
    """``src`` → a new contiguous tensor in device memory with the same
    values (``src.clone()`` for a CPU tensor)."""

    name = "copy_to_global"
    source = "eksml_tpu_torch/csrc/roi_align_bwd.cu"
    replaces = "eksml_tpu/ops/pallas/roi_align_kernel.py:766"
    library = "roi_align_bwd"
    symbol = "eksml_copy_to_global"
    argtypes = [_PTR, _PTR, ctypes.c_longlong, _PTR]

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        if src.device.type == "cpu":
            return src.clone()
        if src.device.type != "cuda" or not src.is_contiguous():
            raise ValueError(f"the copy takes a contiguous CUDA tensor, got "
                             f"{tuple(src.shape)} on {src.device}")
        dst = torch.empty_like(src, memory_format=torch.contiguous_format)
        nbytes = src.numel() * src.element_size()
        if nbytes:
            with torch.cuda.device(src.device):
                stream = torch.cuda.current_stream().cuda_stream
                self._launch(src.data_ptr(), dst.data_ptr(), nbytes, stream)
        return dst


class RoiAlignKernels:
    """The three kernels of the model's ROIAlign and the read-only zero
    seeds of the backward's accumulators, one per level shape and
    device (the counterpart of ``_to_hbm(jnp.zeros(...))`` at
    ``roi_align_kernel.py:945-947``)."""

    def __init__(self, plain_forward: Callable[..., torch.Tensor],
                 plain_backward: Callable[..., Sequence[torch.Tensor]]):
        self.fwd = RoiAlignForward(plain_forward)
        self.bwd = RoiAlignBackward(plain_backward)
        self.copy = CopyToGlobal()
        self._seeds: Dict[Tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    def __iter__(self):
        return iter((self.fwd, self.bwd, self.copy))

    def launch_counts(self) -> Dict[str, int]:
        """Each kernel's launches in this process, by name."""
        return {k.name: k.launches for k in self}

    def load(self) -> None:
        """Build and load every kernel's library now, not at its first
        launch (a collective under a process group: the first launch of
        the backward runs on autograd's thread, mid-backward)."""
        for name in sorted({k.library for k in self}):
            build.load(name)

    def zero_seed(self, shape: Sequence[int],
                  device: torch.device) -> torch.Tensor:
        key = (tuple(shape), str(device))
        with self._lock:
            seed = self._seeds.get(key)
            if seed is None:
                seed = torch.zeros(key[0], dtype=torch.float32, device=device)
                self._seeds[key] = seed
            return seed


class RoiAlignFunction(torch.autograd.Function):
    """Differentiable multilevel ROIAlign through the kernels' wrappers:
    ``RoiAlignFunction.apply(kernels, rois, strides, out_size,
    sampling_ratio, min_level, *feats)``.  The backward seeds one float32
    accumulator per level with ``CopyToGlobal``, adds the feature
    gradient with ``RoiAlignBackward``, casts to the feature dtype (a
    no-op in float32) and gives the ROIs no gradient, as the reference
    does (``roi_align_kernel.py:1070``).  On CPU tensors each wrapper
    runs its plain version, so the same function is the CPU's ROIAlign
    under autograd."""

    @staticmethod
    def forward(ctx, kernels: RoiAlignKernels, rois: torch.Tensor,
                strides: Sequence[int], out_size: int, sampling_ratio: int,
                min_level: int, *feats: torch.Tensor) -> torch.Tensor:
        out = counted_call("roi_align_fwd", kernels.fwd, feats, rois,
                           strides, out_size, sampling_ratio, min_level)
        ctx.save_for_backward(rois)
        ctx.kernels = kernels
        ctx.args = (tuple(strides), out_size, sampling_ratio, min_level)
        ctx.shapes = [tuple(f.shape) for f in feats]
        ctx.dtype = feats[0].dtype
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        (rois,) = ctx.saved_tensors
        k = ctx.kernels
        with uncounted():
            seeds = [k.zero_seed(s, g.device) for s in ctx.shapes]
        accs = [counted_call("copy_to_global", k.copy, seed)
                for seed in seeds]
        counted_call("roi_align_bwd", k.bwd, accs, rois, g.contiguous(),
                     *ctx.args)
        return (None,) * 6 + tuple(a.to(ctx.dtype) for a in accs)
