"""ResNet backbone with FrozenBN or GroupNorm
(``eksml_tpu/models/resnet.py``).

Public boundaries are NHWC like the reference; inside, the convolutions
run on the NCHW view of the same memory (``permute(0, 3, 1, 2)`` of an
NHWC tensor is channels-last NCHW, which cuDNN convolves without a
copy).  Submodule names follow the Flax parameter tree, so
``convert.from_flax`` maps parameters by name.

Precision follows Flax's ``dtype=`` policy with explicit casts:
parameters stay in their storage dtype and every layer casts its weight
to the dtype of its input at use, as Flax's ``promote_dtype`` does;
the module that owns a compute dtype casts its input once.  So under
``TRAIN.PRECISION=bfloat16`` the convolutions run in bfloat16 on
float32 (or ``TRAIN.PARAM_DTYPE=bfloat16``) parameters.  FrozenBN folds
its scale and shift in the storage dtype and does the multiply-add in
the activation dtype; GroupNorm takes its statistics in float32 and
returns the compute dtype, as Flax's ``GroupNorm(dtype=...)``.  Where
the port's bfloat16 differs from the reference's, it differs by design
in one way only: PyTorch rounds every op's output to bfloat16, while
XLA may keep a fused chain in float32 (``xla_allow_excess_precision``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of Flax/XLA ``SAME`` for one dim: the
    output has ``ceil(size / stride)`` elements and the extra pixel of an
    odd total goes AFTER (a 3x3/2 conv on an even map pads (0, 1), the
    7x7/2 stem (2, 3))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def cast_to(t: Optional[torch.Tensor], dtype: torch.dtype):
    """A parameter in the compute ``dtype`` (no copy when it already is)."""
    return None if t is None else t.to(dtype)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with Flax's ``SAME`` padding, on NCHW input, in the
    input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        w, b = cast_to(self.weight, x.dtype), cast_to(self.bias, x.dtype)
        top, bottom = same_padding(x.shape[2], k, s)
        left, right = same_padding(x.shape[3], k, s)
        if top == bottom and left == right:
            return F.conv2d(x, w, b, s, (top, left))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, b, s)


class Dense(nn.Linear):
    """``nn.Linear`` in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast_to(self.weight, x.dtype),
                        cast_to(self.bias, x.dtype))


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class FrozenBN(nn.Module):
    """Affine-only normalization with frozen statistics, folded to one
    multiply-add (eps 1e-5)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.scale * torch.rsqrt(self.var + self.eps)
        shift = self.bias - self.mean * inv
        return x * inv.to(x.dtype)[:, None, None] \
            + shift.to(x.dtype)[:, None, None]


class GroupNorm(nn.Module):
    """Flax's ``nn.GroupNorm(num_groups=32, dtype=...)`` on NCHW input:
    statistics over each group of consecutive channels in float32
    (epsilon 1e-6, Flax's default), a trainable per-channel ``scale`` and
    ``bias``, the result in the input's dtype."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.scale.float(),
                            self.bias.float(), self.eps).to(x.dtype)


NORMS = {"FreezeBN": ("FrozenBN", FrozenBN), "GN": ("GroupNorm", GroupNorm)}


def _add_norm(module: nn.Module, norm: str, index: int,
              channels: int) -> str:
    """Adds the ``index``-th norm of ``module`` under Flax's automatic
    name (``FrozenBN_k`` / ``GroupNorm_k``); returns the name."""
    if norm not in NORMS:
        raise ValueError(f"BACKBONE.NORM={norm!r}: FreezeBN or GN")
    prefix, cls = NORMS[norm]
    name = f"{prefix}_{index}"
    setattr(module, name, cls(channels))
    return name


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 norm: str = "FreezeBN"):
        super().__init__()
        self.conv1 = SameConv2d(in_ch, channels, 1, bias=False)
        self.norms = [_add_norm(self, norm, 0, channels)]
        self.conv2 = SameConv2d(channels, channels, 3, stride, bias=False)
        self.norms.append(_add_norm(self, norm, 1, channels))
        self.conv3 = SameConv2d(channels, channels * 4, 1, bias=False)
        self.norms.append(_add_norm(self, norm, 2, channels * 4))
        # the reference adds the projection whenever shapes differ: the
        # first block of every stage
        self.has_shortcut = stride != 1 or in_ch != channels * 4
        if self.has_shortcut:
            self.convshortcut = SameConv2d(in_ch, channels * 4, 1, stride,
                                           bias=False)
            self.norms.append(_add_norm(self, norm, 3, channels * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = [getattr(self, name) for name in self.norms]
        out = F.relu(n[0](self.conv1(x)))
        out = F.relu(n[1](self.conv2(out)))
        out = n[2](self.conv3(out))
        residual = x
        if self.has_shortcut:
            residual = n[3](self.convshortcut(x))
        return F.relu(out + residual)


class ResNetBackbone(nn.Module):
    """NHWC images → C2..C5 NHWC (strides 4, 8, 16, 32).
    ``num_blocks=(3, 4, 6, 3)`` is R50, ``(3, 4, 23, 3)`` R101.

    ``norm`` is BACKBONE.NORM (``FreezeBN`` or ``GN``); ``dtype`` the
    compute dtype (TRAIN.PRECISION) the input is cast to.

    ``freeze_at`` (BACKBONE.FREEZE_AT): the reference stops the gradient
    at the output of every stage with ``stage + 2 <= freeze_at``
    (``resnet.py:121-125``), so the stem and those stages get zero
    gradient.  Here their parameters do not require grad and the last
    frozen stage's output is detached; under SGD, with weight decay on
    trainable kernels only, that is the same update."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 freeze_at: int = 2, norm: str = "FreezeBN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.freeze_at = freeze_at
        self.dtype = dtype
        self.conv0 = SameConv2d(3, 64, 7, 2, bias=False)
        self.stem_norm = _add_norm(self, norm, 0, 64)
        in_ch = 64
        self.stage_names = []
        for stage, (blocks, ch) in enumerate(zip(num_blocks,
                                                 (64, 128, 256, 512))):
            names = []
            for b in range(blocks):
                name = f"group{stage}_block{b}"
                stride = 2 if (stage > 0 and b == 0) else 1
                setattr(self, name, Bottleneck(in_ch, ch, stride, norm))
                in_ch = ch * 4
                names.append(name)
            self.stage_names.append(names)
        if self.frozen_stages:
            frozen = [self.conv0, getattr(self, self.stem_norm)] + [
                getattr(self, name)
                for names in self.stage_names[:self.frozen_stages]
                for name in names]
            for module in frozen:
                module.requires_grad_(False)

    @property
    def frozen_stages(self) -> int:
        """Stages whose output the gradient stops at (stem included)."""
        return max(0, min(self.freeze_at - 1, len(self.stage_names)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = to_nchw(x.to(self.dtype))
        x = F.relu(getattr(self, self.stem_norm)(self.conv0(x)))
        # 3x3/2 max-pool, padding 1 on every side with -inf
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for stage, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if stage < self.frozen_stages:
                x = x.detach()
            feats.append(to_nhwc(x))
        return tuple(feats)
