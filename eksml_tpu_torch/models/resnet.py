"""ResNet backbone with FrozenBN (``eksml_tpu/models/resnet.py``).

Public boundaries are NHWC like the reference; inside, the convolutions
run on the NCHW view of the same memory (``permute(0, 3, 1, 2)`` of an
NHWC tensor is channels-last NCHW, which cuDNN convolves without a
copy).  Submodule names follow the Flax parameter tree, so
``convert.from_flax`` maps parameters by name.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with Flax's ``SAME`` padding, on NCHW input."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_padding(x.shape[2], k, s)
        left, right = same_padding(x.shape[3], k, s)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, s, (top, left))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, s)


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


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(in_ch, channels, 1, bias=False)
        self.FrozenBN_0 = FrozenBN(channels)
        self.conv2 = SameConv2d(channels, channels, 3, stride, bias=False)
        self.FrozenBN_1 = FrozenBN(channels)
        self.conv3 = SameConv2d(channels, channels * 4, 1, bias=False)
        self.FrozenBN_2 = FrozenBN(channels * 4)
        # the reference adds the projection whenever shapes differ: the
        # first block of every stage
        self.has_shortcut = stride != 1 or in_ch != channels * 4
        if self.has_shortcut:
            self.convshortcut = SameConv2d(in_ch, channels * 4, 1, stride,
                                           bias=False)
            self.FrozenBN_3 = FrozenBN(channels * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.FrozenBN_0(self.conv1(x)))
        out = F.relu(self.FrozenBN_1(self.conv2(out)))
        out = self.FrozenBN_2(self.conv3(out))
        residual = x
        if self.has_shortcut:
            residual = self.FrozenBN_3(self.convshortcut(x))
        return F.relu(out + residual)


class ResNetBackbone(nn.Module):
    """NHWC images → C2..C5 NHWC (strides 4, 8, 16, 32).
    ``num_blocks=(3, 4, 6, 3)`` is R50, ``(3, 4, 23, 3)`` R101.

    ``freeze_at`` (BACKBONE.FREEZE_AT): the reference stops the gradient
    at the output of every stage with ``stage + 2 <= freeze_at``
    (``resnet.py:121-125``), so the stem and those stages get zero
    gradient.  Here their parameters do not require grad and the last
    frozen stage's output is detached; under SGD, with weight decay on
    trainable kernels only, that is the same update."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 freeze_at: int = 2):
        super().__init__()
        self.freeze_at = freeze_at
        self.conv0 = SameConv2d(3, 64, 7, 2, bias=False)
        self.FrozenBN_0 = FrozenBN(64)
        in_ch = 64
        self.stage_names = []
        for stage, (blocks, ch) in enumerate(zip(num_blocks,
                                                 (64, 128, 256, 512))):
            names = []
            for b in range(blocks):
                name = f"group{stage}_block{b}"
                stride = 2 if (stage > 0 and b == 0) else 1
                setattr(self, name, Bottleneck(in_ch, ch, stride))
                in_ch = ch * 4
                names.append(name)
            self.stage_names.append(names)
        if self.frozen_stages:
            frozen = [self.conv0] + [
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
        x = F.relu(self.FrozenBN_0(self.conv0(to_nchw(x))))
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
