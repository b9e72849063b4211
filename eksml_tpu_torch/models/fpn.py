"""Feature Pyramid Network (``eksml_tpu/models/fpn.py``): lateral 1x1,
top-down nearest 2x upsample, 3x3 output convs, P6 as the stride-2
subsample of P5 (a 1x1/2 max-pool).  The convolutions run in the
compute ``dtype`` (TRAIN.PRECISION) the inputs are cast to, on
parameters in their storage dtype (``models/resnet.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eksml_tpu_torch.models.resnet import SameConv2d, to_nchw, to_nhwc


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 num_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral_{i + 2}", SameConv2d(c, num_channels, 1))
            setattr(self, f"posthoc_{i + 2}",
                    SameConv2d(num_channels, num_channels, 3))
        self.num_levels = len(in_channels)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        """C2..C5 NHWC → (P2, P3, P4, P5, P6) NHWC."""
        laterals = [getattr(self, f"lateral_{i + 2}")(
            to_nchw(c.to(self.dtype))) for i, c in enumerate(feats)]
        merged = [laterals[-1]]
        for lat in laterals[-2::-1]:
            merged.append(lat + F.interpolate(merged[-1], scale_factor=2,
                                              mode="nearest"))
        merged = merged[::-1]
        outs = [getattr(self, f"posthoc_{i + 2}")(m)
                for i, m in enumerate(merged)]
        p6 = outs[-1][:, :, ::2, ::2]
        return tuple(to_nhwc(o) for o in outs + [p6])
