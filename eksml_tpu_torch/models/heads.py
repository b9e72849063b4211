"""Second-stage heads (``eksml_tpu/models/heads.py``: ``BoxHead``,
``MaskHead``).  Proposal-target sampling and the losses belong to
training."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eksml_tpu_torch.models.resnet import SameConv2d, to_nchw


class BoxHead(nn.Module):
    """2-FC head → per-class logits and per-class box deltas.  ROI
    features flatten in (row, column, channel) order, as in the
    reference."""

    def __init__(self, in_dim: int, num_classes: int = 81,
                 fc_dim: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.fc6 = nn.Linear(in_dim, fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc_dim)
        setattr(self, "class", nn.Linear(fc_dim, num_classes))
        self.box = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[N, P, P, C]`` → logits ``[N, K]``, deltas ``[N, K, 4]``."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        logits = getattr(self, "class")(x)
        return logits, self.box(x).reshape(-1, self.num_classes, 4)


class MaskHead(nn.Module):
    """4x conv3x3 + 2x2/2 transposed conv + 1x1 per-class logits."""

    def __init__(self, in_ch: int, num_classes: int = 81, dim: int = 256):
        super().__init__()
        for i in range(4):
            setattr(self, f"fcn{i}", SameConv2d(in_ch if i == 0 else dim,
                                                dim, 3))
        self.deconv = nn.ConvTranspose2d(dim, dim, 2, stride=2)
        self.conv = SameConv2d(dim, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """``[N, P, P, C]`` NHWC → logits ``[N, 2P, 2P, K]`` NHWC."""
        x = to_nchw(roi_feats)
        for i in range(4):
            x = F.relu(getattr(self, f"fcn{i}")(x))
        x = F.relu(self.deconv(x))
        return self.conv(x).permute(0, 2, 3, 1)
