"""ImageNet-R50-AlignPadding.npz → the port's backbone parameters
(``eksml_tpu/models/backbone_loader.py``).

The file is a TensorPack-format flat dict of numpy arrays::

    conv0/W                      [7,7,3,64]   (HWIO)
    conv0/bn/gamma|beta|mean/EMA|variance/EMA
    group{g}_block{b}/conv{1,2,3}/W  + /bn/...
    group{g}_block{b}/convshortcut/W + /bn/...

:func:`load_r50_npz` writes those arrays into a ``MaskRCNN`` state dict
under the port's names (``backbone.conv0.weight`` in OIHW,
``backbone.FrozenBN_0.{scale,bias,mean,var}``,
``backbone.group{g}_block{b}.conv{1,2,3}`` / ``convshortcut`` with
``FrozenBN_{0..3}`` in declaration order).  Keys that are missing, or
whose shape does not match, keep their values (a partially matching npz
still loads).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# conv → the FrozenBN that follows it in a bottleneck block
_BN_OF = {"conv1": 0, "conv2": 1, "conv3": 2, "convshortcut": 3}
_BN_KEYS = (("scale", "gamma"), ("bias", "beta"), ("mean", "mean/EMA"),
            ("var", "variance/EMA"))


def load_r50_npz(path: str, state_dict: Dict[str, torch.Tensor]
                 ) -> Tuple[int, int]:
    """Copy the npz's backbone arrays into ``state_dict`` (in place, each
    cast to its tensor's dtype and device).  Returns ``(loaded,
    expected)``: arrays written, and five per conv of the backbone
    (kernel and four FrozenBN statistics)."""
    src = {k.replace(":0", ""): v for k, v in np.load(path).items()}
    prefix = "backbone."
    loaded = expected = 0

    def put(name: str, value) -> None:
        nonlocal loaded
        dst = state_dict.get(name)
        if value is None or dst is None:
            return
        value = np.asarray(value)
        if value.ndim == 4:                 # HWIO → OIHW
            value = value.transpose(3, 2, 0, 1)
        if tuple(dst.shape) == value.shape:
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            loaded += 1

    def conv_bn(conv: str, bn: str, key: str) -> None:
        nonlocal expected
        expected += 5
        put(f"{conv}.weight", src.get(f"{key}/W"))
        for ours, theirs in _BN_KEYS:
            put(f"{bn}.{ours}", src.get(f"{key}/bn/{theirs}"))

    if f"{prefix}conv0.weight" in state_dict:
        conv_bn(f"{prefix}conv0", f"{prefix}FrozenBN_0", "conv0")
    blocks = sorted({name[len(prefix):].split(".")[0]
                     for name in state_dict
                     if name.startswith(prefix + "group")})
    for block in blocks:
        for conv, bn in _BN_OF.items():
            if f"{prefix}{block}.{conv}.weight" in state_dict:
                conv_bn(f"{prefix}{block}.{conv}",
                        f"{prefix}{block}.FrozenBN_{bn}",
                        f"{block}/{conv}")
    return loaded, expected
