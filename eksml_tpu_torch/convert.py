"""Parameters for the port's ``MaskRCNN``: from a Flax tree, or seeded.

``from_flax`` maps the reference's Flax ``MaskRCNN`` parameter tree
(nested dicts of numpy arrays, e.g. ``jax.device_get(params)``) onto the
port's ``state_dict``; module names match, so only layouts change:

- conv kernels HWIO → OIHW;
- dense kernels ``(in, out)`` → Linear weights ``(out, in)``;
- the mask head's transposed conv: Flax's ``ConvTranspose`` does not
  flip its kernel and ``conv_transpose2d`` does, so HWIO is flipped in H
  and W, then laid out IOHW;
- FrozenBN ``scale/bias/mean/var`` and biases are copied.

``init_params`` is the port's own seeded init, following Flax's
defaults: lecun-normal kernels (truncated normal, variance 1/fan_in),
zero biases, FrozenBN ones and zeros.  It draws from a ``torch.Generator``
and gives other numbers than ``jax.random`` for the same seed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# Flax's truncated-normal initializer divides the stddev by the
# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``MaskRCNN`` params → the port's ``state_dict`` (float32)."""
    sd = {}
    for name, v in _flatten(params).items():
        v = np.asarray(v, np.float32)
        if name.endswith(".kernel"):
            base = name[:-len(".kernel")]
            if v.ndim == 2:
                w = v.T
            elif base.endswith("maskrcnn.deconv"):
                w = v[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                w = v.transpose(3, 2, 0, 1)
            sd[base + ".weight"] = torch.from_numpy(np.array(w, np.float32))
        else:
            sd[name] = torch.from_numpy(np.array(v, np.float32))
    return sd


def init_params(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded float32 ``state_dict`` on the CPU for
    ``MaskRCNN.from_config(cfg)`` (load it, then move the model to its
    device)."""
    from eksml_tpu_torch.models.mask_rcnn import MaskRCNN

    with torch.device("meta"):
        shapes = MaskRCNN.from_config(cfg).state_dict()
    sd = {}
    for name, t in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith(".weight") and t.dim() >= 2:
            if t.dim() == 2:                       # Linear (out, in)
                fan_in = t.shape[1]
            elif name.endswith("maskrcnn.deconv.weight"):
                fan_in = t.shape[0] * t.shape[2] * t.shape[3]  # (I, O, H, W)
            else:
                fan_in = t.shape[1] * t.shape[2] * t.shape[3]  # (O, I, H, W)
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            w = torch.empty(t.shape, dtype=torch.float32, device="cpu")
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            sd[name] = w
        elif leaf in ("scale", "var"):
            sd[name] = torch.ones(t.shape, dtype=torch.float32)
        else:                                      # biases, FrozenBN shifts
            sd[name] = torch.zeros(t.shape, dtype=torch.float32)
    return sd
