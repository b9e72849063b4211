"""Mask-RCNN R50-FPN in PyTorch."""

from eksml_tpu_torch.models.mask_rcnn import MaskRCNN  # noqa: F401
