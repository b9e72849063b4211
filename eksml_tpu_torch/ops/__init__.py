"""Detection ops: boxes, anchors, NMS and ROIAlign (plain PyTorch), with
the hand-written CUDA kernels under ``ops/cuda``."""
