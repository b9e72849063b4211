"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    no CUDA device is present (the port never falls back to the CPU on
    its own — a caller that wants the CPU passes ``device="cpu"``).

    On CUDA this also pins true float32 (cuDNN convolutions default to
    TF32, which keeps about three decimal digits, while the reference
    computes ``TRAIN.PRECISION=float32`` in full float32) and turns on
    cuDNN's autotune, which the serving warmup runs for every shape."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
    return dev
