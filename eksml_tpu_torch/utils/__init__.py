"""Checkpoints and metric writing of the port's trainer."""

from eksml_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: F401
from eksml_tpu_torch.utils.metrics import MetricWriter  # noqa: F401
