"""Offline (notebook-style) prediction on the serving engine."""

from eksml_tpu_torch.predict.predictor import (  # noqa: F401
    DetectionResult, OfflinePredictor, detections_from_raw)
