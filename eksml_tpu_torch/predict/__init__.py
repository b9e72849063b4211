"""Offline (notebook-style) prediction on the serving engine, and the
detection overlay (``viz.draw_final_outputs``)."""

from eksml_tpu_torch.predict.predictor import (  # noqa: F401
    DetectionResult, OfflinePredictor, detections_from_raw, predict_image)
from eksml_tpu_torch.predict.viz import draw_final_outputs  # noqa: F401
