"""Online inference serving on the port:

    HTTP POST /v1/predict ──▶ MicroBatcher (bounded queue, dynamic
    (serve/server.py)          micro-batches) ──▶ InferenceEngine
                               (bucket/rung padding, every shape warmed
                               before /healthz turns 200) ──▶ MaskRCNN
                               on the card ──▶ DetectionResult JSON
"""

from eksml_tpu_torch.serve.batcher import (DrainingError,  # noqa: F401
                                           MicroBatcher, QueueFullError,
                                           ServeError)
from eksml_tpu_torch.serve.engine import (InferenceEngine,  # noqa: F401
                                          batch_rungs, bucket_schedule)
from eksml_tpu_torch.serve.server import ServingServer  # noqa: F401
