"""COCO mAP evaluation of the port (``eksml_tpu/evalcoco``): COCOeval
semantics without pycocotools (``cocoeval.py``), the mask/RLE hot loops
in C++ (``native_src/maskops.cc``, bound by ``native.py``), and the
periodic-eval runner (``runner.py``).

Across ranks each rank predicts its shard of val2017; the detections are
gathered to rank 0, which accumulates.
"""

from eksml_tpu_torch.evalcoco.cocoeval import COCOEvaluator  # noqa: F401
from eksml_tpu_torch.evalcoco.runner import (make_eval_fn,  # noqa: F401
                                             run_evaluation)
