"""Single-image detector on the serving engine
(``eksml_tpu/predict/predictor.py``: ``restore_predict_params``,
``DetectionResult``, ``detections_from_raw``, ``OfflinePredictor``,
``predict_image``).

``OfflinePredictor`` runs through the same bucket-padded
``InferenceEngine`` the online server dispatches, with params handed in
or restored from a training checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger(__name__)


def restore_predict_params(cfg, logdir: str, step: Optional[int] = None
                           ) -> Dict:
    """The model ``state_dict`` (on the CPU) of the trainer's checkpoint
    ``step`` (default: the latest) under the training ``logdir``.  ONE
    definition for the predictor, the serving engine and the reload
    manager: all load exactly what the trainer saved.  ``cfg`` is the
    reference's argument (its restore rebuilds a state skeleton); the
    port's checkpoint carries its own structure.

    Float tensors come back in float32 whatever ``TRAIN.PARAM_DTYPE``
    stored: the reference restores into a skeleton of freshly
    initialized, float32 params, and its restore casts to them.  So a
    bfloat16-storage checkpoint serves (and hot-reloads into a float32
    engine) with its values exactly, widened."""
    from eksml_tpu_torch.utils.checkpoint import CheckpointManager

    ckpt = CheckpointManager(logdir)
    step = ckpt.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {logdir}")
    log.info("restoring checkpoint step %d from %s", step, logdir)
    # mapped: the optimizer's half of the file is never read
    model = ckpt.restore(step, mmap=True)["model"]
    return {k: v.float() if v.is_floating_point() else v
            for k, v in model.items()}


@dataclasses.dataclass
class DetectionResult:
    """One detection in original-image coordinates."""
    box: np.ndarray          # xyxy, float32
    score: float
    class_id: int
    mask: Optional[np.ndarray] = None   # full-image uint8, or None


def detections_from_raw(out_i: Dict[str, np.ndarray], scale: float,
                        h: int, w: int, thresh: float,
                        want_masks: bool = True) -> List[DetectionResult]:
    """One image's raw predict rows (resized coordinates: boxes [D, 4],
    scores [D], classes [D], valid [D], optional masks [D, mr, mr]) →
    :class:`DetectionResult` list in ORIGINAL-image coordinates, best
    first.  The one postprocess of the predictor and the batcher."""
    from eksml_tpu_torch.data.masks import paste_mask

    results: List[DetectionResult] = []
    for i in range(out_i["boxes"].shape[0]):
        if out_i["valid"][i] <= 0 or out_i["scores"][i] < thresh:
            continue
        box = out_i["boxes"][i] / scale
        box = np.clip(box, 0, [w, h, w, h]).astype(np.float32)
        mask = None
        if want_masks and "masks" in out_i:
            mask = paste_mask(out_i["masks"][i], box, h, w)
        results.append(DetectionResult(
            box=box, score=float(out_i["scores"][i]),
            class_id=int(out_i["classes"][i]), mask=mask))
    results.sort(key=lambda r: -r.score)
    return results


class OfflinePredictor:
    """Builds the engine once; call repeatedly with images."""

    def __init__(self, cfg, params=None, checkpoint_dir: Optional[str] = None,
                 checkpoint_step: Optional[int] = None, model=None,
                 device="cuda"):
        from eksml_tpu_torch.serve.engine import InferenceEngine

        self.cfg = cfg
        # the engine resolves the device (raising without CUDA) and
        # restores the checkpoint when no params are handed in
        self._engine = InferenceEngine(
            cfg, params=params, checkpoint_dir=checkpoint_dir,
            checkpoint_step=checkpoint_step, model=model, device=device)

    def raw(self, image: np.ndarray):
        """Raw outputs in RESIZED-image coordinates and the resize
        scale: ``({boxes, scores, classes, valid[, masks]}, scale)``, each
        ``[1, RESULTS_PER_IM, ...]`` numpy."""
        canvas, scale, (nh, nw), bucket = self._engine.preprocess(image)
        hw = np.asarray([nh, nw], np.float32)
        return self._engine.infer(canvas[None], hw[None], bucket), scale

    def __call__(self, image: np.ndarray,
                 score_thresh: Optional[float] = None
                 ) -> List[DetectionResult]:
        """Single-image inference in original coordinates."""
        h, w = image.shape[:2]
        out, scale = self.raw(image)
        thresh = (self.cfg.TEST.RESULT_SCORE_THRESH
                  if score_thresh is None else score_thresh)
        return detections_from_raw(
            {k: v[0] for k, v in out.items()}, scale, h, w, thresh)


def predict_image(img: np.ndarray,
                  predictor: OfflinePredictor) -> List[DetectionResult]:
    """Same call shape as TensorPack's ``predict_image(img, pred)``
    (the viz notebook's): ``predictor(img)``."""
    return predictor(img)
