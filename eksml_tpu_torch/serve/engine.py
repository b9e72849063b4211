"""Bucket- and rung-padded predict dispatch (``eksml_tpu/serve/engine.py``).

Every request image is padded into the loader's bucket schedule and
every micro-batch up to a fixed batch rung, so the set of shapes the
model ever sees is finite.  :meth:`InferenceEngine.warmup` runs one
forward at every (bucket, rung): that loads the CUDA kernels, runs
cuDNN's autotune for each convolution shape and warms the caching
allocator before ``/healthz`` turns 200.  PyTorch runs eagerly, so a
"compile" here is the first forward at a shape; ``request_path_compiles``
counts shapes first seen after warmup and must stay 0.

Every forward runs on one engine-owned thread: PyTorch keeps cuDNN's
autotune results per thread, so a warmup on the caller's thread would
leave the dispatcher's first batch to autotune again.

Hot-reload (``serve/reload.py`` drives it): the model holds its
weights, so :meth:`InferenceEngine.swap_params` copies the serving model
on the device and loads the restored ``state_dict`` into the copy on the
caller's thread, off the request path, then swaps the ``(model, step)``
pair under the engine lock.  The dispatcher takes one
:meth:`~InferenceEngine.params_snapshot` per micro-batch, so a batch
never splits across checkpoints and names the step that computed it.
The shapes do not change, so the warm shape set (and cuDNN's autotune
cache, keyed by shapes) serves the new weights: ``request_path_compiles``
stays 0 across a swap.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from eksml_tpu_torch import telemetry
from eksml_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)


def _serve_knobs(cfg) -> Dict:
    from eksml_tpu_torch.config import SERVE_DEFAULTS, knobs_with_defaults

    return knobs_with_defaults(getattr(cfg, "SERVE", None), SERVE_DEFAULTS)


def bucket_schedule(cfg) -> List[Tuple[int, int]]:
    """Serving (H, W) canvases, area-ascending: ``SERVE.BUCKETS``, else
    ``PREPROC.BUCKETS``, else ``(MAX_SIZE, MAX_SIZE)``."""
    knobs = _serve_knobs(cfg)
    buckets = tuple(knobs["BUCKETS"] or ()) \
        or tuple(getattr(cfg.PREPROC, "BUCKETS", ()) or ())
    if not buckets:
        m = int(cfg.PREPROC.MAX_SIZE)
        buckets = ((m, m),)
    return sorted(((int(b[0]), int(b[1])) for b in buckets),
                  key=lambda b: b[0] * b[1])


def batch_rungs(cfg) -> List[int]:
    """Batch sizes warmed at startup, ascending; a batch pads up to the
    smallest rung that holds it."""
    knobs = _serve_knobs(cfg)
    max_bs = int(knobs["MAX_BATCH_SIZE"])
    sizes = knobs["BATCH_SIZES"]
    if isinstance(sizes, int):
        sizes = (sizes,)
    rungs = tuple(int(b) for b in (sizes or ()))
    if not rungs:
        rungs = (1, max_bs)
    return sorted(set(r for r in rungs if 1 <= r <= max_bs)) or [1]


class InferenceEngine:
    """Padded predict dispatch on one device.  Thread-safe: the set of
    seen shapes and the serving ``(model, params_step)`` pair are
    guarded by a lock.

    Params: ``params`` (a ``MaskRCNN`` state_dict), or the model of a
    training checkpoint under ``checkpoint_dir`` (a training logdir) at
    ``checkpoint_step``; "latest" resolves at construction, so
    ``params_step`` names a real step (None for handed-in params)."""

    def __init__(self, cfg, params=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_step: Optional[int] = None,
                 model=None, device="cuda"):
        from eksml_tpu_torch.models import MaskRCNN

        self.device = resolve_device(device)
        if params is None:
            if not checkpoint_dir:
                raise ValueError("need params (a MaskRCNN state_dict) or "
                                 "checkpoint_dir")
            from eksml_tpu_torch.predict.predictor import \
                restore_predict_params
            from eksml_tpu_torch.utils.checkpoint import CheckpointManager

            if checkpoint_step is None:
                checkpoint_step = CheckpointManager(
                    checkpoint_dir).latest_step()
                if checkpoint_step is None:
                    raise FileNotFoundError(
                        f"no checkpoints under {checkpoint_dir}")
            params = restore_predict_params(cfg, checkpoint_dir,
                                            checkpoint_step)
        self.cfg = cfg
        self.model = model if model is not None \
            else MaskRCNN.from_config(cfg)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        self.params_step: Optional[int] = (
            int(checkpoint_step) if checkpoint_step is not None else None)
        self.buckets = bucket_schedule(cfg)
        self.rungs = batch_rungs(cfg)
        self.max_batch = self.rungs[-1]
        self.device_normalize = bool(
            getattr(cfg.PREPROC, "DEVICE_NORMALIZE", False))
        self.mean = np.asarray(cfg.PREPROC.PIXEL_MEAN, np.float32)
        self.std = np.asarray(cfg.PREPROC.PIXEL_STD, np.float32)
        self._image_dtype = (np.uint8 if self.device_normalize
                             else np.float32)

        self._lock = threading.Lock()
        self._device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="eksml-engine")
        self._exes: Set[Tuple[int, int]] = set()
        self.compiles = 0                # shapes ever run
        self.request_path_compiles = 0   # shapes first run AFTER warmup
        self.warmed = False
        reg = telemetry.default_registry()
        self._m_compiles = reg.counter(
            "eksml_serve_aot_compiles",
            "serving predict shapes first run (warmup + lazy)")
        self._m_cold = reg.counter(
            "eksml_serve_request_path_compiles",
            "predict shapes first run on the request path AFTER warmup — "
            "nonzero means a shape escaped the bucket/rung schedule")
        self._m_warm = reg.gauge(
            "eksml_serve_warm_executables",
            "predict shapes warmed so far")
        self._m_warm.set_function(lambda: len(self._exes))

    # -- hot-reload (serve/reload.py drives these) ---------------------

    def params_snapshot(self):
        """One consistent ``(model, step)`` pair for one micro-batch."""
        with self._lock:
            return self.model, self.params_step

    def swap_params(self, new_params: Dict[str, torch.Tensor],
                    step: Optional[int] = None) -> None:
        """Serve ``new_params`` (a restored ``state_dict``) as ``step``.

        The names, shapes and dtypes must equal the serving model's (the
        warm shapes were run with them); any mismatch raises ValueError
        and the old weights keep serving.  The new model (a copy of the
        serving one on the device, loaded with ``new_params``) is made
        here, on the caller's thread; only the reference swap holds the
        engine lock, so in-flight batches finish on the old model."""
        serving = self.model
        old = serving.state_dict()
        if set(new_params) != set(old):
            raise ValueError(
                "params names changed: missing "
                f"{sorted(set(old) - set(new_params))[:5]}, unexpected "
                f"{sorted(set(new_params) - set(old))[:5]} — the warm "
                "shapes would not accept this checkpoint")
        for k, o in old.items():
            n = new_params[k]
            if tuple(n.shape) != tuple(o.shape) or n.dtype != o.dtype:
                raise ValueError(
                    f"params tensor {k} changed {tuple(o.shape)}/{o.dtype} "
                    f"-> {tuple(n.shape)}/{n.dtype} — the warm shapes would "
                    "not accept this checkpoint")
        model = copy.deepcopy(serving)
        model.load_state_dict(new_params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._lock:
            self.model = model
            self.params_step = int(step) if step is not None else None

    # -- preprocessing (the bucket contract) ---------------------------

    def assign(self, h: int, w: int) -> int:
        """Bucket index for an original ``(h, w)`` image; oversized
        images force-fit into the largest bucket."""
        from eksml_tpu_torch.data.loader import assign_bucket

        return assign_bucket(h, w, int(self.cfg.PREPROC.TEST_SHORT_EDGE_SIZE),
                             int(self.cfg.PREPROC.MAX_SIZE), self.buckets)

    def preprocess(self, image: np.ndarray
                   ) -> Tuple[np.ndarray, float, Tuple[int, int], int]:
        """Image → (bucket canvas, scale, (nh, nw), bucket index); uint8
        canvas under PREPROC.DEVICE_NORMALIZE, normalized f32 otherwise."""
        from eksml_tpu_torch.data.loader import quantize_uint8, resize_and_pad

        h, w = image.shape[:2]
        b = self.assign(h, w)
        im, scale, (nh, nw) = resize_and_pad(
            image, int(self.cfg.PREPROC.TEST_SHORT_EDGE_SIZE),
            int(self.cfg.PREPROC.MAX_SIZE), pad_hw=self.buckets[b])
        if self.device_normalize:
            return quantize_uint8(im), scale, (nh, nw), b
        return ((im - self.mean) / self.std).astype(np.float32), \
            scale, (nh, nw), b

    # -- shapes --------------------------------------------------------

    def rung_for(self, n: int) -> int:
        """Smallest warmed batch rung holding ``n`` requests."""
        for r in self.rungs:
            if n <= r:
                return r
        raise ValueError(
            f"batch of {n} exceeds the largest warmed rung "
            f"{self.rungs[-1]} — the batcher must split it")

    def _note_shape(self, bucket: int, rung: int) -> None:
        key = (bucket, rung)
        with self._lock:
            if key in self._exes:
                return
            self._exes.add(key)
            self.compiles += 1
            cold = self.warmed
            if cold:
                self.request_path_compiles += 1
        self._m_compiles.inc()
        if cold:
            self._m_cold.inc()
            log.warning("request-path first run of bucket=%s batch=%d "
                        "AFTER warmup — a shape escaped the warmed schedule",
                        self.buckets[bucket], rung)

    def warmup(self) -> int:
        """One forward at every bucket × batch rung; returns the count of
        warmed shapes.  ``/healthz`` turns 200 only after this.  The C++
        host libraries (the request path's resize and RLE) are built and
        loaded here too, not by the first request."""
        from eksml_tpu_torch._native import build_all

        build_all()
        for b, (bh, bw) in enumerate(self.buckets):
            for r in self.rungs:
                t0 = time.perf_counter()
                images = np.zeros((r, bh, bw, 3), self._image_dtype)
                hw = np.tile(np.asarray([[bh, bw]], np.float32), (r, 1))
                self.infer(images, hw, b, rung=r)
                log.info("warmed serve shape bucket=%dx%d batch=%d in %.1fs",
                         bh, bw, r, time.perf_counter() - t0)
        self.warmed = True
        return len(self._exes)

    # -- dispatch ------------------------------------------------------

    def infer(self, images: np.ndarray, hw: np.ndarray, bucket: int,
              rung: Optional[int] = None,
              model=None) -> Dict[str, np.ndarray]:
        """Run ``n`` preprocessed canvases (``[n, H, W, 3]`` at the
        bucket's shape, ``hw [n, 2]`` content extents) at the batch
        ``rung`` (default: the smallest that holds ``n``), padding the
        batch with zero images whose content extent is 1×1, through
        ``model`` (default: the serving one, see :meth:`params_snapshot`).
        Returns numpy outputs for the ``n`` real rows only."""
        if model is None:
            model = self.params_snapshot()[0]
        n = int(images.shape[0])
        if rung is None:
            rung = self.rung_for(n)
        elif n > rung:
            raise ValueError(f"batch of {n} does not fit rung {rung}")
        self._note_shape(bucket, rung)
        if n < rung:
            pad_img = np.zeros((rung - n,) + images.shape[1:], images.dtype)
            images = np.concatenate([images, pad_img], axis=0)
            # content extent 1×1 for padding rows: every box clips to a
            # point and NMS sees only invalid rows
            pad_hw = np.ones((rung - n, 2), np.float32)
            hw = np.concatenate([hw.astype(np.float32), pad_hw], axis=0)
        return self._device_thread.submit(self._forward, model, images, hw,
                                          n).result()

    def _forward(self, model, images: np.ndarray, hw: np.ndarray,
                 n: int) -> Dict[str, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        h = torch.from_numpy(np.ascontiguousarray(hw, np.float32)) \
            .to(self.device)
        out = model.predict(x, h)
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def close(self) -> None:
        """Stop the engine's device thread (after the batcher closed)."""
        self._device_thread.shutdown(wait=True)
