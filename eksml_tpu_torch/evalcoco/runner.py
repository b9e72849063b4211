"""Periodic COCO evaluation across ranks (``eksml_tpu/evalcoco/
runner.py``): run the detector over val2017, compute box and mask AP and
hand the scalars to the trainer's metric writer.

Protocol: every rank predicts its shard ``records[rank::world]`` with its
own local model (under FSDP2 the trainer hands in an unsharded replica),
so the ranks' batch counts and canvases are free to differ (they do under
``PREPROC.BUCKETS``).  The ONLY collective is the final gather of the
detection lists, which every rank enters exactly once, on the error path
too; padding rows carry image_id -1.  Do NOT add per-batch collectives to
the predict loop: a rank with fewer batches would leave the others
waiting forever.
"""

from __future__ import annotations

import logging
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from eksml_tpu_torch.data.coco import load_image
from eksml_tpu_torch.data.loader import (_resized_hw, quantize_uint8,
                                         resize_and_pad)
from eksml_tpu_torch.data.masks import (paste_mask, polygon_fill, rle_decode,
                                        rle_encode)
from eksml_tpu_torch.device import resolve_device
from eksml_tpu_torch.evalcoco.cocoeval import COCOEvaluator
from eksml_tpu_torch.parallel.distributed import (collective_device,
                                                  process_count,
                                                  process_index)
from eksml_tpu_torch.utils.compile_cache import choose_cudnn_algorithms

log = logging.getLogger(__name__)


def _gt_full_mask(rec: Dict, idx: int) -> np.ndarray:
    """Rasterize GT annotation ``idx`` to a full-image binary mask."""
    seg = rec["segmentation"][idx]
    h, w = rec["height"], rec["width"]
    if seg is None:
        x1, y1, x2, y2 = rec["boxes"][idx].astype(int)
        m = np.zeros((h, w), np.uint8)
        m[max(y1, 0):y2, max(x1, 0):x2] = 1
        return m
    if isinstance(seg, dict):
        return rle_decode(seg, h, w)
    m = np.zeros((h, w), np.uint8)
    for poly in seg:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        m |= polygon_fill(p, h, w)
    return m


def build_gt_records(records: List[Dict], with_masks: bool) -> List[Dict]:
    """Evaluator GT format: original-coordinate boxes + (RLE) masks.
    Areas come from the segmentation when present (COCO convention)."""
    out = []
    for rec in records:
        entry = {
            "image_id": rec["image_id"],
            "boxes": rec["boxes"],
            "classes": rec["classes"],
            "iscrowd": rec["iscrowd"],
        }
        if "area" in rec:
            entry["areas"] = rec["area"]
        if with_masks:
            entry["masks"] = [rle_encode(_gt_full_mask(rec, i))
                              for i in range(len(rec["boxes"]))]
        out.append(entry)
    return out


def predict(model, images: torch.Tensor, hw: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    """The default predict function: ``MaskRCNN.predict`` (under
    ``torch.inference_mode``) on the caller's thread, whose cuDNN
    autotune cache the trainer's own steps filled."""
    return model.predict(images, hw)


def _gather_detection_lists(host_dets: List[Dict], failed: bool
                            ) -> Tuple[List[Dict], List[int]]:
    """All-gather each rank's (variable-size, RLE-bearing) detection list
    over the default group: one all-gather of ``[length, failed]``, then
    one of the pickled lists padded to the longest as ``uint8`` (NCCL
    needs equal sizes; CUDA tensors on this rank's card under NCCL, CPU
    tensors under gloo).  Returns rank 0's view of every rank's
    detections (empty elsewhere) and the ranks that failed."""
    dev = collective_device()
    world = dist.get_world_size()
    payload = np.frombuffer(pickle.dumps(host_dets), np.uint8)
    meta = torch.tensor([payload.size, int(failed)], dtype=torch.int64,
                        device=dev)
    metas = [torch.empty_like(meta) for _ in range(world)]
    dist.all_gather(metas, meta)
    metas = [tuple(int(x) for x in m.tolist()) for m in metas]
    buf = torch.zeros(max(n for n, _ in metas), dtype=torch.uint8,
                      device=dev)
    buf[:payload.size] = torch.from_numpy(payload.copy()).to(dev)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    failed_ranks = [r for r, (_, f) in enumerate(metas) if f]
    out: List[Dict] = []
    if dist.get_rank() == 0 and not failed_ranks:
        for b, (n, _) in zip(bufs, metas):
            out.extend(pickle.loads(b[:n].cpu().numpy().tobytes()))
    return out, failed_ranks


def _plan(cfg, shard: List[Dict], n_records: int, world: int,
          batch_size: int) -> List[Tuple[Tuple[int, int], List]]:
    """Batch plan ``[(canvas_hw, [rec|None, ...]), ...]``.  With
    ``PREPROC.BUCKETS`` the shard is grouped by canvas and each batch pads
    to its group's (H, W); a record that fits no bucket at test
    resolution goes to the square ``(MAX_SIZE, MAX_SIZE)`` canvas (eval
    never downscales below the test resolution).  Without buckets every
    rank runs the same number of batches on the square canvas, padded
    with ``None`` rows."""
    max_size = cfg.PREPROC.MAX_SIZE
    short = cfg.PREPROC.TEST_SHORT_EDGE_SIZE
    buckets = tuple(sorted(
        (tuple(int(x) for x in b) for b in (cfg.PREPROC.BUCKETS or ())),
        key=lambda b: b[0] * b[1]))
    plan = []
    if buckets:
        groups: Dict[tuple, List] = {}
        for rec in shard:
            _, nh, nw = _resized_hw(rec["height"], rec["width"], short,
                                    max_size)
            canvas = next((b for b in buckets if nh <= b[0] and nw <= b[1]),
                          (max_size, max_size))
            groups.setdefault(canvas, []).append(rec)
        for canvas in sorted(groups):
            grp = groups[canvas]
            for o in range(0, len(grp), batch_size):
                chunk = grp[o:o + batch_size]
                chunk += [None] * (batch_size - len(chunk))
                plan.append((canvas, chunk))
        return plan
    per_rank = max((n_records + world - 1) // world, 1)
    n_batches = (per_rank + batch_size - 1) // batch_size
    padded = list(shard) + [None] * (n_batches * batch_size - len(shard))
    return [((max_size, max_size),
             padded[b * batch_size:(b + 1) * batch_size])
            for b in range(n_batches)]


def run_evaluation(model, cfg, records: List[Dict],
                   batch_size: Optional[int] = None,
                   max_images: Optional[int] = None,
                   predict_fn: Optional[Callable] = None,
                   gt_records: Optional[List[Dict]] = None,
                   device="cuda",
                   timings: Optional[Dict] = None) -> Dict[str, float]:
    """Evaluate ``model`` (on ``device``) on COCO ``records``; returns the
    AP dict on rank 0 and ``{}`` on the other ranks.

    - Every rank predicts ``records[rank::world]`` in batches of
      ``TEST.EVAL_BATCH_SIZE`` (:func:`_plan`); the next batch's images
      are loaded and resized on a worker thread while the current one
      predicts.
    - ``predict_fn(model, images, hw)`` (default :func:`predict`) runs on
      the caller's thread on tensors on ``device`` and returns the
      predict dict (tensors or arrays).
    - Each rank pastes and RLE-encodes its own images' masks on a
      bounded post-processing pool, so the gather ships compressed RLEs.
    - Under a process group (of any size) the gather
      (:func:`_gather_detection_lists`) is the only collective; a rank
      whose predict raised still enters it, and then every rank raises.
    - ``gt_records``: the evaluator GT (:func:`build_gt_records`), reused
      across periodic evals; rebuilt when None.
    - ``timings``: filled with the wall seconds of each batch's build
      (``build_s``) and predict (``predict_s``, up to the host copy of
      its outputs), the summed post-processing seconds, images and kept
      detections of this rank (``post_s``, ``post_images``,
      ``detections``), ``accumulate_s`` and ``wall_s``.
    """
    device = resolve_device(device)
    # an eval inside a training process keeps the trainer's choice
    choose_cudnn_algorithms(cfg, "eval", keep_process_policy=True)
    t0 = time.perf_counter()
    timings = {} if timings is None else timings
    timings.update(build_s=[], predict_s=[], post_s=0.0, post_images=0,
                   accumulate_s=0.0)
    with_masks = bool(cfg.MODE_MASK)
    if max_images:
        records = records[:max_images]
    if batch_size is None:
        batch_size = max(1, int(cfg.TEST.EVAL_BATCH_SIZE))
    world, rank = process_count(), process_index()
    shard = records[rank::world]
    by_id = {rec["image_id"]: rec for rec in records}
    max_size = cfg.PREPROC.MAX_SIZE
    short = cfg.PREPROC.TEST_SHORT_EDGE_SIZE
    mean = np.asarray(cfg.PREPROC.PIXEL_MEAN, np.float32)
    std = np.asarray(cfg.PREPROC.PIXEL_STD, np.float32)
    device_norm = bool(getattr(cfg.PREPROC, "DEVICE_NORMALIZE", False))
    predict_fn = predict_fn or predict

    def build_batch(plan, b: int):
        t_build = time.perf_counter()
        canvas, chunk = plan[b]
        images = np.zeros((batch_size,) + canvas + (3,),
                          np.uint8 if device_norm else np.float32)
        hw = np.ones((batch_size, 2), np.float32)
        scales = np.ones(batch_size, np.float32)
        ids = np.full(batch_size, -1, np.int64)
        for i, rec in enumerate(chunk):
            if rec is None:
                continue
            img = (rec["_image"] if rec.get("_image") is not None
                   else load_image(rec["path"]))
            im, scale, (nh, nw) = resize_and_pad(img, short, max_size,
                                                 pad_hw=canvas)
            if device_norm:  # the model folds (x-mean)/std into its input
                images[i] = quantize_uint8(im)
            else:
                images[i] = (im - mean) / std
            hw[i] = (nh, nw)
            scales[i] = scale
            ids[i] = rec["image_id"]
        timings["build_s"].append(time.perf_counter() - t_build)
        return images, hw, scales, ids

    def postprocess_row(iid, keep, row_boxes, row_scores, row_classes,
                        row_masks, scale):
        """Per-image host work: rescale to original coordinates, paste
        and RLE-encode the masks (on a pool, overlapping the next
        predict)."""
        t_post = time.perf_counter()
        boxes = (row_boxes[keep] / scale).astype(np.float32)
        det = {
            "image_id": iid,
            "boxes": boxes,
            "scores": row_scores[keep].astype(np.float32),
            "classes": row_classes[keep].astype(np.int32),
        }
        if row_masks is not None:
            rec = by_id[iid]
            h, w = rec["height"], rec["width"]
            det["rles"] = [rle_encode(paste_mask(m, bx, h, w))
                           for m, bx in zip(row_masks[keep], boxes)]
        det["_post_s"] = time.perf_counter() - t_post
        return det

    def to_numpy(out) -> Dict[str, np.ndarray]:
        return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in out.items()}

    post_workers = max(1, int(getattr(cfg.DATA, "NUM_WORKERS", 0) or 1))
    # bounded pipeline: a queued row pins its batch's output arrays, so
    # cap the outstanding rows to a few batches' worth; worker errors
    # surface within ~2 batches
    max_pending = max(post_workers, 2 * batch_size)
    host_dets: List[Dict] = []
    error: Optional[BaseException] = None
    try:
        plan = _plan(cfg, shard, len(records), world, batch_size)
        n_batches = len(plan)  # 0 possible: an empty shard in bucket mode
        pending: List = []
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="eval-batch") as pool, \
                ThreadPoolExecutor(max_workers=post_workers,
                                   thread_name_prefix="eval-post"
                                   ) as post_pool:
            nxt = pool.submit(build_batch, plan, 0) if n_batches else None
            for b in range(n_batches):
                images, hw, scales, ids = nxt.result()
                if b + 1 < n_batches:
                    nxt = pool.submit(build_batch, plan, b + 1)
                t_pred = time.perf_counter()
                out = to_numpy(predict_fn(
                    model, torch.from_numpy(images).to(device),
                    torch.from_numpy(hw).to(device)))
                timings["predict_s"].append(time.perf_counter() - t_pred)
                for i in range(batch_size):
                    iid = int(ids[i])
                    if iid < 0:
                        continue  # padding row
                    pending.append(post_pool.submit(
                        postprocess_row, iid, out["valid"][i] > 0,
                        out["boxes"][i], out["scores"][i],
                        out["classes"][i],
                        (out["masks"][i] if with_masks and "masks" in out
                         else None), scales[i]))
                    while len(pending) > max_pending:  # FIFO keeps order
                        host_dets.append(pending.pop(0).result())
            host_dets.extend(f.result() for f in pending)
    except Exception as e:  # noqa: BLE001 — re-raised after the gather
        if not dist.is_initialized():
            raise
        error = e
        log.exception("eval on rank %d failed; entering the gather so the "
                      "other ranks do not wait forever", rank)
    for det in host_dets:
        timings["post_s"] += det.pop("_post_s")
    timings["post_images"] = len(host_dets)
    timings["detections"] = sum(len(det["boxes"]) for det in host_dets)

    if dist.is_initialized():
        all_dets, failed = _gather_detection_lists(host_dets,
                                                   error is not None)
        if error is not None:
            raise error
        if failed:
            raise RuntimeError(f"eval failed on rank(s) {failed}; see "
                               "their logs")
    else:
        all_dets = host_dets

    results: Dict[str, float] = {}
    if rank == 0:
        t_acc = time.perf_counter()
        gt = (gt_records if gt_records is not None
              else build_gt_records(records, with_masks))
        bbox_ev = COCOEvaluator(gt, cfg.DATA.NUM_CLASSES, "bbox",
                                max_dets=cfg.TEST.RESULTS_PER_IM)
        segm_ev = (COCOEvaluator(gt, cfg.DATA.NUM_CLASSES, "segm",
                                 max_dets=cfg.TEST.RESULTS_PER_IM)
                   if with_masks else None)
        for det in all_dets:
            iid = det["image_id"]
            if iid not in by_id:
                continue
            bbox_ev.add_detections(iid, det["boxes"], det["scores"],
                                   det["classes"])
            if segm_ev is not None and "rles" in det:
                segm_ev.add_detections(iid, det["boxes"], det["scores"],
                                       det["classes"], masks=det["rles"])
        for name, ev in (("bbox", bbox_ev), ("segm", segm_ev)):
            if ev is None:
                continue
            for k, v in ev.accumulate().items():
                results[f"{name}/{k}"] = v
        timings["accumulate_s"] = time.perf_counter() - t_acc
        log.info("eval: %d images in %.1fs — bbox AP %.4f%s",
                 len(records), time.perf_counter() - t0,
                 results.get("bbox/AP", -1),
                 (f", segm AP {results['segm/AP']:.4f}"
                  if "segm/AP" in results else ""))
    timings["wall_s"] = time.perf_counter() - t0
    return results


def make_eval_fn(cfg, device="cuda", records: Optional[List[Dict]] = None,
                 predict_fn: Optional[Callable] = None,
                 timings: Optional[Dict] = None) -> Callable:
    """Eval hook for the Trainer: ``eval_fn(model, step)`` → metric dict.
    The val records are read once (``DATA.BASEDIR``/``DATA.VAL`` through
    ``CocoDataset``, or ``records`` as given), and rank 0 builds the GT
    once; ``timings`` receives each run's (see :func:`run_evaluation`)."""
    from eksml_tpu_torch.data.coco import CocoDataset

    device = resolve_device(device)
    # an eval inside a training process keeps the trainer's choice
    choose_cudnn_algorithms(cfg, "eval", keep_process_policy=True)
    state: Dict = {}

    def eval_fn(model, step):
        if "records" not in state:
            state["records"] = (
                records if records is not None else CocoDataset(
                    cfg.DATA.BASEDIR, cfg.DATA.VAL).records(skip_empty=False))
            # GT rasterization/RLE is identical every eval: build it once
            if process_index() == 0:
                state["gt"] = build_gt_records(state["records"],
                                               bool(cfg.MODE_MASK))
        return run_evaluation(model, cfg, state["records"],
                              predict_fn=predict_fn,
                              gt_records=state.get("gt"), device=device,
                              timings=timings)

    return eval_fn
