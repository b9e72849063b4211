"""Op-level microbench of the RPN's host-synchronising and wide ops (the
port's copy of ``tools/op_microbench.py``): the production NMS, anchor
matching and proposal generation, and vendored copies of the earlier
formulations, timed alone on identical inputs, so that their share of a
training step is read in seconds instead of from a profiled step::

    python -m eksml_tpu_torch.tools.op_microbench [--iters 20]
        [--image-size 1344] [--batch 4] [--pre-nms 2000]
        [--ops nms_new,nms_old,...] [--out FILE] [--bank]
        [--device cuda]

The ops, under the reference's names:

- ``nms_new``: ``ops/nms.nms_mask`` on one ``[K]`` set (score-sorted
  tiles, a fixed point inside each, one host sync per sweep);
- ``nms_old``: :func:`nms_mask_global_fixedpoint`, one fixed point over
  the whole ``[K, K]`` suppression matrix;
- ``nms_new_stacked``: ``nms_mask`` over ``[B, L, K]`` in one call, the
  way the port's RPN runs NMS over every image and FPN level of a step
  (``models/rpn.generate_proposals``: one batched call, the members
  iterating together; the reference ``jax.vmap``s one set at a time);
- ``nms_old_stacked``: the earlier formulation over the same ``[B, L, K]``
  batch in one call (its fixed point runs until no member changes);
- ``matching_ga``: ``models/rpn.match_anchors`` over ``[B, G, A]``;
- ``matching_ag``: :func:`match_anchors_ag`, the ``[A, G]`` orientation;
- ``proposals``: ``models/rpn.generate_proposals`` over the batch
  (top-k, decode, clip, NMS, the global top-k).

Inputs come from ``numpy.random.RandomState(0)`` in the reference's order
(clustered boxes, as RPN-decoded boxes cluster around objects).  Every
timed call ends on the device.  Prints one JSON object ``{device_kind,
params, results: {op: ms}, unit, new_minus_old_ms}``; ``--bank`` stamps
it and writes ``op_microbench_h100.json`` (a card whose name holds
``H100``; ``op_microbench_<gpu>.json`` another card) or
``op_microbench_cpu.json`` under ``--artifacts-dir``.  Runs on ``cuda``
unless ``--device cpu``, and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

TS_FMT = "%Y-%m-%dT%H:%M:%SZ"


def utcnow() -> str:
    return time.strftime(TS_FMT, time.gmtime())


def is_hardware(diag: dict, key: str = "device_kind") -> bool:
    """Whether a measurement's device field names an accelerator (not
    the CPU, not the host, not missing)."""
    return ((diag or {}).get(key) or "").lower() not in ("", "cpu", "host")


# ---------------------------------------------------------------------
# The earlier formulations, kept so that old against new is measured on
# identical inputs.  Not for use outside this tool.
# ---------------------------------------------------------------------

def nms_mask_global_fixedpoint(boxes: torch.Tensor, scores: torch.Tensor,
                               iou_threshold: float) -> torch.Tensor:
    """The pre-tiling formulation: one synchronous fixed point over the
    full ``[K, K]`` suppression matrix, over any leading batch dims
    (every member iterates until none changes; the fixed point is
    idempotent, so a converged member stays as it is).  One host sync
    per sweep."""
    from eksml_tpu_torch.ops.boxes import pairwise_iou

    k = boxes.shape[-2]
    order = torch.argsort(-scores, dim=-1, stable=True)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    svalid = torch.isfinite(torch.gather(scores, -1, order))
    iou = pairwise_iou(sboxes, sboxes)
    rank = torch.arange(k, device=boxes.device)
    sup = (iou > iou_threshold) & (rank[:, None] < rank[None, :])
    keep, prev, it = svalid, torch.zeros_like(svalid), 0
    while it < k and bool((keep != prev).any()):
        new = svalid & ~(sup & keep[..., :, None]).any(-2)
        keep, prev, it = new, keep, it + 1
    return torch.zeros_like(keep).scatter(-1, order, keep)


def match_anchors_ag(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_valid: torch.Tensor, pos: float, neg: float,
                     gt_crowd: torch.Tensor = None):
    """The ``[A, G]`` orientation of anchor matching, per image of a
    leading batch dim, with both of its full ``[A, G]`` reductions (the
    crowd pass runs even with the default all-zero crowd vector, as in
    the production code): ``(labels [B, A] int32, matched_gt [B, A])``.
    The force-match writes ``where(force, 1, labels[best])`` at every GT
    row's best anchor, duplicates included, as the earlier code did."""
    from eksml_tpu_torch.ops.boxes import pairwise_iou

    b = gt_boxes.shape[0]
    crowd = torch.zeros_like(gt_valid) if gt_crowd is None else gt_crowd
    target_ok = (gt_valid > 0) & (crowd == 0)                  # [B, G]
    iou_all = pairwise_iou(anchors.expand(b, *anchors.shape),
                           gt_boxes)                           # [B, A, G]
    iou = iou_all * target_ok[:, None, :].to(iou_all.dtype)
    best_iou, matched_gt = iou.amax(dim=2), iou.argmax(dim=2)
    labels = torch.full(best_iou.shape, -1, dtype=torch.int32,
                        device=anchors.device)
    labels = torch.where(best_iou < neg, 0, labels)
    labels = torch.where(best_iou >= pos, 1, labels)
    crowd_rows = ((gt_valid > 0) & (crowd > 0))[:, None, :]
    crowd_iou = (iou_all * crowd_rows.to(iou_all.dtype)).amax(dim=2)
    labels = torch.where((labels == 0) & (crowd_iou >= neg), -1, labels)
    best_anchor_per_gt = iou.argmax(dim=1)                     # [B, G]
    force = target_ok & (iou.amax(dim=1) > 1e-3)
    current = torch.gather(labels, 1, best_anchor_per_gt)
    labels = labels.scatter(1, best_anchor_per_gt,
                            torch.where(force, 1, current).to(labels.dtype))
    has_gt = target_ok.any(dim=1, keepdim=True)
    labels = torch.where(has_gt, labels,
                         torch.where(labels == 1, 0, labels))
    return labels, matched_gt


# ---------------------------------------------------------------------
# Realistic inputs: RPN-decoded boxes cluster around objects, which is
# exactly the regime that builds deep suppression chains.
# ---------------------------------------------------------------------

def clustered_boxes(rng, n, img, n_clusters=12):
    centers = rng.rand(n_clusters, 2) * img * 0.8 + img * 0.1
    which = rng.randint(0, n_clusters, size=n)
    ctr = centers[which] + rng.randn(n, 2) * img * 0.02
    size = np.exp(rng.randn(n) * 0.4) * img * 0.08
    ar = np.exp(rng.randn(n) * 0.25)
    w, h = size * ar, size / ar
    x1 = np.clip(ctr[:, 0] - w / 2, 0, img - 2)
    y1 = np.clip(ctr[:, 1] - h / 2, 0, img - 2)
    x2 = np.clip(x1 + w, None, img - 1)
    y2 = np.clip(y1 + h, None, img - 1)
    return np.stack([x1, y1, x2, y2], 1).astype(np.float32)


def make_inputs(image_size: int, batch: int, pre_nms: int,
                levels: int = 5) -> dict:
    """The reference's inputs, drawn from ``RandomState(0)`` in its order,
    as numpy arrays."""
    from eksml_tpu_torch.ops.anchors import generate_fpn_anchors

    rng = np.random.RandomState(0)
    img, k, b = image_size, pre_nms, batch
    # [B*L, K] stacked NMS inputs, plus a single [K] lane
    stack = np.stack([clustered_boxes(rng, k, img)
                      for _ in range(b * levels)])
    sscores = rng.rand(b * levels, k).astype(np.float32)
    strides = (4, 8, 16, 32, 64)
    anchors = generate_fpn_anchors((img, img), strides,
                                   tuple(s * 8 for s in strides),
                                   (0.5, 1.0, 2.0))
    g = 8
    gt = np.stack([clustered_boxes(rng, g, img) for _ in range(b)])
    gt_valid = (np.arange(g)[None, :]
                < rng.randint(2, g + 1, (b, 1))).astype(np.int32)
    # per-level proposal inputs for the end-to-end path
    logits = [rng.randn(b, a.shape[0]).astype(np.float32) for a in anchors]
    deltas = [(rng.randn(b, a.shape[0], 4) * 0.1).astype(np.float32)
              for a in anchors]
    return {"boxes": stack, "scores": sscores, "anchors": list(anchors),
            "gt": gt, "gt_valid": gt_valid, "logits": logits,
            "deltas": deltas,
            "hw": np.asarray([[img, img]] * b, np.float32)}


def build_ops(inputs: dict, device, batch: int, levels: int,
              pre_nms: int, thresh: float) -> dict:
    """``{name: (fn, args)}``: each op on the inputs moved to
    ``device``."""
    from eksml_tpu_torch.models.rpn import generate_proposals, match_anchors
    from eksml_tpu_torch.ops.nms import nms_mask

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    boxes_s, scores_s = on(inputs["boxes"]), on(inputs["scores"])
    k = boxes_s.shape[-2]
    # [B, L, K]: the batch the RPN hands nms_mask in a step
    boxes_bl = boxes_s.reshape(batch, levels, k, 4)
    scores_bl = scores_s.reshape(batch, levels, k)
    anchors_lv = [on(a) for a in inputs["anchors"]]
    anchors_all = torch.cat(anchors_lv, 0)
    gt, gt_valid = on(inputs["gt"]), on(inputs["gt_valid"])
    logits = [on(x) for x in inputs["logits"]]
    deltas = [on(x) for x in inputs["deltas"]]
    hw = on(inputs["hw"])
    return {
        "nms_new": (lambda b, s: nms_mask(b, s, thresh),
                    (boxes_s[0], scores_s[0])),
        "nms_old": (lambda b, s: nms_mask_global_fixedpoint(b, s, thresh),
                    (boxes_s[0], scores_s[0])),
        "nms_new_stacked": (lambda b, s: nms_mask(b, s, thresh),
                            (boxes_bl, scores_bl)),
        "nms_old_stacked": (
            lambda b, s: nms_mask_global_fixedpoint(b, s, thresh),
            (boxes_bl, scores_bl)),
        "matching_ga": (lambda g, v: match_anchors(anchors_all, g, v, 0.7,
                                                   0.3), (gt, gt_valid)),
        "matching_ag": (lambda g, v: match_anchors_ag(anchors_all, g, v,
                                                      0.7, 0.3),
                        (gt, gt_valid)),
        "proposals": (lambda lg, dl, h: generate_proposals(
            lg, dl, anchors_lv, h, pre_nms, 512, thresh),
            (logits, deltas, hw)),
    }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, args, iters: int, device, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls after ``warmup``, each call
    ended on the device."""
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
            _sync(device)
        total = 0.0
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            _sync(device)
            total += time.perf_counter() - t0
    return total / iters * 1000.0


def bank_name(out: dict) -> str:
    """``op_microbench_h100.json`` on an H100, ``op_microbench_cpu.json``
    where no accelerator ran."""
    if not is_hardware(out):
        return "op_microbench_cpu.json"
    kind = out["device_kind"].lower()
    return ("op_microbench_h100.json" if "h100" in kind else
            "op_microbench_" + "".join(c if c.isalnum() else "_"
                                       for c in kind) + ".json")


OPS = ("nms_new,nms_old,nms_new_stacked,nms_old_stacked,matching_ga,"
       "matching_ag,proposals")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="the RPN's NMS, matching and proposals timed alone")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--image-size", type=int, default=1344)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--pre-nms", type=int, default=2000)
    p.add_argument("--nms-thresh", type=float, default=0.7)
    p.add_argument("--ops", default=OPS)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--bank", action="store_true",
                   help="stamp the result and write it to "
                        "<artifacts-dir>/op_microbench_{h100,cpu}.json")
    p.add_argument("--artifacts-dir",
                   default=os.path.join(os.path.dirname(os.path.dirname(
                       os.path.dirname(os.path.abspath(__file__)))),
                       "artifacts", "h100"))
    return p.parse_args(argv)


def main(argv=None, on_inputs=None) -> dict:
    """Time the ops; print, write and return the JSON object.
    ``on_inputs(ops)``, if given, sees every op's arguments before any
    runs."""
    args = parse_args(argv)

    from eksml_tpu_torch.device import resolve_device
    from eksml_tpu_torch.fsio import atomic_write_text

    device = resolve_device(args.device)
    img, k, b, levels = args.image_size, args.pre_nms, args.batch, 5
    inputs = make_inputs(img, b, k, levels)
    a_total = sum(a.shape[0] for a in inputs["anchors"])
    ops = build_ops(inputs, device, b, levels, k, args.nms_thresh)
    if on_inputs is not None:
        on_inputs(ops)

    wanted = [w.strip() for w in args.ops.split(",") if w.strip()]
    bad = [w for w in wanted if w not in ops]
    if bad:
        raise SystemExit(f"unknown ops {bad}; known: {sorted(ops)}")

    results = {}
    for name in wanted:
        fn, a = ops[name]
        try:
            results[name] = round(timeit(fn, a, args.iters, device), 3)
        except Exception as e:  # noqa: BLE001 — record, keep measuring
            results[name] = f"ERROR: {type(e).__name__}: {e}"[:300]
        print(f"{name}: {results[name]}", file=sys.stderr)

    from eksml_tpu_torch.ops.nms import NMS_TILE
    from eksml_tpu_torch.tools.bench import card_name_and_limit

    out = {
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "card": card_name_and_limit(device),
        "torch": torch.__version__,
        "params": {"image_size": img, "batch": b, "pre_nms": k,
                   "levels": levels, "anchors_total": int(a_total),
                   "iters": args.iters, "nms_tile": str(NMS_TILE)},
        "results": results,
        "unit": "ms_per_call",
    }
    # how much each rewrite moved on identical inputs (negative: the
    # new formulation is faster)
    deltas = {}
    for new, old in (("nms_new", "nms_old"),
                     ("nms_new_stacked", "nms_old_stacked"),
                     ("matching_ga", "matching_ag")):
        x, y = results.get(new), results.get(old)
        if isinstance(x, (int, float)) and isinstance(y, (int, float)):
            deltas[f"{new}_minus_{old}"] = round(x - y, 3)
    if deltas:
        out["new_minus_old_ms"] = deltas
    print(json.dumps(out), flush=True)
    if args.out:
        atomic_write_text(args.out, json.dumps(out) + "\n")
    if args.bank:
        out["banked_at"] = utcnow()
        path = os.path.join(args.artifacts_dir, bank_name(out))
        os.makedirs(args.artifacts_dir, exist_ok=True)
        atomic_write_text(path, json.dumps(out) + "\n")
        print(f"op_microbench: banked to {path}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
