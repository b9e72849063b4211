#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``eksml_tpu_torch``) on one CUDA card.

Phases (any failure raises and exits non-zero; nothing falls back):

1. build   — compile every CUDA source of the port with nvcc (all at
             once) and print the build time and nvcc's register/spill
             summary; compile and load the two C++ host libraries (the
             eval's mask ops, the loader's resize) with g++ and print
             their g++ seconds.
2. kernel  — hold each kernel against its plain PyTorch version on the
             card at the shapes the main paths give it and time both
             with CUDA events and torch.profiler: the ROIAlign forward
             at predict's two calls and training's three (box, mask, and
             the mask targets: one level, one channel), the forward's
             training calls and the backward's also on clustered ROIs,
             the backward at training's two, in float32 and bfloat16,
             and the accumulator copy on the four level shapes; then
             each kernel's calls in one training step.
3. serve   — default config (R50-FPN, 81 classes, FPN 256, one 1344²
             bucket, batch rungs (1, 4), uint8 input, float32) with
             seeded random weights: start the port's ServingServer,
             warm it up, POST 8 images of mixed sizes concurrently to
             /v1/predict, and check the answers, the zero request-path
             compiles and that the ROIAlign kernel launched twice per
             dispatched batch.
4. reference — the card's forward against the same weights on the CPU
             on a small canvas (features, ROIAlign in context, box head).
5. profile — one batch-4 forward at the 1344² bucket and, with the
             train phase, one training step under torch.profiler:
             device time by kernel and the device's busy share of the
             wall time.
6. train   — default training config (R50-FPN at full width and depth,
             1344² canvas, batch 4, float32) with seeded random weights,
             writing into a temporary logdir: 6 steps of Trainer.fit over
             the port's DetectionLoader, the losses, grad_norm and step
             times, peak memory, and the three kernels' launches per step.
7. lifecycle — at the same width, in-process on the train phase's
             thread (cuDNN's autotune cache is per thread): a second
             Trainer on the train phase's logdir restores its last step,
             bitwise equal to the live state, and both take one step on
             one batch; ``eksml_tpu_torch.train.main`` trains to step 3
             (checkpoints 2 and 3), then relaunched to 5 resumes from 3;
             the serve phase's engine hot-reloads step 5 through
             ReloadManager and answers 4 requests at step 5 with zero
             request-path compiles.  Prints the checkpoint bytes, the
             save's blocking and background times, the restore time and
             the reload's restore and swap times.
8. dist    — after the train phase, in-process on its thread: a
             world-size-1 NCCL group; 6 steps of Trainer.fit under
             ``replicated`` (DDP) and 6 under ``fsdp`` (FSDP2) from the
             train phase's weights and batches: step 1 and the median of
             steps 2-6, peak memory, state bytes per device, launches per
             step (3 / 2 / 8) and the losses against the train phase's
             (``DIST_STEP1_TOL``, ``DIST_LOSS_TOL``); the replica sync
             check; the FSDP2
             checkpoint's gather time, then its restore into a Trainer
             without a group, bitwise.
9. ranks   — with two or more devices, two ranks of
             ``python -m eksml_tpu_torch.train`` under ``fsdp`` formed by
             the JobSet env (same losses on both, one checkpoint); with
             one, a line saying so.
10. train_reference — one training step on the card against the CPU at
             SMOKE widths on a 256² canvas: losses, every gradient and
             every update, and the mask targets.
11. eval    — after the train phase, in-process on its thread with its
             Trainer and weights: ``Trainer._run_eval`` once over 32
             shapes val images (landscape and portrait around 640x480,
             made here with numpy; the annotation JSON read back through
             the port's CocoDataset, the pixels on each record's
             ``_image``) at the default config (1344² canvas,
             ``TEST.EVAL_BATCH_SIZE=4``): eval wall time and images/s,
             the first batch apart from the median of the rest, batch
             build per batch, paste + RLE per image, accumulate, the
             ROIAlign forward launches per batch (2), the AP dict and the
             peak memory.  AP after 6 steps from random weights is near 0.
12. eval_reference — SMOKE widths, 256² canvas, ``PREPROC.BUCKETS=
             ((192,256),(256,192),(256,256))``, 8 shapes images:
             ``run_evaluation`` on the card and on the CPU from the same
             weights (detections to the serve parity tolerances, AP to
             1e-6), and one bucketed training step on the card from the
             file-backed loader.
13. coco    — where PIL imports: the shapes dataset written as JPEGs and
             ``eksml_tpu_torch.train.main`` without ``--synthetic`` for 2
             steps at SMOKE widths with ``TRAIN.EVAL_PERIOD=1`` (val/bbox
             and val/segm AP in metrics.jsonl); where it does not, a line
             saying so.  With two or more devices the ranks phase also
             evaluates the 2-rank run's checkpoint under FSDP2 as 2 ranks
             (``--eval-rank``) and compares rank 0's AP with one process.

After lifecycle, the serving fleet and the elastic operator:

fleet    — the GPU serve chart's stable and canary tracks (its golden
             rendering's ``--config``: bf16, one 1344² bucket, rungs 1 and
             4) in this process on the lifecycle phase's checkpoints, each
             with its own engine, server, ReloadManager and flight
             recorder: ``eksml_tpu_torch.tools.serve_loadtest``'s closed
             loop at concurrency 1, 4 and 8 and an open loop at half the
             rate, a shadow replay of a 32-request bank, the promotion
             controller to a promote and to a rollback, the ROIAlign
             forward's launches (2 per dispatched batch over both tracks),
             then the chart's command as a subprocess (healthz, 4
             requests, SIGTERM drain).
operator — ``python -m eksml_tpu_torch.tools.eksml_operator --mode
             local`` at SMOKE widths on a capacity file going 1 -> 2 -> 1:
             NCCL ranks with two or more cards; with one, gloo ranks on
             the CPU, and on the card a refused 1 -> 2 and a stopped and
             relaunched world-1 trainer.  Each transition's downtime.

The variant phases (train_bf16, serve_bf16, cascade,
variants_reference) are described at their functions.  Last:

observe — the trainer's telemetry at full width: ``train.main`` in f32
             (1344², batch 4) with the chart's telemetry on an ephemeral
             port (``TELEMETRY.HEALTHZ_STALE_SEC``, tracing, goodput) and
             ``--profile 2`` while a thread scrapes /metrics (the
             preregistered families, a moving goodput ratio), /healthz
             (200, then 503 while the loader stalls past the bound),
             /debugz/profile (200, then 429 in the cooldown) and
             /debugz/stacks; the span trace, the goodput bank against
             the run's wall time, the kernels' launches; the capture's
             device time by component (the three kernels under roi-fwd
             and roi-bwd, "other" at most 30 %); the same capture at the
             bf16 + REMAT point, then 20 more one-step captures in this
             process, the last still holding the kernels; the
             mask-target call's host time against its kernel; the step
             median with the telemetry layer off and fully on.

roofline — the training step's H100 roofline (``profiling/predict.py``)
             through ``python -m eksml_tpu_torch.tools.bench``'s rungs in
             this process, on the train phases' autotuned thread: the f32
             and the bf16 + REMAT steps at 1344², batch 4, and the
             ladder's ``1344_b8_remat`` rung.  Each: step 1 and the
             median step, the counted FLOPs and MFU, the predicted step
             by section and by component beside the observe phase's
             device-time shares, the predicted liveness peak (with its
             largest tensors) against ``torch.cuda.max_memory_allocated``,
             the kernels' launches.  Then ``tools/eval_ckpt.py`` on the
             lifecycle run's newest checkpoint over 8 shapes JPEGs, its
             AP equal to ``run_evaluation``'s on the same weights.

autotune — cuDNN's algorithm choice, paid at every process start
             (``utils/compile_cache.py``): the full autotune and autotune
             with ``benchmark_limit=2``, and at bf16 cuDNN's heuristics,
             each at the f32 and the bf16 + REMAT steps (1344², batch 4,
             the ladder's rung code), the f32 chart's step (batch 1) and
             the optimized overlay's (bf16, batch 4, 832x1344), and the
             serving engine (warmup, batch-4 forward) at f32 and bf16,
             each in a fresh
             process (all set up together, then timed one at a time) but
             where an earlier phase already measured the setting this
             process runs: step 1 (serving: the warmup), the median step
             with its interquartile range, the peaks and the launches;
             the rule's verdict per point and the policy it gives
             (PERF.md section 6), with ``compile_cache.POLICY`` held to
             those verdicts.

charts  — the GPU charts (``charts/{maskrcnn,serve,autoscaler}-gpu``)
             rendered by ``eksml_tpu_torch.tools.render_charts`` for a
             one-card install, their container commands run as the pods
             would (``/efs`` in a workdir, free ports, ``--total-steps``;
             each change printed): the default f32 chart through
             ``eksml_tpu_torch.launch`` for 40 steps at 1344² on shapes
             JPEGs and a stand-in R50 npz (every array loaded), its
             checkpoint and end-of-run eval, its TensorBoard event files
             (the port's reader) against its ``metrics.jsonl``, and the
             Jupyter pod's two viz notebooks run as scripts against it
             (detections, 2 forward launches each); the optimized overlay
             SIGTERMed after step 3 (the launcher exits 77 after the
             forced checkpoint) and relaunched (resumes at the next
             step, runs to the end); the serve chart's stable command on
             that run (``/healthz`` 200, 4 requests, drain rc 0); the
             autoscaler's argv through the operator's parser.  Each
             process's kernel launches, from the line it logs at exit;
             the restarts' times beside earlier runs' (PERF.md).

Then it prints one JSON line of kernel records, the card's name and power
limit, and, last, ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import base64
import copy
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# the kernels' closed form (footprints, bytes and operations, the bound
# on the data-sheet peaks), shared with the step's roofline
from eksml_tpu_torch.profiling.predict import (  # noqa: F401
    F32_FLOPS_PER_S, HBM_BYTES_PER_S, bound_of, bytes_and_ops, footprints,
    fpn_levels, roi_footprint, touched_pixels)

PHASES = ("build", "kernel", "serve", "reference", "profile", "train",
          "lifecycle", "fleet", "operator", "dist", "ranks",
          "train_reference", "eval",
          "eval_reference", "coco", "train_bf16", "serve_bf16", "cascade",
          "variants_reference", "observe", "roofline", "autotune", "charts")

# predict shapes at the 1344² canvas: P2..P5 and the two ROIAlign calls
CANVAS = 1344
LEVEL_STRIDES = (4, 8, 16, 32)
CHANNELS = 256
BATCH = 4
CALLS = (("box_head", 7, 1000), ("mask_head", 14, 100))
# training's ROIAlign backward calls: FRCNN.BATCH_PER_IM sampled ROIs
# (box head) and their fg prefix (mask head)
TRAIN_CALLS = (("box_head", 7, 512), ("mask_head", 14, 128))
# training's third ROIAlign call, the mask targets: per image the 128 fg
# ROIs, each aligned on its matched GT's 56² mask (one level, one
# channel, stride 1) to the 28² mask resolution
GT_MASK_SIZE = 56
MASK_TARGETS = ("mask_targets", 28, 128)
TRAIN_STEPS = 6
# the record of each kernel that the kernels line reports
STEP_CALL = "one training step"
# the same kernel's calls in one step of the bf16 training point and of
# the cascade (batch 1: three box stages, the mask head, the targets)
BF16_STEP_CALL = "one bf16 training step"
CASCADE_STEP_CALL = "one cascade training step"
CASCADE_BATCH = 1
CASCADE_STAGES = 3
BF16_EPS = 2.0 ** -8


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(walls: dict, name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall time kept in ``walls[name]`` and
    printed (also when it raises)."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        walls[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {walls[name]:.1f} s wall")


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------


def phase_build(kernels):
    from eksml_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    results = build.build(sorted({k.library for k in kernels}))
    log(f"[build] {len(results)} kernel(s) in "
        f"{time.perf_counter() - t0:.1f}s wall")
    for name, r in results.items():
        log(f"[build] {name}: {r.path} (nvcc {r.seconds:.1f}s"
            f"{', reused' if r.reused else ''})")
        for line in r.log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                log(f"[build]   {line.strip()}")
    from eksml_tpu_torch._native import build_all

    t0 = time.perf_counter()
    libs = build_all()
    for name, lib in libs.items():
        reused = "" if lib.build_seconds else ", reused"
        log(f"[build] host library {name}: {lib.lib_path} (g++ "
            f"{lib.build_seconds:.1f}s{reused}), loaded {lib.loaded}")
        assert lib.loaded, f"host library {name} did not load: {lib.error}"
    log(f"[build] host libraries in {time.perf_counter() - t0:.1f}s wall")


# ---------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------


def make_rois(rng: np.random.RandomState, n: int,
              kinds=None) -> np.ndarray:
    """[n, 4] xyxy boxes on the canvas: mostly log-uniform sizes, plus
    border-hugging, sub-pixel and larger-than-canvas boxes (``kinds``
    0-3, drawn 70/10/10/10 % unless given)."""
    if kinds is None:
        kinds = rng.choice(4, size=n, p=[0.7, 0.1, 0.1, 0.1])
    kinds = np.asarray(kinds)
    ctr = rng.rand(n, 2) * CANVAS
    size = np.exp(rng.uniform(np.log(4), np.log(CANVAS), n))
    ar = np.exp(rng.randn(n) * 0.5)
    w, h = size * ar, size / ar
    boxes = np.stack([ctr[:, 0] - w / 2, ctr[:, 1] - h / 2,
                      ctr[:, 0] + w / 2, ctr[:, 1] + h / 2], 1)
    boxes = np.clip(boxes, 0, CANVAS)
    border = kinds == 1     # touching or crossing the canvas edge
    e = rng.uniform(-20, 60, (n, 2))
    boxes[border, 0] = e[border, 0]
    boxes[border, 3] = CANVAS - e[border, 1]
    tiny = kinds == 2       # under a pixel wide or tall
    boxes[tiny, 2] = boxes[tiny, 0] + rng.uniform(0, 1.5, tiny.sum())
    boxes[tiny, 3] = boxes[tiny, 1] + rng.uniform(0, 1.5, tiny.sum())
    huge = kinds == 3       # larger than the canvas, P5 extent
    boxes[huge, :2] = rng.uniform(-300, 50, (huge.sum(), 2))
    boxes[huge, 2:] = rng.uniform(CANVAS - 50, CANVAS + 300, (huge.sum(), 2))
    return boxes.astype(np.float32)


def make_clustered_rois(rng: np.random.RandomState, n: int) -> np.ndarray:
    """[n, 4] ROIs of one image as the training sampler clusters them:
    the first quarter are copies of 1-8 seeded GT boxes jittered by 10 %
    of their side (the fg ROIs, which lead the sampled set, so the mask
    call's fg prefix is all of them), the rest as :func:`make_rois`."""
    rois = make_rois(rng, n)
    k = rng.randint(1, 9)
    gt = make_rois(rng, k, kinds=np.zeros(k, int))
    m = n // 4
    pick = gt[rng.randint(0, k, m)]
    side = np.tile(pick[:, 2:] - pick[:, :2], 2)
    rois[:m] = pick + rng.randn(m, 4) * 0.1 * side
    return rois.astype(np.float32)


def mask_target_inputs(rng: np.random.RandomState, n: int,
                       m0: int = GT_MASK_SIZE):
    """The mask-target call's inputs: ``n`` seeded binary GT masks
    (filled ellipses) ``[n, m0, m0, 1]`` float32, and one fg ROI per mask
    in that mask's pixel frame ``[n, 1, 4]``: the GT box ``(0, 0, m0,
    m0)`` jittered by 10 % of its side, as a proposal of IoU >= 0.5
    lies around its GT."""
    yy, xx = np.mgrid[:m0, :m0] + 0.5
    cy, cx = rng.uniform(0.3, 0.7, (2, n, 1, 1)) * m0
    ry, rx = rng.uniform(0.2, 0.5, (2, n, 1, 1)) * m0
    masks = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    rois = np.float32([0, 0, m0, m0]) + rng.randn(n, 4) * 0.1 * m0
    return (masks[..., None].astype(np.float32),
            rois[:, None, :].astype(np.float32))


def forward_reads(rois: np.ndarray, out_size: int, sampling: int, sizes,
                  strides):
    """Map pixels (per channel) that one forward call on ``rois``
    [B, N, 4] reads: (taps: one load per tap, R·out²·s²·4, as the
    rowwise design reads them; footprint: the sum over ROIs of footprint
    rows × columns, which the footprint design reads once per ROI;
    touched: the distinct pixels, which the bound counts)."""
    fp = sum(len(rows) * len(cols)
             for _, _, rows, cols in footprints(rois, out_size, sampling,
                                                sizes, strides))
    taps = rois.shape[0] * rois.shape[1] * out_size ** 2 * sampling ** 2 * 4
    return taps, fp, touched_pixels(rois, out_size, sampling, sizes, strides)


def backward_reductions(rois: np.ndarray, out_size: int, sampling: int,
                        channels: int, sizes, strides):
    """Global reductions of one backward call on ``rois`` [B, N, 4]:
    (footprint design: the sum over ROIs of footprint rows × columns ×
    C/4; one scalar atomic per tap per channel, as the per-tap layout
    without vector reductions issues them: R·out²·s²·4·C)."""
    groups = -(-channels // 4)
    fp = sum(len(rows) * len(cols) * groups
             for _, _, rows, cols in footprints(rois, out_size, sampling,
                                                sizes, strides))
    taps = rois.shape[0] * rois.shape[1] * out_size ** 2 * sampling ** 2 * 4
    return fp, taps * channels


def time_ms(fn, iters: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_repeats(fn, iters: int, warmup: int, repeats: int = 5):
    """(median, min, max) ms per call of ``fn`` over ``repeats`` CUDA-event
    timings of ``iters`` back-to-back calls each, every timing after its
    own ``warmup`` calls (so that launches are queued ahead of the start
    event, as in a single ``time_ms``)."""
    runs = sorted(time_ms(fn, iters, warmup) for _ in range(repeats))
    return runs[len(runs) // 2], runs[0], runs[-1]


def bf16_ulp(x):
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch

    a = x.abs().float()
    _, e = torch.frexp(a)
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    return torch.where(a == 0, torch.zeros_like(a), ulp)


def phase_kernel(kernels, seed: int):
    """Every kernel against its plain version at the main paths' shapes;
    returns {kernel name: [records]}."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats32 = tuple(
        torch.randn((BATCH, CANVAS // s, CANVAS // s, CHANNELS),
                    generator=gen, device=dev) for s in LEVEL_STRIDES)
    rng = np.random.RandomState(seed)
    records = {
        kernels.fwd.name: kernel_forward(
            kernels.fwd, feats32, rng, np.random.RandomState(seed + 1),
            np.random.RandomState(seed + 2)),
        kernels.bwd.name: kernel_backward(kernels, feats32, rng, gen),
        kernels.copy.name: kernel_copy(kernels.copy, feats32, gen),
    }
    for name, recs in kernel_cascade_step(
            kernels, feats32, np.random.RandomState(seed + 3), gen).items():
        records[name] += recs
    del feats32
    torch.cuda.empty_cache()
    return records


def _check(name, call, dtype, diff, want, scale):
    """float32: max error within 1e-5 of ``scale``; bfloat16: within one
    bfloat16 ulp of the plain value plus that allowance."""
    import torch

    err = float(diff.max())
    slack = 1e-5 * scale
    if dtype == torch.float32:
        ok = err <= slack
        tol_text = f"1e-5*scale = {slack:.3g}"
    else:
        ok = bool((diff <= bf16_ulp(want) + slack).all())
        tol_text = "1 bf16 ulp of the plain value + 1e-5*scale"
    dname = str(dtype).replace("torch.", "")
    log(f"[kernel] {name} {call} {dname}: max|kernel-plain| = {err:.3g} "
        f"(scale {scale:.3g}, tolerance {tol_text}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{call} {dname}: max error {err}")
    return err


def kernel_forward(kernel, feats32, rng, mask_rng, cluster_rng):
    """The forward kernel against ``batched_multilevel_roi_align`` at
    every call the main paths make: predict's two and training's box and
    mask calls on P2..P5 in float32 and bfloat16, training's two also on
    ROIs clustered as the sampler's (from ``cluster_rng``), and
    training's mask targets (float32, one level, one channel) on seeded
    masks from ``mask_rng``; then the sum of training's three calls on
    random ROIs in float32."""
    import torch

    dev = feats32[0].device
    n_max = max(n for _, _, n in CALLS + TRAIN_CALLS)
    rois_all = np.stack([make_rois(rng, n_max) for _ in range(BATCH)])
    n_train = max(n for _, _, n in TRAIN_CALLS)
    clustered = np.stack([make_clustered_rois(cluster_rng, n_train)
                          for _ in range(BATCH)])
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        feats = tuple(f.to(dtype) for f in feats32)
        fmax = max(float(f.float().abs().max()) for f in feats)
        for path, calls, set_name, roi_set in (
                ("predict", CALLS, "random", rois_all),
                ("train", TRAIN_CALLS, "random", rois_all),
                ("train", TRAIN_CALLS, "clustered", clustered)):
            for call, out_size, n in calls:
                rois_np = np.ascontiguousarray(roi_set[:, :n])
                records.append(_forward_call(
                    kernel, path, call, feats, rois_np, LEVEL_STRIDES,
                    out_size, fmax, set_name)[0])
        del feats
    call, out_size, n = MASK_TARGETS
    masks, mrois = mask_target_inputs(mask_rng, BATCH * n)
    rec, got, want = _forward_call(
        kernel, "train", call, (torch.from_numpy(masks).to(dev),), mrois,
        (1,), out_size, 1.0, "masks")
    # the targets are the samples thresholded at 0.5: a sum in another
    # order may flip a pixel only where the plain value lies at 0.5
    flips = (got >= 0.5) != (want >= 0.5)
    near = (want - 0.5).abs() <= 1e-6
    log(f"[kernel]   mask targets (>= 0.5) differ at {int(flips.sum())} of "
        f"{flips.numel()} pixels, {int((flips & near).sum())} of them "
        "within 1e-6 of 0.5")
    if bool((flips & ~near).any()):
        raise AssertionError("the mask targets of the kernel and of the "
                             "plain version differ away from 0.5")
    records.append(rec)
    records.append(_step_record([r for r in records if r["path"] == "train"
                                 and r["dtype"] == "float32"
                                 and r["rois_set"] != "clustered"]))
    # the bf16 training point: box and mask on bf16 features, the mask
    # targets stay float32 (one channel)
    records.append(_step_record(
        [r for r in records if r["path"] == "train"
         and r["dtype"] == "bfloat16" and r["rois_set"] == "random"]
        + [rec], call=BF16_STEP_CALL, dtype="bfloat16"))
    return records


def kernel_cascade_step(kernels, feats32, rng, gen):
    """Each kernel's calls in one Cascade R-CNN training step at the
    cascade phase's batch (1), float32, each held to its plain version
    and timed: the forward's three box stages (three seeded ROI sets of
    ``FRCNN.BATCH_PER_IM``, as the refined boxes differ per stage), the
    mask head's fg prefix and the mask targets; the backward's four
    calls; the copy held bitwise to ``clone()`` on the four batch-1 level
    shapes, then its 16 seeds (4 backward calls x 4 levels) as one
    sequence.  Returns {kernel name: [call records..., step record]}."""
    import torch

    dev = feats32[0].device
    feats = tuple(f[:CASCADE_BATCH].contiguous() for f in feats32)
    fmax = max(float(f.abs().max()) for f in feats)
    sizes = [tuple(f.shape[1:3]) for f in feats]
    (_, box_out, n_box), (_, mask_out, n_mask) = TRAIN_CALLS
    calls = [(f"box stage {i + 1}", box_out, n_box)
             for i in range(CASCADE_STAGES)] + [("mask_head", mask_out,
                                                n_mask)]
    fwd, bwd = [], []
    for call, out_size, n in calls:
        rois_np = np.stack([make_rois(rng, n) for _ in range(CASCADE_BATCH)])
        rec, _, _ = _forward_call(kernels.fwd, "cascade", call, feats,
                                  rois_np, LEVEL_STRIDES, out_size, fmax,
                                  "random")
        fwd.append(rec)
        g = torch.randn((CASCADE_BATCH, n, out_size, out_size, CHANNELS),
                        generator=gen, device=dev)
        bwd.append(_backward_call(kernels.bwd, feats, rois_np,
                                  torch.from_numpy(rois_np).to(dev), g,
                                  call, "random", out_size, sizes))
    call, out_size, n = MASK_TARGETS
    masks, mrois = mask_target_inputs(rng, CASCADE_BATCH * n)
    rec, _, _ = _forward_call(
        kernels.fwd, "cascade", call, (torch.from_numpy(masks).to(dev),),
        mrois, (1,), out_size, 1.0, "masks")
    fwd.append(rec)
    srcs = [torch.randn(f.shape, generator=gen, device=dev) for f in feats]
    copy = kernels.copy
    err = max(_copy_check(copy, s) for s in srcs)
    pairs = [(s, torch.empty_like(s)) for _ in calls for s in srcs]
    seeds = [s for s, _ in pairs]
    turns = time_in_turns({"kernel": lambda: [copy(s) for s in seeds],
                           "copy_": lambda: [d.copy_(s) for s, d in pairs],
                           "clone": lambda: [s.clone() for s in seeds]},
                          iters=10, warmup=2)
    log(f"[kernel] {copy.name} {CASCADE_STEP_CALL} ({len(calls)} backward "
        f"calls x {len(srcs)} levels, batch {CASCADE_BATCH}) in turns: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in turns.items()))
    copy_rec = _record("cascade", CASCADE_STEP_CALL, torch.float32, None,
                       None, err, turns["kernel"], turns["clone"],
                       turns["copy_"], sum(2 * s.numel() * 4 for s in seeds),
                       0)
    del srcs, seeds, pairs
    out = {kernels.fwd.name: fwd + [_step_record(fwd, CASCADE_STEP_CALL)],
           kernels.bwd.name: bwd + [_step_record(bwd, CASCADE_STEP_CALL)],
           kernels.copy.name: [copy_rec]}
    for recs in out.values():
        for r in recs:
            r["path"] = "cascade"
    return out


def _forward_call(kernel, path, call, feats, rois_np, strides, out_size,
                  scale, set_name):
    """One forward call on the ROI set ``set_name`` checked against the
    plain version (``scale``: the largest feature magnitude), timed beside
    it with CUDA events and torch.profiler, with the pixels each design
    reads; returns the record and both outputs."""
    import torch

    from eksml_tpu_torch.ops.roi_align import batched_multilevel_roi_align

    dtype = feats[0].dtype
    b, n = rois_np.shape[:2]
    rois = torch.from_numpy(rois_np).to(feats[0].device)
    got = kernel(feats, rois, strides, out_size)
    want = batched_multilevel_roi_align(feats, rois, strides, out_size)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    label = call if set_name != "clustered" else f"{call} {set_name}"
    err = _check(kernel.name, f"{path} {label} o={out_size} B*N={b}*{n} "
                 f"C={feats[0].shape[-1]} levels={len(feats)}", dtype, diff,
                 want.float(), scale)
    ms, lo, hi = time_repeats(lambda: kernel(feats, rois, strides,
                                             out_size), iters=20, warmup=3)
    profiled = device_ms(lambda: kernel(feats, rois, strides, out_size),
                         "roi_align_fwd_")
    log(f"[kernel]   median of 5 timings of 20 launches {ms:.4f} ms "
        f"(min {lo:.4f}, max {hi:.4f}); device-only (torch.profiler) "
        f"{_ms_text(profiled)}")
    plain_ms = time_ms(lambda: batched_multilevel_roi_align(
        feats, rois, strides, out_size), iters=3, warmup=1)
    sizes = [tuple(f.shape[1:3]) for f in feats]
    taps, fp, touched = forward_reads(rois_np, out_size, 2, sizes, strides)
    log(f"[kernel]   pixels read per channel: one per tap {taps / 1e6:.3f} "
        f"M, footprints {fp / 1e6:.3f} M, touched once {touched / 1e6:.3f} "
        "M")
    nbytes, ops = bytes_and_ops(
        rois_np, out_size, 2, feats[0].element_size(), sizes=sizes,
        strides=strides, channels=feats[0].shape[-1])
    rec = _record(path, label, dtype, out_size, b * n, err, ms, plain_ms,
                  None, nbytes, ops)
    rec.update(rois_set=set_name, device_ms=profiled, tap_pixels=taps,
               footprint_pixels=fp, touched_pixels=touched)
    return rec, got, want


def _step_record(records, call=STEP_CALL, dtype="float32"):
    """One training step's calls of a kernel (``records``), summed: the
    times as measured call by call (device-only where every call has
    one), the bound from the summed bytes and operations.  ``call`` names
    the step (the f32 training step by default), ``dtype`` its
    features'."""
    total = {k: sum(r[k] for r in records)
             for k in ("ms", "plain_ms", "bytes", "ops")}
    dev = [r.get("device_ms") for r in records]
    total["device_ms"] = None if None in dev else sum(dev)
    bound_ms, bound_by = bound_of(total["bytes"], total["ops"])
    log(f"[kernel]   {call} ({' + '.join(r['call'] for r in records)}"
        f"): kernel {total['ms']:.4f} ms (device-only "
        f"{_ms_text(total['device_ms'])}), plain {total['plain_ms']:.3f} ms, "
        f"bound {bound_ms * 1e3:.1f} us ({total['bytes'] / 1e6:.1f} MB, "
        f"{bound_by}), {bound_ms / total['ms'] * 100:.1f}% of bound")
    return {"path": "train", "call": call, "dtype": dtype,
            "max_abs_err": max(r["max_abs_err"] for r in records),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            **total}


#: torch.profiler windows this process has opened (device_ms,
#: profile_window and the trainer captures the observe phase drives)
PROFILER_WINDOWS = {"n": 0}
#: the device kernel of the one-element ``add_`` that primes a window
PRIMER_KERNEL = "CUDAFunctorOnSelf_add"


def prime_window():
    """The trainer's profiler primers (``train.CAPTURE_PRIMERS``
    one-element kernels), launched first in every window of this script:
    late in a long process a torch.profiler session loses a varying
    count of its first device records (PERF.md §6)."""
    import torch

    from eksml_tpu_torch.train import CAPTURE_PRIMERS

    primer = torch.zeros(1, device="cuda")
    for _ in range(CAPTURE_PRIMERS):
        primer.add_(1)


def device_ms(fn, match: str, iters: int = 10):
    """Device-only time per call of ``fn`` from torch.profiler: the
    self device time of the kernels whose name holds ``match``, summed
    over ``iters`` calls, over ``iters``; None where the profiler saw no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prime_window()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    PROFILER_WINDOWS["n"] += 1
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and match in e.key
             and PRIMER_KERNEL not in e.key)
    if us <= 0:
        log(f"[profiler] window {PROFILER_WINDOWS['n']} of this process saw "
            f"no device time for {match!r}")
    return us / 1e3 / iters if us > 0 else None


def _ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def time_in_turns(fns, iters: int, warmup: int):
    """{name: ms} for each of ``fns`` {name: callable}, timed in turns
    (a b c, then c b a) with CUDA events, the two turns averaged."""
    names = list(fns)
    times = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            times[k].append(time_ms(fns[k], iters=iters, warmup=warmup))
    return {k: sum(v) / len(v) for k, v in times.items()}


def kernel_backward(kernels, feats32, rng, gen):
    """The backward kernel against ``roi_align_backward_plain`` at
    training's two calls, on random ROIs and on ROIs clustered as the
    sampler's fg ROIs are, in float32 and bfloat16: the error per level,
    the spread between two launches, the global reductions per call, the
    time of back-to-back launches and the device-only time."""
    import torch

    dev = feats32[0].device
    kernel = kernels.bwd
    n_max = max(n for _, _, n in TRAIN_CALLS)
    roi_sets = {
        "random": np.stack([make_rois(rng, n_max) for _ in range(BATCH)]),
        "clustered": np.stack([make_clustered_rois(rng, n_max)
                               for _ in range(BATCH)])}
    sizes = [tuple(f.shape[1:3]) for f in feats32]
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        feats = tuple(f.to(dtype) for f in feats32)
        for call, out_size, n in TRAIN_CALLS:
            g = torch.randn((BATCH, n, out_size, out_size, CHANNELS),
                            generator=gen, device=dev).to(dtype)
            for set_name, rois_all in roi_sets.items():
                rois_np = np.ascontiguousarray(rois_all[:, :n])
                rois = torch.from_numpy(rois_np).to(dev)
                records.append(_backward_call(
                    kernel, feats, rois_np, rois, g, call, set_name,
                    out_size, sizes))
        del feats
    records.append(_step_record([r for r in records
                                 if r["dtype"] == "float32"
                                 and r["rois_set"] == "random"]))
    records.append(_step_record([r for r in records
                                 if r["dtype"] == "bfloat16"
                                 and r["rois_set"] == "random"
                                 and r["call"] != STEP_CALL],
                                call=BF16_STEP_CALL, dtype="bfloat16"))
    return records


def _backward_call(kernel, feats, rois_np, rois, g, call, set_name,
                   out_size, sizes):
    import torch

    from eksml_tpu_torch.ops.roi_align import roi_align_backward_plain

    dev = rois.device
    dtype = g.dtype
    b, n = rois_np.shape[:2]

    def fresh():
        return [torch.zeros(f.shape, dtype=torch.float32, device=dev)
                for f in feats]

    got = kernel(fresh(), rois, g, LEVEL_STRIDES, out_size)
    again = kernel(fresh(), rois, g, LEVEL_STRIDES, out_size)
    want = roi_align_backward_plain(feats, rois, g, LEVEL_STRIDES, out_size)
    torch.cuda.synchronize()
    spread = max(float((a - w).abs().max()) for a, w in zip(got, again))
    errs = []
    for lv, (a, w) in enumerate(zip(got, want)):
        w = w.float()
        scale = max(float(w.abs().max()), 1e-30)
        errs.append(_check(kernel.name, f"{call} {set_name} o={out_size} "
                           f"B*N={b}*{n} P{lv + 2}", dtype,
                           (a.to(dtype).float() - w).abs(), w, scale))
    del got, again, want
    fp, taps = backward_reductions(rois_np, out_size, 2, CHANNELS, sizes,
                                   LEVEL_STRIDES)
    log(f"[kernel]   global reductions per call: footprint {fp / 1e6:.2f} "
        f"M (float4); per tap {taps / 1e6:.1f} M scalar atomics "
        f"(R·out²·s²·4·C), {taps / 4e6:.1f} M as float4")
    accs = fresh()
    ms, lo, hi = time_repeats(lambda: kernel(accs, rois, g, LEVEL_STRIDES,
                                             out_size), iters=10, warmup=2)
    profiled = device_ms(lambda: kernel(accs, rois, g, LEVEL_STRIDES,
                                        out_size), "roi_align_bwd_")
    plain_ms = time_ms(lambda: roi_align_backward_plain(
        feats, rois, g, LEVEL_STRIDES, out_size), iters=2, warmup=1)
    del accs
    log(f"[kernel]   median of 5 timings of 10 launches {ms:.4f} ms (min "
        f"{lo:.4f}, max {hi:.4f}); device-only (torch.profiler) "
        f"{_ms_text(profiled)}")
    nbytes, ops = bytes_and_ops(rois_np, out_size, 2, g.element_size(),
                                backward=True, sizes=sizes,
                                strides=LEVEL_STRIDES, channels=CHANNELS)
    rec = _record("train", f"{call} {set_name}" if set_name != "random"
                  else call, dtype, out_size, b * n, max(errs),
                  ms, plain_ms, None, nbytes, ops)
    rec.update(rois_set=set_name, run_to_run_max_abs_diff=spread,
               device_ms=profiled,
               reductions=fp, scalar_atomics_per_tap=taps)
    log(f"[kernel]   two launches on the same inputs differ by at "
        f"most {spread:.3g} (float32 atomics, order varies)")
    return rec


def kernel_copy(kernel, feats32, gen):
    """The copy kernel bitwise against ``clone()`` on the four level
    shapes of the float32 accumulators, timed in turns beside ``clone()``
    and ``dst.copy_(src)``, with the device-only times of the kernel and
    of ``copy_`` from torch.profiler; then one training step's seeding
    (two backward calls, four levels each) timed as a whole."""
    import torch

    srcs = [torch.randn(f.shape, generator=gen, device=f.device)
            for f in feats32]
    dsts = [torch.empty_like(s) for s in srcs]
    records = []
    for src, dst in zip(srcs, dsts):
        err = _copy_check(kernel, src)
        shape = "x".join(str(d) for d in src.shape)
        turns = time_in_turns({"kernel": lambda: kernel(src),
                               "copy_": lambda: dst.copy_(src),
                               "clone": lambda: src.clone()},
                              iters=20, warmup=3)
        dev_ms = {"kernel": device_ms(lambda: kernel(src), "copy_bulk_kernel"),
                  "copy_": device_ms(lambda: dst.copy_(src), "")}
        log("[kernel]   in turns: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in turns.items())
            + "; device-only (torch.profiler): " + ", ".join(
                f"{k} {_ms_text(v)}" for k, v in dev_ms.items()))
        rec = _record("train", f"[{shape}]", torch.float32, None, None, err,
                      turns["kernel"], turns["clone"], turns["copy_"],
                      2 * src.numel() * 4, 0)
        rec["device_ms"] = dev_ms
        records.append(rec)
    backward_calls = 2
    pairs = [(s, d) for _ in range(backward_calls)
             for s, d in zip(srcs, dsts)]
    turns = time_in_turns(
        {"kernel": lambda: [kernel(s) for s, _ in pairs],
         "copy_": lambda: [d.copy_(s) for s, d in pairs],
         "clone": lambda: [s.clone() for s, _ in pairs]},
        iters=10, warmup=2)
    log(f"[kernel] {kernel.name} {STEP_CALL} ({backward_calls} backward "
        f"calls x {len(srcs)} levels) in turns: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in turns.items()))
    # (under bf16 the accumulators stay float32: the same 8 seeds, so the
    # bf16 step has no record of its own)
    records.append(_record("train", STEP_CALL, torch.float32, None, None,
                           max(r["max_abs_err"] for r in records),
                           turns["kernel"], turns["clone"], turns["copy_"],
                           sum(2 * s.numel() * 4 for s, _ in pairs), 0))
    del srcs, dsts, pairs
    return records


def _copy_check(kernel, src) -> float:
    """The copy kernel on ``src`` held bitwise to ``clone()``; returns
    the largest absolute difference (0.0, or it raises)."""
    import torch

    got = kernel(src)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), src.view(torch.int32))
    shape = "x".join(str(d) for d in src.shape)
    log(f"[kernel] {kernel.name} [{shape}] float32: bitwise equal to "
        f"clone() {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{kernel.name} differs from clone() at "
                             f"[{shape}]")
    return float((got - src).abs().max())


def _step_summary(recs, call):
    """The step record ``call`` of one kernel's records, in the kernels
    line's keys (None where the kernel phase made none)."""
    rec = next((r for r in recs if r["call"] == call), None)
    if rec is None:
        return None
    return {k: rec.get(k) for k in ("dtype", "path", "ms", "device_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "bytes", "max_abs_err")}


def _record(path, call, dtype, out_size, rois, err, ms, plain_ms,
            library_ms, nbytes, ops):
    bound_ms, bound_by = bound_of(nbytes, ops)
    log(f"[kernel]   kernel {ms:.4f} ms, plain {plain_ms:.3f} ms"
        + (f", library {library_ms:.4f} ms" if library_ms is not None
           else "")
        + f", bound {bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.2f} GFLOP), {bound_ms / ms * 100:.1f}% of bound")
    return {"path": path, "call": call,
            "dtype": str(dtype).replace("torch.", ""),
            "out_size": out_size, "rois": rois, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops}


# ---------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------


def serve_config():
    from eksml_tpu_torch.config import config, finalize_configs

    config.freeze(False)
    # a batch window long enough for 8 concurrent requests to coalesce
    config.update_args(["SERVE.MAX_BATCH_DELAY_MS=250"])
    return finalize_configs(is_training=False)


def post(url: str, img: np.ndarray, **params):
    payload = {"image_b64": base64.b64encode(img.tobytes()).decode(),
               "shape": list(img.shape), "dtype": "uint8", **params}
    req = urllib.request.Request(
        url + "/v1/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.load(resp)


def phase_serve(cfg, kernels, seed: int, tag: str = "serve"):
    """The serving path at ``cfg`` (the serve phase's default, or the
    serve_bf16 phase's bfloat16); returns the engine and the record."""
    import torch

    from eksml_tpu_torch import telemetry
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.serve import (InferenceEngine, MicroBatcher,
                                       ServingServer)

    params = init_params(cfg, torch.Generator().manual_seed(seed))
    engine = InferenceEngine(cfg, params=params)   # device defaults to cuda
    batcher = MicroBatcher(engine, cfg)
    server = ServingServer(batcher, port=0, addr="127.0.0.1").start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        try:
            urllib.request.urlopen(url + "/healthz", timeout=30)
            raise AssertionError("/healthz answered 200 before warmup")
        except urllib.error.HTTPError as e:
            assert e.code == 503, e.code
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warmed = engine.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        # warmup's peak holds cuDNN's autotune workspaces
        warm_peak = torch.cuda.max_memory_allocated()
        server.mark_ready()
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.load(r)
        assert health["status"] == "ok" and health["devices"] >= 1, health
        log(f"[{tag}] warmup: {warmed} shape(s) "
            f"{engine.buckets} x {engine.rungs} in {warm_s:.1f}s")

        rng = np.random.RandomState(seed)
        sizes = [(480, 640), (640, 480), (800, 1333), (1333, 800),
                 (600, 600), (427, 640), (1024, 768), (300, 500)]
        images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                  for h, w in sizes]
        batches = telemetry.default_registry().counter(
            "eksml_serve_batches")
        # the main path's run: every count starts at 0 here
        for k in kernels:
            k.launches = 0
        batches_before = batches.value
        torch.cuda.reset_peak_memory_stats()
        results = [None] * len(images)
        d = engine.model.test_results_per_im

        def one(i):
            t = time.perf_counter()
            results[i] = post(url, images[i], raw_topk=d) \
                + (time.perf_counter() - t,)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(images))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        serve_peak = torch.cuda.max_memory_allocated()
        dispatched = int(batches.value - batches_before)
        assert all(not t.is_alive() for t in threads), "request hung"

        fills = []
        n_valid = 0
        for i, (status, body, lat) in enumerate(results):
            assert status == 200, (i, status)
            raw = body["raw_top"]
            boxes = np.asarray(raw["boxes"], np.float64)
            assert boxes.shape == (d, 4) and np.isfinite(boxes).all(), i
            for det in body["detections"]:
                assert len(det["box"]) == 4 and np.isfinite(det["box"]).all()
            n_valid += len(body["detections"])
            fills.append(body["batch_fill"])
        rpc = engine.request_path_compiles
        lat = sorted(r[2] * 1e3 for r in results)
        spans = {k: sorted(r[1]["timings_ms"][k] for r in results)
                 for k in ("pad", "queue_wait", "device_infer",
                           "postprocess")}
        log(f"[{tag}] 8 requests in {wall:.3f}s: {len(images) / wall:.3f} "
            f"images/s; latency ms min {lat[0]:.1f} median "
            f"{lat[len(lat) // 2]:.1f} max {lat[-1]:.1f}")
        log(f"[{tag}] per-request spans, median (max) ms: " + ", ".join(
            f"{k} {v[len(v) // 2]:.1f} ({v[-1]:.1f})"
            for k, v in spans.items()))
        log(f"[{tag}] batches dispatched {dispatched}, batch fills "
            f"{sorted(fills)}, request_path_compiles {rpc}, detections "
            f"above TEST.RESULT_SCORE_THRESH {n_valid}")
        log(f"[{tag}] peak torch.cuda.max_memory_allocated: warmup "
            f"{warm_peak / 2 ** 30:.2f} GiB, the 8 requests "
            f"{serve_peak / 2 ** 30:.2f} GiB; launches {launches}")
        assert rpc == 0, f"request_path_compiles = {rpc}"
        assert max(fills) == 4, f"no batch of 4 formed: fills {fills}"
        fwd = kernels.fwd.name
        assert launches[fwd] > 0, f"{fwd} never launched on the main path"
        assert launches[fwd] == 2 * dispatched, (
            f"{fwd}: {launches[fwd]} launches for {dispatched} batches "
            "(predict makes 2 ROIAlign calls per forward)")
        assert all(n == 0 for k, n in launches.items() if k != fwd), (
            f"a backward kernel launched while serving: {launches}")
        return engine, {"warmup_s": warm_s, "wall_s": wall,
                        "images_per_s": len(images) / wall,
                        "latency_ms": lat, "spans_ms": spans,
                        "warmup_peak_bytes": warm_peak,
                        "serve_peak_bytes": serve_peak,
                        "launches": launches, "images": images,
                        "raw_scores": [r[1]["raw_top"]["scores"]
                                       for r in results]}
    finally:
        server.drain(timeout=60)


# ---------------------------------------------------------------------
# phase 4: the card against the CPU on a small input
# ---------------------------------------------------------------------


def phase_reference(model_gpu, seed: int, tol: float = 1e-3,
                    tag: str = "reference"):
    """Same weights on the card and on the CPU, one 256² image: the FPN
    features, the ROIAlign output for the card's proposals (kernel on the
    card, plain version on the CPU) and the box-head logits agree within
    ``tol`` of each tensor's largest magnitude."""
    import torch

    from eksml_tpu_torch.ops.roi_align import dispatch_roi_align

    model_cpu = copy.deepcopy(model_gpu).cpu()
    dev = next(model_gpu.parameters()).device
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 256, (1, 256, 256, 3))
                         .astype(np.uint8))
    hw = torch.tensor([[256.0, 200.0]])

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))

    with torch.inference_mode():
        fg = model_gpu._features(x.to(dev))
        fc = model_cpu._features(x)
        errs = {f"P{i + 2}": rel(a, b) for i, (a, b) in enumerate(zip(fg, fc))}
        out = model_gpu.predict(x.to(dev), hw.to(dev))
        logits, deltas = model_gpu.rpn(fg)
        anchors = model_gpu._anchors((256, 256), fg[0].device)
        boxes, _ = model_gpu._proposals(logits, deltas, anchors, hw.to(dev),
                                        model_gpu.test_pre_nms_topk,
                                        model_gpu.test_post_nms_topk)
        strides = model_gpu.anchor_strides[:4]
        rg = dispatch_roi_align(fg[:4], boxes, strides, 7)
        rc = dispatch_roi_align(fc[:4], boxes.cpu(), strides, 7)
        errs["roi_align_7"] = rel(rg, rc)
        p = boxes.shape[1]
        lg, _ = model_gpu.fastrcnn(rg.reshape(p, 7, 7, -1))
        lc, _ = model_cpu.fastrcnn(rc.reshape(p, 7, 7, -1))
        errs["box_logits"] = rel(lg, lc)
    d = model_gpu.test_results_per_im
    assert out["boxes"].shape == (1, d, 4), out["boxes"].shape
    assert out["masks"].shape == (1, d, 28, 28), out["masks"].shape
    assert bool(torch.isfinite(out["boxes"]).all())
    assert bool(torch.isfinite(out["masks"]).all())
    log(f"[{tag}] card vs CPU, max|diff| / max|CPU|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tolerance {tol})")
    bad = {k: v for k, v in errs.items() if not v <= tol}
    assert not bad, f"card and CPU disagree: {bad}"


# ---------------------------------------------------------------------
# phase 5: where a forward's device time goes
# ---------------------------------------------------------------------


def profile_window(label: str, fn, top: int = 15):
    """Run ``fn`` once under torch.profiler and print the device time by
    kernel and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime_window()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    PROFILER_WINDOWS["n"] += 1
    # device-side events only (kernels, copies): an operator's own entry
    # also carries the device time of the kernels it launched
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and PRIMER_KERNEL not in e.key),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    log(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms * 100:.1f}%), "
        f"{len(kernels)} kernel names")
    ours = ("roi_align_fwd_", "roi_align_bwd_", "copy_bulk_kernel")
    for i, (name, ms, count) in enumerate(kernels):
        if i < top or any(o in name for o in ours):
            log(f"[profile]   {ms:8.2f} ms "
                f"{ms / max(busy_ms, 1e-9) * 100:5.1f}% x{count:<5d} "
                f"{name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def phase_profile(engine, seed: int):
    import torch

    bh, bw = engine.buckets[-1]
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (4, bh, bw, 3)).astype(np.uint8)
    hw = np.tile(np.asarray([[bh, bw]], np.float32), (4, 1))
    engine.infer(images, hw, len(engine.buckets) - 1, rung=4)
    torch.cuda.synchronize()
    profile_window(f"batch-4 forward at {bh}x{bw}", lambda: engine.infer(
        images, hw, len(engine.buckets) - 1, rung=4))


# ---------------------------------------------------------------------
# phase 6: training steps at full width
# ---------------------------------------------------------------------


def train_config():
    from eksml_tpu_torch.config import config, finalize_configs

    config.freeze(False)
    config.update_args([f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}",
                        "TRAIN.LOG_PERIOD=1"])
    return finalize_configs(is_training=True)


def phase_train(cfg, kernels, seed: int, logdir: str,
                extra_batches: int = 0):
    """``TRAIN_STEPS`` steps of ``Trainer.fit`` at the default config,
    writing into ``logdir``: step 1 (cuDNN autotune) apart from the
    median of the rest, peak memory after step 1, the kernels' launches
    per step, and the checks that the step trained what it must and
    froze the rest."""
    import torch

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.data.loader import DetectionLoader, SyntheticDataset
    from eksml_tpu_torch.train import Trainer

    ds = SyntheticDataset(num_images=2 * BATCH, height=800, width=1333,
                          max_boxes=8, num_classes=cfg.DATA.NUM_CLASSES,
                          seed=seed)
    loader = DetectionLoader(ds.records(), cfg, BATCH, seed=seed,
                             with_masks=cfg.MODE_MASK, gt_mask_size=56)
    # built ahead, so the step times hold no host image work
    t0 = time.perf_counter()
    batches = list(loader.batches(TRAIN_STEPS + extra_batches))
    log(f"[train] {len(batches)} batches of {BATCH} built in "
        f"{time.perf_counter() - t0:.1f}s; canvas "
        f"{batches[0]['images'].shape[1:3]}, {batches[0]['images'].dtype}")
    trainer = Trainer(cfg, logdir=logdir, device="cuda")
    model = trainer.init_state(init_params(
        cfg, torch.Generator().manual_seed(seed)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    it = iter(batches)

    # the main path's run: every count starts at 0 here
    for k in kernels:
        k.launches = 0
    rows = trainer.fit(it, 1)
    torch.cuda.synchronize()
    step1 = {k.name: k.launches for k in kernels}
    torch.cuda.reset_peak_memory_stats()
    rows += trainer.fit(it, TRAIN_STEPS, start_step=1)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()

    for r in rows:
        log(f"[train] step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.5g}" for k in (
                "rpn_cls_loss", "rpn_box_loss", "frcnn_cls_loss",
                "frcnn_box_loss", "mrcnn_loss", "total_loss", "grad_norm",
                "learning_rate")) + f"; {r['step_time_ms']:.1f} ms")
    times = sorted(r["step_time_ms"] / 1e3 for r in rows[1:])
    median = times[len(times) // 2]
    log(f"[train] step 1 (cuDNN autotune) {rows[0]['step_time_ms'] / 1e3:.2f} s; "
        f"steps 2-{TRAIN_STEPS} median {median * 1e3:.1f} ms "
        f"(min {times[0] * 1e3:.1f}, max {times[-1] * 1e3:.1f}) = "
        f"{BATCH / median:.3f} images/s; peak torch.cuda."
        f"max_memory_allocated after step 1 {peak / 2 ** 30:.2f} GiB")
    log(f"[train] launches in step 1 {step1}; in all {TRAIN_STEPS} steps "
        f"{launches}")

    for r in rows:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        assert not bad, f"step {r['step']}: non-finite {bad}"
    want = {kernels.fwd.name: 3, kernels.bwd.name: 2,
            kernels.copy.name: 2 * len(LEVEL_STRIDES)}
    assert step1 == want, (
        f"launches in one step {step1}, expected {want} (ROIAlign forward: "
        "box, mask, mask targets; backward: box, mask; copy: 4 levels x 2)")
    assert launches == {k: n * TRAIN_STEPS for k, n in want.items()}, launches
    after = model.state_dict()
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    still = sorted(n for n in trainable if torch.equal(before[n], after[n]))
    moved = sorted(n for n in set(before) - trainable
                   if not torch.equal(before[n], after[n]))
    log(f"[train] {len(trainable)} trainable tensors, all changed: "
        f"{not still}; {len(before) - len(trainable)} frozen tensors and "
        f"buffers, none changed: {not moved}")
    assert not still, f"trainable tensors that did not change: {still}"
    assert not moved, f"frozen tensors that changed: {moved}"
    return trainer, it, {"rows": rows, "median_s": median,
                         "images_per_s": BATCH / median, "peak_bytes": peak,
                         "launches": launches, "launches_step1": step1,
                         "batches": batches[:TRAIN_STEPS]}


# ---------------------------------------------------------------------
# phase 7: the trainer's lifecycle and serving what it wrote
# ---------------------------------------------------------------------


class _Lines(logging.Handler):
    """Keeps the formatted messages of one logger."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _per_step(kernels, counts, steps):
    want = {kernels.fwd.name: 3 * steps, kernels.bwd.name: 2 * steps,
            kernels.copy.name: 2 * len(LEVEL_STRIDES) * steps}
    assert counts == want, f"launches {counts}, expected {want}"


def phase_lifecycle(cfg, kernels, trainer, batches, engine, serve, workdir):
    """Direct resume, the entry point's relaunch-resume, and hot-reload
    of the entry point's last step into the serve phase's engine."""
    import torch

    from eksml_tpu_torch import telemetry
    from eksml_tpu_torch.config import config
    from eksml_tpu_torch.resilience.integrity import verify_step
    from eksml_tpu_torch.serve import (MicroBatcher, ReloadManager,
                                       ServingServer)
    from eksml_tpu_torch.train import Trainer, main

    def counts():
        return {kern.name: kern.launches for kern in kernels}

    out = {}
    path_launches = []
    # 1. direct resume: a second Trainer restores the last checkpoint
    trainer.ckpt.wait()
    k = trainer.step
    if trainer.ckpt.latest_step() != k:
        # the profiled step was not the run's last: commit the live state
        assert trainer.ckpt.save(k, trainer.checkpoint_state())
        trainer.ckpt.wait()
    assert trainer.ckpt.latest_step() == k, (trainer.ckpt.all_steps(), k)
    save = dict(trainer.ckpt.last_save)
    t0 = time.perf_counter()
    second = Trainer(cfg, trainer.logdir, device="cuda")
    assert second.restore_or_init() == k
    torch.cuda.synchronize()
    out["restore_ms"] = second.ckpt.last_restore_ms
    out["restore_or_init_ms"] = (time.perf_counter() - t0) * 1e3
    live, restored = trainer.checkpoint_state(), second.checkpoint_state()
    assert set(live["model"]) == set(restored["model"])
    differ = [n for n in live["model"]
              if not torch.equal(live["model"][n], restored["model"][n])]
    ma, mb = live["optimizer"]["state"], restored["optimizer"]["state"]
    assert set(ma) == set(mb) and len(ma) > 40, (len(ma), len(mb))
    differ += [f"momentum {i}" for i in ma if not torch.equal(
        ma[i]["momentum_buffer"], mb[i]["momentum_buffer"])]
    if not torch.equal(live["generator"], restored["generator"]):
        differ.append("generator")
    log(f"[lifecycle] step {k} restored by a second Trainer: "
        f"{len(live['model'])} model tensors, {len(ma)} momentum buffers "
        f"and the generator state bitwise equal to the live state: "
        f"{not differ}; restore {out['restore_ms']:.1f} ms (verify, "
        f"torch.load, load), restore_or_init {out['restore_or_init_ms']:.1f}"
        " ms (with the seeded init it overwrites)")
    assert not differ, f"restored state differs: {differ[:5]}"
    batch = next(batches)
    for kern in kernels:
        kern.launches = 0
    row_a = trainer.fit(iter([batch]), k + 1, start_step=k)[-1]
    trainer.ckpt.wait()          # step k + 1 is committed: second skips it
    row_b = second.fit(iter([batch]), k + 1, start_step=k)[-1]
    torch.cuda.synchronize()
    path_launches.append(counts())
    _per_step(kernels, path_launches[-1], 2)
    rel = {key: abs(row_a[key] - row_b[key]) / max(abs(row_a[key]), 1e-30)
           for key in row_a if key.endswith("_loss")}
    log(f"[lifecycle] one more step each on one batch: total_loss "
        f"{row_a['total_loss']:.9g} / {row_b['total_loss']:.9g}, largest "
        f"relative difference over the losses {max(rel.values()):.3e} "
        "(tolerance 1e-6)")
    assert max(rel.values()) <= 1e-6, rel
    trainer.ckpt.wait()
    save_next = dict(trainer.ckpt.last_save)
    out.update(ckpt_bytes=save_next["bytes"],
               save_blocking_ms=[save["blocking_ms"],
                                 save_next["blocking_ms"]],
               save_write_ms=[save["write_ms"], save_next["write_ms"]])
    file_bytes = os.path.getsize(os.path.join(
        trainer.ckpt.directory, str(k + 1), "state.pt"))
    log(f"[lifecycle] checkpoint of step {k + 1}: {save_next['bytes']} "
        f"tensor bytes, state.pt {file_bytes} bytes; save blocking (host "
        f"copy) {save['blocking_ms']:.1f} / {save_next['blocking_ms']:.1f} "
        f"ms, background write + fsync + commit {save['write_ms']:.1f} / "
        f"{save_next['write_ms']:.1f} ms (steps {k} / {k + 1})")
    second.close()
    trainer.close()
    del second, live, restored, ma, mb
    torch.cuda.empty_cache()

    # 2. the entry point: train to 3, then relaunched to 5
    run = os.path.join(workdir, "entry")
    lines = _Lines()
    logging.getLogger("eksml_tpu_torch.train").addHandler(lines)
    argv = ["--logdir", run, "--synthetic", "--config",
            "TRAIN.STEPS_PER_EPOCH=2", "TRAIN.CHECKPOINT_PERIOD=1",
            f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}", "TRAIN.LOG_PERIOD=1"]
    saved = config.to_dict()      # main overrides the global config
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    try:
        assert main(["--total-steps", "3"] + argv) == 0
        root = os.path.join(run, "checkpoints")
        first = sorted(int(n) for n in os.listdir(root) if n.isdigit())
        assert first == [2, 3], first
        t1 = time.perf_counter()
        assert main(["--total-steps", "5"] + argv) == 0
        t2 = time.perf_counter()
    finally:
        logging.getLogger("eksml_tpu_torch.train").removeHandler(lines)
        config.freeze(False)
        config.from_dict(saved)
        config.freeze()
    torch.cuda.synchronize()
    path_launches.append(counts())
    _per_step(kernels, path_launches[-1], 5)
    assert "resuming from checkpoint step 3" in lines.lines, lines.lines
    steps = sorted(int(n) for n in os.listdir(root) if n.isdigit())
    assert steps == [2, 3, 4, 5], steps
    bad = [s for s in steps if not verify_step(root, s)[0]]
    assert not bad, f"steps failing verify_step: {bad}"
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    logged = [r["step"] for r in rows if "total_loss" in r]
    assert logged == [1, 2, 3, 4, 5], logged
    assert all(np.isfinite(r["total_loss"]) for r in rows
               if "total_loss" in r)
    assert sum(r.get("event") == "run_start" for r in rows) == 2
    out.update(entry_s=[t1 - t0, t2 - t1])
    log(f"[lifecycle] python -m eksml_tpu_torch.train --synthetic, "
        f"in-process: to step 3 in {t1 - t0:.1f} s (checkpoints {first}), "
        f"relaunched to 5 in {t2 - t1:.1f} s, resumed from step 3, "
        f"checkpoints {steps} all verified; metrics.jsonl rows for steps "
        f"{logged}")

    # 3. hot-reload of step 5 into the serve phase's engine
    mgr = ReloadManager(engine, run)
    outcome = mgr.reload_step(5)
    assert outcome["ok"] and engine.params_step == 5, outcome
    out.update({f"reload_{key}": v for key, v in mgr.last_timings.items()})
    batcher = MicroBatcher(engine, engine.cfg)
    server = ServingServer(batcher, port=0, addr="127.0.0.1").start()
    server.reload_manager = mgr
    server.mark_ready()
    url = f"http://127.0.0.1:{server.port}"
    d = engine.model.test_results_per_im
    for kern in kernels:
        kern.launches = 0
    batches_metric = telemetry.default_registry().counter(
        "eksml_serve_batches")
    before = batches_metric.value
    try:
        answers = [post(url, img, raw_topk=d) for img in serve["images"][:4]]
    finally:
        server.drain(timeout=60)
    dispatched = int(batches_metric.value - before)
    launches = counts()
    path_launches.append(launches)
    changes = []
    for i, (status, body) in enumerate(answers):
        assert status == 200, (i, status)
        assert body["params_step"] == 5, (i, body["params_step"])
        boxes = np.asarray(body["raw_top"]["boxes"], np.float64)
        assert boxes.shape == (d, 4) and np.isfinite(boxes).all(), i
        # raw rows past the valid detections score -inf
        new, old = (np.asarray(x, np.float64) for x in (
            body["raw_top"]["scores"], serve["raw_scores"][i]))
        assert not np.isnan(new).any(), i
        both = np.isfinite(new) & np.isfinite(old)
        changes.append((int(np.isfinite(old).sum()),
                        int(np.isfinite(new).sum()),
                        float(np.abs(new - old)[both].max())
                        if both.any() else None,
                        not np.array_equal(new, old)))
    rpc = engine.request_path_compiles
    log(f"[lifecycle] hot-reload of step 5: verify "
        f"{mgr.last_timings['verify_ms']:.1f} ms, restore (mapped "
        f"torch.load) {mgr.last_timings['restore_ms']:.1f} ms, swap (copy "
        f"of the serving model on the card, load, reference swap) "
        f"{mgr.last_timings['swap_ms']:.1f} ms; 4 requests answered at "
        f"params_step 5 in {dispatched} batches, request_path_compiles "
        f"{rpc}; per request (valid raw rows with the random weights, "
        f"with step 5, largest change of a score valid in both, raw "
        f"scores differ): {changes}; launches {launches}")
    assert rpc == 0, f"request_path_compiles = {rpc}"
    assert all(c[3] for c in changes), "raw scores did not change"
    assert launches[kernels.fwd.name] == 2 * dispatched, launches
    assert all(n == 0 for name, n in launches.items()
               if name != kernels.fwd.name), launches
    # the lifecycle path's launches: 2 + 5 training steps and the reload
    out["launches"] = {kern.name: sum(c[kern.name] for c in path_launches)
                       for kern in kernels}
    out["run"] = run       # the fleet phase serves its checkpoints
    return out


# ---------------------------------------------------------------------
# phase fleet: the serve chart's two tracks, the load tool, promotion
# ---------------------------------------------------------------------

#: the GPU serve chart's golden rendering: the stable Deployment's command
CHART = os.path.join("charts", "golden-gpu", "serve-gpu__serve.yaml")
#: requests per closed-loop run: FLEET_PER_WORKER per concurrent worker
FLEET_CONCURRENCY = (1, 4, 8)
FLEET_PER_WORKER = 8
FLEET_OPEN_REQUESTS = 64
FLEET_BANK = 32
#: the bank's pre-threshold top-k (the drift signal's depth)
FLEET_TOPK = 16


def chart_command(track: str = "stable"):
    """The ``command:`` list of the serve chart's ``track`` Deployment in
    its golden rendering (the Deployment whose ``--serve-id`` is
    ``track``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, CHART)) as f:
        lines = f.read().splitlines()
    commands, cur = [], None
    for line in lines:
        s = line.strip()
        if s == "command:":
            cur = []
            commands.append(cur)
        elif cur is not None and s.startswith("- "):
            cur.append(s[2:].strip('"'))
        elif cur is not None:
            cur = None
    for cmd in commands:
        if "--serve-id" in cmd and cmd[cmd.index("--serve-id") + 1] == track:
            return cmd
    raise AssertionError(f"no {track} serving command in {CHART}")


class FleetTrack:
    """One serving track of the chart in this process: its own engine,
    ``ServingServer`` (ephemeral port), ``ReloadManager`` and flight
    recorder (``events-host<serve_id>.jsonl`` in the logdir), at
    ``step``.  Its reload watcher stays off: the phase moves it."""

    def __init__(self, cfg, run: str, serve_id: str, step: int,
                 device: str = "cuda"):
        import torch

        from eksml_tpu_torch.serve import (InferenceEngine, MicroBatcher,
                                           ReloadManager, ServingServer)
        from eksml_tpu_torch.telemetry.recorder import (FlightRecorder,
                                                        events_path_for)

        cuda = device == "cuda"
        before = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        self.serve_id = serve_id
        self.engine = InferenceEngine(cfg, checkpoint_dir=run,
                                      checkpoint_step=step, device=device)
        self.server = ServingServer(
            MicroBatcher(self.engine, cfg), port=0, addr="127.0.0.1",
            result_masks_default=bool(cfg.SERVE.RESULT_MASKS))
        self.recorder = FlightRecorder(
            path=events_path_for(run, serve_id), host_id=serve_id)
        self.reload = ReloadManager(
            self.engine, run, lock=self.server.lifecycle_lock,
            is_draining=self.server.draining.is_set,
            check_digest=bool(cfg.SERVE.RELOAD_DIGEST),
            recorder=self.recorder)
        self.server.reload_manager = self.reload
        self.server.start()
        self.url = f"http://127.0.0.1:{self.server.port}"
        t0 = time.perf_counter()
        self.warmed = self.engine.warmup()
        if cuda:
            torch.cuda.synchronize()
        self.warmup_s = time.perf_counter() - t0
        self.server.mark_ready()
        self.memory = {
            "resident_bytes": (torch.cuda.memory_allocated() - before
                               if cuda else None),
            "warmup_peak_bytes": (torch.cuda.max_memory_allocated()
                                  if cuda else None)}

    def close(self):
        self.server.drain(timeout=60)
        self.engine.close()
        self.recorder.close()


def _rows(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _lat(art) -> str:
    lat = art["latency_ms"]
    return (f"p50 {lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms, "
            f"{art['images_per_sec']:.2f} images/s")


def raw_rows(stable, canary, bank, n: int = 4):
    """The first ``n`` bank images posted to both tracks one at a time (a
    batch of 1 on each), and to stable once more: per image the finite raw
    scores of each track's ``raw_top``, whether the two tracks' classes
    agree rank by rank, the largest score difference where both are
    finite, and the same two for stable against itself."""
    from eksml_tpu_torch.tools import serve_loadtest as lt

    def diff(a, b):
        sa, sb = (np.asarray(x["scores"], np.float64) for x in (a, b))
        both = np.isfinite(sa) & np.isfinite(sb)
        return (a["classes"] == b["classes"],
                float(np.abs(sa - sb)[both].max()) if both.any() else 0.0)

    out = {"finite_scores": [], "classes_equal": [], "max_score_delta": 0.0,
           "stable_again_classes_equal": [], "stable_again_delta": 0.0}
    for row in bank["requests"][:n]:
        img = lt.bank_image(bank, row)
        a, b, again = (lt.post_predict(t.url, img,
                                       raw_topk=FLEET_TOPK)["raw_top"]
                       for t in (stable, canary, stable))
        out["finite_scores"].append([int(np.isfinite(x["scores"]).sum())
                                     for x in (a, b)])
        same, delta = diff(a, b)
        out["classes_equal"].append(same)
        out["max_score_delta"] = max(out["max_score_delta"], delta)
        same, delta = diff(a, again)
        out["stable_again_classes_equal"].append(same)
        out["stable_again_delta"] = max(out["stable_again_delta"], delta)
    return out


def phase_fleet(kernels, seed: int, workdir: str, run: str,
                device: str = "cuda"):
    """The serve chart's stable and canary tracks on the lifecycle
    phase's checkpoints (``run``: steps 2-5), in this process, at the
    chart's ``--config`` (bf16, one 1344² bucket, rungs 1 and 4): the load
    tool's closed and open loops on stable, a shadow replay of a 32-request
    bank at both, the promotion controller to a promote and to a
    rollback; both tracks then on one step, the run's step 5 and a seeded
    init written as step 6 (whose raw outputs are finite, unlike the
    trained steps'), for the drift of identical weights; then the chart's
    command as a subprocess on the card."""
    import torch

    from eksml_tpu_torch import telemetry
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.telemetry.recorder import events_path_for
    from eksml_tpu_torch.tools import eksml_operator as op
    from eksml_tpu_torch.tools import serve_loadtest as lt
    from eksml_tpu_torch.utils.checkpoint import CheckpointManager

    cmd = chart_command("stable")
    items = cmd[cmd.index("--config") + 1:]
    cfg = variant_config(*items, training=False)
    assert cfg.TRAIN.PRECISION == "bfloat16" and \
        not cfg.SERVE.RESULT_MASKS, items
    root = os.path.join(run, "checkpoints")
    steps = sorted(int(n) for n in os.listdir(root) if n.isdigit())
    assert steps[-3:] == [3, 4, 5], steps
    out = {"reloads": []}
    stable = canary = None
    try:
        stable = FleetTrack(cfg, run, "stable", 3, device)
        canary = FleetTrack(cfg, run, "canary", 5, device)
        for t in (stable, canary):
            out[f"{t.serve_id}_memory"] = t.memory
            out[f"{t.serve_id}_warmup_s"] = t.warmup_s
            log(f"[fleet] {t.serve_id} track at step "
                f"{t.engine.params_step}: {t.warmed} shape(s) "
                f"{t.engine.buckets} x {t.engine.rungs} warmed in "
                f"{t.warmup_s:.1f} s; " + json.dumps(t.memory))
        bank_path = os.path.join(workdir, "fleet-bank.json")
        assert lt.main(["--record", bank_path, "--seed", str(seed),
                        "--requests", str(FLEET_BANK)]) == 0
        with open(bank_path) as f:
            bank = json.load(f)
        batches = telemetry.default_registry().counter("eksml_serve_batches")
        # the main path's run: every count starts at 0 here
        for k in kernels:
            k.launches = 0
        batches_before = batches.value

        def compiles(url):
            rpc = lt.fetch_health(url)["request_path_compiles"]
            assert rpc == 0, f"{url}: request_path_compiles = {rpc}"
            return rpc

        loads = {}
        for conc in FLEET_CONCURRENCY:
            art = lt.run_load(stable.url, FLEET_PER_WORKER * max(2, conc),
                              conc, seed=seed)
            assert art["errors"] == 0, art["error_samples"]
            compiles(stable.url)
            loads[f"closed_c{conc}"] = art
            log(f"[fleet] stable closed loop, concurrency {conc}, "
                f"{art['completed']} requests: {_lat(art)}; phases ms "
                "(mean / p99): " + ", ".join(
                    f"{ph} {v['mean']} / {v['p99']}"
                    for ph, v in art["phase_ms"].items())
                + f"; batch occupancy {art['batch_occupancy_mean']}")
        rate = loads[f"closed_c{FLEET_CONCURRENCY[-1]}"]["images_per_sec"] / 2
        art = lt.run_load(stable.url, FLEET_OPEN_REQUESTS,
                          FLEET_CONCURRENCY[-1], mode="open", rate=rate,
                          seed=seed)
        assert art["errors"] == 0, art["error_samples"]
        compiles(stable.url)
        loads["open"] = art
        log(f"[fleet] stable open loop at {rate:.2f} requests/s (half the "
            f"concurrency-{FLEET_CONCURRENCY[-1]} rate), "
            f"{art['completed']} requests: {_lat(art)}; "
            + json.dumps(art["open_loop"]))
        out["loads"] = {k: {"latency_ms": v["latency_ms"],
                            "images_per_sec": v["images_per_sec"],
                            "phase_ms": v["phase_ms"],
                            "open_loop": v["open_loop"]}
                        for k, v in loads.items()}

        first = lt.replay_shadow(bank, stable.url, canary.url,
                                 raw_topk=FLEET_TOPK)
        assert first["canary_error_rate"] == 0 and \
            first["scored"] == FLEET_BANK, first
        log(f"[fleet] shadow replay, stable step 3 against canary step 5: "
            f"p99 ratio {first['p99_ratio']}, error rate "
            f"{first['canary_error_rate']}, drift {first['drift']}")
        out["shadow_3_5"] = {k: first[k] for k in (
            "p99_ratio", "canary_error_rate", "drift")}

        # gates set up to promote: the drift gate above the measured
        # drift, the latency gate at twice the measured ratio
        drift = first["drift"]["mean"]
        knobs = dict(op.RESILIENCE_AUTOSCALE_DEFAULTS,
                     CANARY_MIN_REQUESTS=FLEET_BANK,
                     CANARY_DRIFT_MAX=min(1.0, drift + max(
                         0.1, (1.0 - drift) / 2)),
                     CANARY_P99_RATIO_MAX=2.0 * max(1.0, first["p99_ratio"]),
                     CANARY_PROMOTE_STREAK=2)
        ctl = op.PromotionController(run, stable.url, canary.url, bank,
                                     knobs, raw_topk=FLEET_TOPK)
        ticks = [ctl.tick() for _ in range(2)]
        got = [t["verdict"] for t in ticks]
        assert got == ["promote", "promote"], [t["reason"] for t in ticks]
        promote = ticks[1]["reload"]
        assert promote.get("ok"), promote
        out["reloads"].append(("promote stable 3 -> 5", promote))
        assert lt.fetch_health(stable.url)["params_step"] == 5
        held = ctl.tick()
        assert held["verdict"] == "hold" and "converged" in held["reason"], \
            held
        log(f"[fleet] promotion controller: {got} (gates: drift "
            f"{knobs['CANARY_DRIFT_MAX']:.4f}, p99 ratio "
            f"{knobs['CANARY_P99_RATIO_MAX']:.3f}; scored drift "
            f"{[t['score']['drift']['mean'] for t in ticks]}), stable now "
            f"serves step 5; next tick: {held['verdict']} ({held['reason']})")

        moved = op.post_reload(canary.url, step=4)
        assert moved.get("ok"), moved
        out["reloads"].append(("canary 5 -> 4", moved))
        ctl.knobs = dict(knobs, CANARY_DRIFT_MAX=0.0)
        back = ctl.tick()
        assert back["verdict"] == "rollback", back["reason"]
        assert back.get("reload", {}).get("ok"), back
        out["reloads"].append(("rollback canary 4 -> 5", back["reload"]))
        assert lt.fetch_health(canary.url)["params_step"] == 5
        log(f"[fleet] rollback: canary at step 4 with CANARY_DRIFT_MAX=0: "
            f"{back['verdict']} ({back['reason']}); canary serves step 5")

        # the drift of identical weights: the run's step 5, then a
        # seeded init committed as step 6
        ckpt = CheckpointManager(run, max_to_keep=10)
        assert ckpt.save(6, {"model": init_params(
            cfg, torch.Generator().manual_seed(seed))})
        ckpt.close()
        for step in (5, 6):
            if step == 6:
                for t in (stable, canary):
                    moved = op.post_reload(t.url, step=6)
                    assert moved.get("ok"), moved
                    out["reloads"].append((f"{t.serve_id} 5 -> 6", moved))
            same = lt.replay_shadow(bank, stable.url, canary.url,
                                    raw_topk=FLEET_TOPK)
            assert same["canary_error_rate"] == 0, same
            rows = raw_rows(stable, canary, bank)
            out[f"shadow_same_step_{step}"] = {
                **{k: same[k] for k in ("p99_ratio", "canary_error_rate",
                                        "drift")}, "raw_rows": rows}
            log(f"[fleet] both tracks at step {step}: replay drift "
                f"{same['drift']}, p99 ratio {same['p99_ratio']}; 4 images "
                f"one at a time: finite raw scores (stable, canary) "
                f"{rows['finite_scores']}, classes equal "
                f"{rows['classes_equal']}, largest score difference "
                f"{rows['max_score_delta']:.3e}; stable against itself: "
                f"classes equal {rows['stable_again_classes_equal']}, "
                f"largest score difference {rows['stable_again_delta']:.3e}")

        dispatched = int(batches.value - batches_before)
        launches = {k.name: k.launches for k in kernels}
        fwd = kernels.fwd.name
        log(f"[fleet] both tracks dispatched {dispatched} batches; "
            f"launches {launches}")
        assert launches[fwd] > 0, f"{fwd} never launched on the fleet path"
        assert launches[fwd] == 2 * dispatched, (
            f"{fwd}: {launches[fwd]} launches for {dispatched} batches")
        assert all(n == 0 for k, n in launches.items() if k != fwd), launches
        out["launches"] = launches
        out["dispatched"] = dispatched
        for t in (stable, canary):
            compiles(t.url)
        for name, r in out["reloads"]:
            log(f"[fleet] reload {name}: verify {r['verify_ms']:.1f} ms, "
                f"restore {r['restore_ms']:.1f} ms, swap {r['swap_ms']:.1f} "
                f"ms ({r['duration_ms']} ms)")
    finally:
        for t in (stable, canary):
            if t is not None:
                t.close()
        if device == "cuda":
            torch.cuda.empty_cache()

    # the evidence files, each its own
    ev = {sid: _rows(events_path_for(run, sid))
          for sid in ("stable", "canary", "cd")}
    assert [(e["kind"], e["step"]) for e in ev["stable"]] == [
        ("serve_reload", 5), ("serve_reload", 6)], ev["stable"]
    assert [(e["kind"], e["step"]) for e in ev["canary"]] == [
        ("serve_reload", 4), ("serve_reload", 5), ("serve_reload", 6)], \
        ev["canary"]
    assert [e["kind"] for e in ev["cd"]] == [
        "canary_score", "canary_score", "canary_promote", "canary_score",
        "canary_rollback"], ev["cd"]
    verdicts = [r["verdict"] for r in _rows(ctl.bank_path)]
    assert verdicts == ["promote", "promote", "hold", "rollback"], verdicts
    log(f"[fleet] events-hoststable.jsonl {len(ev['stable'])} row(s), "
        f"events-hostcanary.jsonl {len(ev['canary'])}, events-hostcd.jsonl "
        f"{[e['kind'] for e in ev['cd']]}, canary-host0.jsonl {verdicts}")

    # the chart's command as a subprocess: only the logdir and the port
    # changed
    port_file = os.path.join(workdir, "fleet-serve.port")
    argv = [sys.executable] + [
        run if a.startswith("/efs/") else a for a in cmd[1:]] + [
        *VARIANT_BASE, "--port", "0", "--port-file", port_file]
    if device != "cuda":
        argv += ["--device", device]
    out["subprocess"] = chart_subprocess(argv, workdir, port_file)
    return out


def chart_subprocess(argv, workdir: str, port_file: str,
                     budget: float = 600.0, log_path: str = None,
                     tag: str = "fleet"):
    """Start ``argv`` (a serving command), wait for ``/healthz`` 200,
    answer 4 requests, drain on SIGTERM; the process is killed on any
    failure.  Returns the readiness time, the answers' latency, the warm
    shapes, the batches dispatched and the kernel launches the process
    logged at its exit."""
    import signal

    from eksml_tpu_torch.tools import serve_loadtest as lt

    log_path = log_path or os.path.join(workdir, "fleet-serve.log")
    log(f"[{tag}] subprocess: {' '.join(argv[1:])}; signals blocked in "
        "the launching thread (inherited by the child): "
        f"{sorted(int(x) for x in signal.pthread_sigmask(signal.SIG_BLOCK, []))}")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT,
                                cwd=here, env=env)
    try:
        deadline = time.monotonic() + budget
        while not os.path.exists(port_file):
            assert proc.poll() is None, f"exited {proc.returncode}"
            assert time.monotonic() < deadline, "no port file"
            time.sleep(0.2)
        with open(port_file) as f:
            url = f"http://127.0.0.1:{int(f.read().strip())}"
        health = lt.wait_ready(url, budget=max(1.0,
                                               deadline - time.monotonic()))
        ready_s = time.perf_counter() - t0
        art = lt.run_load(url, 4, 4, seed=1)
        assert (art["completed"], art["errors"]) == (4, 0), art
        post = lt.fetch_health(url)
        assert post["request_path_compiles"] == 0, post
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
            batches = int(_families(r.read().decode())[
                "eksml_serve_batches_total"])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    except BaseException:
        with open(log_path) as f:
            log(f"[{tag}] subprocess output:\n{f.read()[-4000:]}")
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        text = f.read()
    assert rc == 0 and "drain complete" in text, (rc, text[-2000:])
    launches = logged_launches(text)
    log(f"[{tag}] subprocess /healthz 200 after {ready_s:.1f} s (step "
        f"{health['params_step']}, {health['warm_executables']} warm "
        f"shapes, devices {health['devices']}); 4 requests {_lat(art)} in "
        f"{batches} batch(es); SIGTERM drained with rc {rc}; launches "
        f"{launches}")
    return {"ready_s": ready_s, "params_step": health["params_step"],
            "latency_ms": art["latency_ms"], "rc": rc,
            "warm_shapes": int(health["warm_executables"]),
            "batches": batches, "launches": launches}


# ---------------------------------------------------------------------
# phase operator: the elastic operator's capacity wave
# ---------------------------------------------------------------------

#: the operator's knobs for a wave: act at the first grow-capable tick
OPERATOR_KNOBS = ("RESILIENCE.AUTOSCALE.CHIP_OPTIONS=(1,2)",
                  "RESILIENCE.AUTOSCALE.GROW_PATIENCE=1",
                  "RESILIENCE.AUTOSCALE.SHRINK_PATIENCE=1",
                  "RESILIENCE.AUTOSCALE.COOLDOWN_SEC=0")
OPERATOR_BUDGET = 300.0


def operator_train_config():
    """The relaunched trainer's items: SMOKE widths, every step logged,
    no periodic checkpoint (a transition's is the forced one)."""
    from eksml_tpu_torch.config import SMOKE_OVERRIDES

    return list(SMOKE_OVERRIDES) + [
        "TELEMETRY.PORT=0", "TRAIN.SHARDING.STRATEGY=replicated",
        "TRAIN.LOG_PERIOD=1", "TRAIN.STEPS_PER_EPOCH=100000",
        "TRAIN.CHECKPOINT_PERIOD=100000"]


class OperatorRun:
    """``python -m eksml_tpu_torch.tools.eksml_operator --mode local`` on
    ``logdir`` under the capacity file ``logdir/capacity.json``, in a
    session of its own (``kill`` ends its ranks too)."""

    def __init__(self, logdir: str, device: str, *extra):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.cap = os.path.join(logdir, "capacity.json")
        if not os.path.exists(self.cap):
            self.capacity(1)
        self.bank = os.path.join(logdir, "autoscale-host0.jsonl")
        self.seen = len(_rows(self.bank)) if os.path.exists(self.bank) else 0
        here = os.path.dirname(os.path.abspath(__file__))
        argv = [sys.executable, "-m", "eksml_tpu_torch.tools.eksml_operator",
                "--logdir", logdir, "--mode", "local", "--capacity-file",
                self.cap, "--device", device, "--synthetic",
                "--global-batch", "2", "--interval", "1",
                "--stop-budget", "120", *extra, "--config",
                *OPERATOR_KNOBS, "--train-config",
                *operator_train_config()]
        self.t0 = time.time()
        with open(os.path.join(logdir, "operator.log"), "a") as f:
            self.proc = subprocess.Popen(
                argv, stdout=f, stderr=subprocess.STDOUT, cwd=here,
                env=dict(os.environ, PYTHONPATH=here),
                start_new_session=True)

    def capacity(self, n: int) -> None:
        from eksml_tpu_torch.fsio import atomic_write_json

        atomic_write_json(self.cap, {"available_chips": int(n)})

    def rows(self):
        return _rows(self.bank)[self.seen:] if os.path.exists(self.bank) \
            else []

    def wait(self, pred, what: str):
        deadline = time.monotonic() + OPERATOR_BUDGET
        while time.monotonic() < deadline:
            v = pred()
            if v:
                return v
            assert self.proc.poll() is None, \
                f"operator exited {self.proc.returncode} waiting for {what}"
            time.sleep(0.2)
        raise AssertionError(f"operator: no {what} in {OPERATOR_BUDGET} s")

    def step_after(self, t: float):
        path = os.path.join(self.logdir, "metrics.jsonl")
        if not os.path.exists(path):
            return None
        rows = [r for r in _rows(path)
                if "total_loss" in r and r["time"] > t]
        return rows[0] if rows else None

    def stop(self) -> int:
        import signal

        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=OPERATOR_BUDGET)

    def kill(self) -> None:
        import signal

        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()


def _operator_series(logdir: str) -> dict:
    from eksml_tpu_torch.tools import eksml_operator as op

    with open(os.path.join(logdir, "telemetry-operator.port")) as f:
        port = int(f.read().strip())
    text = op.scrape_url(f"http://127.0.0.1:{port}/metrics")
    fams = op.parse_openmetrics(text or "")
    return {name + "".join(f"{{{k}={v}}}" for k, v in labels.items()): v_
            for name, samples in fams.items()
            if name.startswith("eksml_autoscale_")
            for labels, v_ in samples}


def operator_wave(logdir: str, device: str, waves, tag: str):
    """One operator run on a capacity wave: capacity 1 at launch, then
    each ``(chips, expect)`` of ``waves`` (``expect``: "relaunch",
    "refused" or "hold"), then SIGTERM.  Returns the transitions with their
    downtime (SIGTERM to the first logged step after the relaunch), the
    decisions, the operator's series and the HealthSignal it read."""
    run = OperatorRun(logdir, device)
    transitions = []
    try:
        first = run.wait(lambda: run.step_after(run.t0), "first step")
        log(f"[operator] {tag}: first step {first['step']} "
            f"{first['time'] - run.t0:.1f} s after the operator started")
        for chips, expect in waves:
            before = len(run.rows())
            run.capacity(chips)
            if expect == "hold":
                row = run.wait(lambda: [
                    r for r in run.rows()[before:]
                    if r.get("available_chips") == chips], f"{chips}")[0]
                assert (row["kind"], row["action"]) == ("decision", "hold"), \
                    row
                log(f"[operator] {tag}: capacity {chips}: {row['action']} "
                    f"({row['reason']})")
                transitions.append({"to": chips, "hold": row["reason"]})
                continue
            row = run.wait(lambda: [r for r in run.rows()[before:]
                                    if r["kind"] in ("relaunch", "refused")],
                           f"{expect} at {chips} chip(s)")[0]
            assert row["kind"] == expect, row
            if expect == "refused":
                log(f"[operator] {tag}: {chips} chip(s) refused: "
                    f"{row['reason']}")
                transitions.append({"to": chips, "refused": row["reason"]})
                continue
            assert row["exit_codes"] and all(
                c == 77 for c in row["exit_codes"]), row
            step = run.wait(lambda: run.step_after(row["launch_t"]),
                            f"a step at {chips} chip(s)")
            down = step["time"] - row["sigterm_t"]
            # the signal the decision read, from the trainer it stopped
            decided = [r for r in run.rows() if r.get("kind") == "decision"
                       and r["action"] == row["action"]][-1]
            transitions.append({"to": chips, "action": row["action"],
                                "exit_codes": row["exit_codes"],
                                "stop_s": row["stop_s"],
                                "downtime_s": down,
                                "first_step": step["step"],
                                "health": decided.get("health")})
            log(f"[operator] {tag}: {row['action']} to {chips}: ranks exited "
                f"{row['exit_codes']} in {row['stop_s']} s; first step "
                f"({step['step']}) {down:.1f} s after the SIGTERM")
        last = run.wait(lambda: [r for r in run.rows()
                                 if r.get("kind") == "decision"
                                 and r.get("health")][-1:],
                        "a decision with a trainer scrape")[-1]
        series = _operator_series(logdir)
        rc = run.stop()
    finally:
        run.kill()
    rows = run.rows()
    stop = [r for r in rows if r["kind"] == "stop"]
    assert rc == 0 and stop and all(c == 77 for c in stop[-1]["exit_codes"]), \
        (rc, stop)
    moves = [r for r in rows if r["kind"] != "decision"
             or r["action"] != "hold"]
    holds = sum(1 for r in rows if r["kind"] == "decision"
                and r["action"] == "hold")
    log(f"[operator] {tag}: autoscale-host0.jsonl: {holds} hold(s) and "
        + json.dumps([{k: r[k] for k in ("kind", "action", "target",
                                         "reason", "exit_codes")
                       if k in r} for r in moves]))
    log(f"[operator] {tag}: eksml_autoscale_* " + json.dumps(series))
    log(f"[operator] {tag}: HealthSignal read from the trainer's /metrics "
        "at each transition's decision and at the last tick: "
        + json.dumps([t.get("health") for t in transitions
                      if "action" in t] + [last["health"]]))
    return {"transitions": transitions, "series": series,
            "health": last["health"], "stop": stop[-1], "run": run}


def phase_operator(workdir: str, device: str = "cuda", cards=None):
    """The elastic operator (``--mode local``) on a capacity file that
    goes 1 -> 2 -> 1 GPUs, SMOKE widths.  With two or more cards the
    ranks are NCCL ranks on the cards.  With one, the wave runs as gloo
    ranks on the CPU, and on the card a world-1 trainer sees the 1 -> 2
    decision refused, is stopped by the operator (exit 77) and relaunched
    by a second one: it resumes from the forced checkpoint and steps."""
    import torch

    from eksml_tpu_torch.utils.checkpoint import CheckpointManager

    cards = torch.cuda.device_count() if cards is None else cards
    out = {}
    wave = ((2, "relaunch"), (1, "relaunch"))
    if device == "cuda" and cards >= 2:
        out["wave"] = operator_wave(os.path.join(workdir, "operator"),
                                    "cuda", wave, "cuda")
        return out
    log(f"[operator] {cards} card(s): the 1 -> 2 -> 1 wave runs as gloo "
        "ranks on the CPU (two ranks never share a card)")
    out["wave"] = operator_wave(os.path.join(workdir, "operator-cpu"),
                                "cpu", wave, "cpu")
    if device != "cuda":
        return out
    card_dir = os.path.join(workdir, "operator-card")
    first = operator_wave(card_dir, "cuda", ((2, "refused"), (1, "hold")),
                          "card")
    forced = CheckpointManager(card_dir).latest_step()
    assert forced is not None, "no forced checkpoint on the card"
    again = OperatorRun(card_dir, "cuda", "--initial-chips", "1")
    try:
        launch = again.wait(lambda: [r for r in again.rows()
                                     if r["kind"] == "launch"],
                            "a relaunch")[0]
        step = again.wait(lambda: again.step_after(launch["launch_t"]),
                          "a step after the relaunch")
        rc = again.stop()
    finally:
        again.kill()
    stop = [r for r in again.rows() if r["kind"] == "stop"]
    assert rc == 0 and stop and stop[-1]["exit_codes"] == [77], (rc, stop)
    assert step["step"] == forced + 1, (step["step"], forced)
    down = step["time"] - first["stop"]["sigterm_t"]
    log(f"[operator] card: the world-1 trainer exited "
        f"{first['stop']['exit_codes']} at its forced checkpoint (step "
        f"{forced}); a second operator relaunched it and it logged step "
        f"{step['step']} {down:.1f} s after the SIGTERM; stopped again: "
        f"{stop[-1]['exit_codes']}")
    out["card"] = {"refused": first["transitions"], "forced_step": forced,
                   "first_step": step["step"], "downtime_s": down,
                   "series": first["series"], "health": first["health"]}
    return out


# ---------------------------------------------------------------------
# phase 8: data-parallel training through a process group
# ---------------------------------------------------------------------

#: the largest relative difference a logged loss of the dist phase may
#: have from the plain train phase's same step.  Step 1 starts from the
#: same weights, batch and priorities and its forward is deterministic:
#: 1e-6 (the train_reference phase's card-vs-CPU spread is below it;
#: measured 0).  From step 2 on the plain train phase differs from itself
#: run to run: the backward's float atomics change an update in its last
#: bits, and the proposal top-k, NMS and IoU thresholds turn that into a
#: different sampled ROI now and then, one ROI of 2048 moving
#: frcnn_cls_loss by ~1e-3.  Five chip runs of the plain train phase
#: (PR 5 calls 1-4, PR 6 call 1) spread up to 2.0e-3 over steps 2-6;
#: the tolerance is five times that.
DIST_STEP1_TOL = 1e-6
DIST_LOSS_TOL = 1e-2
LOSS_KEYS = ("rpn_cls_loss", "rpn_box_loss", "frcnn_cls_loss",
             "frcnn_box_loss", "mrcnn_loss", "total_loss")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def entry_ranks(nranks: int, argv, workdir: str, timeout: float,
                command=("-m", "eksml_tpu_torch.train"), tag: str = "rank"):
    """``python -m eksml_tpu_torch.train`` (or ``python <command>``) as
    ``nranks`` processes of one host, formed by the JobSet env
    (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES=1``, ``LOCAL_WORLD_SIZE``,
    ``LOCAL_RANK``).  Returns each rank's ``(exit code, output)``; kills
    every rank on a timeout."""
    port = _free_port()
    procs = []
    for r in range(nranks):
        env = {k: v for k, v in os.environ.items()
               if k not in ("PROCESS_ID", "SLICE_INDEX",
                            "JOB_COMPLETION_INDEX")}
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="1", LOCAL_WORLD_SIZE=str(nranks),
                   LOCAL_RANK=str(r), PYTHONPATH=os.path.dirname(
                       os.path.abspath(__file__)))
        log_path = os.path.join(workdir, f"{tag}{r}.log")
        with open(log_path, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, *command] + list(argv), env=env, stdout=f,
                stderr=subprocess.STDOUT), log_path))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, path in procs:
        with open(path) as f:
            out.append((p.returncode, f.read()))
    return out


def logged_losses(text: str):
    """``{step: total_loss}`` from a trainer's ``step k/n loss=x`` lines."""
    import re

    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step (\d+)/\d+ loss=([-+.\deE]+|nan|inf)", text)}


def phase_dist(cfg, kernels, seed: int, train, workdir: str,
               device: str = "cuda"):
    """A world-size-1 NCCL group in this process: ``TRAIN_STEPS`` steps
    of ``Trainer.fit`` under ``replicated`` (DDP) and under ``fsdp``
    (FSDP2), each from the train phase's seed-0 weights and batches, held
    to the train phase's losses and launches; the replica sync check;
    the FSDP2 checkpoint gathered, then restored bitwise by a Trainer
    without a group.  ``device="cpu"`` (a gloo group) rehearses the
    phase on the CPU."""
    import torch
    import torch.distributed as dist

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.parallel.collectives import (
        assert_replicas_in_sync, warm_mesh_collectives)
    from eksml_tpu_torch.train import Trainer
    from eksml_tpu_torch.utils.checkpoint import snapshot_to_host

    out = {}
    path_launches = {}
    batches = train["batches"]
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0,
        **({"device_id": torch.device("cuda", 0)} if device == "cuda"
           else {}))
    out["nccl_init_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    warm_mesh_collectives()
    torch.cuda.synchronize()
    out["warm_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"[dist] {dist.get_backend()} group of 1 rank: init_process_group "
        f"{out['nccl_init_ms']:.1f} ms, first all-reduce (communicator "
        f"set-up) {out['warm_ms']:.1f} ms")
    live = None
    try:
        for strategy in ("replicated", "fsdp"):
            scfg = cfg.clone()
            scfg.freeze(False)
            scfg.update_args([f"TRAIN.SHARDING.STRATEGY={strategy}"])
            scfg.freeze()
            logdir = os.path.join(workdir, f"dist_{strategy}")
            t0 = time.perf_counter()
            trainer = Trainer(scfg, logdir=logdir, device=device)
            setup_ms = (time.perf_counter() - t0) * 1e3
            trainer.init_state(init_params(
                scfg, torch.Generator().manual_seed(seed)))
            for k in kernels:
                k.launches = 0
            rows = trainer.fit(iter(batches[:1]), 1)
            torch.cuda.synchronize()
            step1 = {k.name: k.launches for k in kernels}
            torch.cuda.reset_peak_memory_stats()
            rows += trainer.fit(iter(batches[1:]), TRAIN_STEPS, start_step=1)
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in kernels}
            path_launches[strategy] = launches
            peak = torch.cuda.max_memory_allocated()
            param_bytes, opt_bytes = trainer.state_bytes()
            times = sorted(r["step_time_ms"] for r in rows[1:])
            diffs = [max(abs(r[k] - p[k]) / max(abs(p[k]), 1e-30)
                         for k in LOSS_KEYS)
                     for r, p in zip(rows, train["rows"])]
            diff = max(diffs[1:])
            rec = {"plan": trainer.plan.describe(), "setup_ms": setup_ms,
                   "step1_s": rows[0]["step_time_ms"] / 1e3,
                   "median_ms": times[len(times) // 2], "peak_bytes": peak,
                   "param_bytes": param_bytes, "opt_bytes": opt_bytes,
                   "loss_rel_diff_step1": diffs[0], "loss_rel_diff": diff,
                   "launches": launches}
            log(f"[dist] {strategy} ({rec['plan']}, "
                f"{type(trainer.train_module).__name__}): Trainer set-up "
                f"(mesh, warm-up, plan) {setup_ms:.1f} ms; step 1 "
                f"{rec['step1_s']:.2f} s; steps 2-{TRAIN_STEPS} median "
                f"{rec['median_ms']:.1f} ms (plain train phase "
                f"{train['median_s'] * 1e3:.1f} ms); peak after step 1 "
                f"{peak / 2 ** 30:.2f} GiB; state per device: parameters "
                f"and buffers {param_bytes} B, optimizer {opt_bytes} B; "
                f"launches in step 1 {step1}, in {TRAIN_STEPS} steps "
                f"{launches}; largest relative loss difference from the "
                f"plain train phase's same step: step 1 {diffs[0]:.3e} "
                f"(tolerance {DIST_STEP1_TOL}), steps 2-{TRAIN_STEPS} "
                f"{diff:.3e} (tolerance {DIST_LOSS_TOL})")
            _per_step(kernels, step1, 1)
            _per_step(kernels, launches, TRAIN_STEPS)
            assert diffs[0] <= DIST_STEP1_TOL and diff <= DIST_LOSS_TOL, [
                (r["step"], {k: (r[k], p[k]) for k in LOSS_KEYS})
                for r, p in zip(rows, train["rows"])]
            if strategy == "replicated":
                assert assert_replicas_in_sync(trainer.model.state_dict(),
                                               trainer.generator.get_state())
                log("[dist] assert_replicas_in_sync: in sync")
            else:
                trainer.ckpt.wait()
                assert trainer.ckpt.latest_step() == TRAIN_STEPS
                t0 = time.perf_counter()
                state = trainer.checkpoint_state()
                torch.cuda.synchronize()
                rec["gather_ms"] = (time.perf_counter() - t0) * 1e3
                live = snapshot_to_host(state)
                del state
                log(f"[dist] FSDP2 full-state gather of step {TRAIN_STEPS} "
                    f"for the checkpoint: {rec['gather_ms']:.1f} ms")
            out[strategy] = rec
            trainer.close()
            del trainer
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # the FSDP2 step, restored by a Trainer without a group
    plain = Trainer(cfg, logdir=os.path.join(workdir, "dist_fsdp"),
                    device=device)
    assert plain.restore_or_init() == TRAIN_STEPS
    got = plain.checkpoint_state()
    differ = [k for k in live["model"]
              if not torch.equal(got["model"][k].cpu(), live["model"][k])]
    ma, mb = got["optimizer"]["state"], live["optimizer"]["state"]
    assert set(ma) == set(mb) and len(mb) > 40, (len(ma), len(mb))
    differ += [f"momentum {i}" for i in mb if not torch.equal(
        ma[i]["momentum_buffer"].cpu(), mb[i]["momentum_buffer"])]
    if not torch.equal(got["generator"].cpu(), live["generator"]):
        differ.append("generator")
    log(f"[dist] the FSDP2 checkpoint restored without a group: "
        f"{len(live['model'])} model tensors, {len(mb)} momentum buffers "
        f"and the generator bitwise equal: {not differ}")
    assert not differ, differ[:5]
    plain.close()
    del plain, got, live
    torch.cuda.empty_cache()

    out["launches"] = {k.name: sum(c[k.name] for c in path_launches.values())
                       for k in kernels}
    out["launches_by_strategy"] = path_launches
    return out


def phase_ranks(workdir: str):
    """Where two or more devices exist, ``python -m eksml_tpu_torch.train
    --synthetic`` as 2 ranks under ``fsdp`` (3 steps at the default
    config): both ranks must log the same losses and one checkpoint
    commit; with one device, one line saying so."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        log(f"[ranks] the 2-rank run of python -m eksml_tpu_torch.train was "
            f"not run: this machine shows {n} CUDA device(s) and the run "
            "needs one per rank")
        return None
    run = os.path.join(workdir, "two_ranks")
    os.makedirs(run)
    t0 = time.perf_counter()
    res = entry_ranks(2, [
        "--synthetic", "--logdir", run, "--total-steps", "3",
        "--config", "TRAIN.SHARDING.STRATEGY=fsdp", "TRAIN.NUM_CHIPS=2",
        f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}", "TRAIN.STEPS_PER_EPOCH=3",
        "TRAIN.CHECKPOINT_PERIOD=1", "TRAIN.LOG_PERIOD=1"], run,
        timeout=600)
    wall = time.perf_counter() - t0
    for r, (code, text) in enumerate(res):
        assert code == 0, f"rank {r} exited {code}:\n{text[-4000:]}"
    losses = [logged_losses(text) for _, text in res]
    steps = sorted(int(name) for name in os.listdir(
        os.path.join(run, "checkpoints")) if name.isdigit())
    log(f"[ranks] 2 ranks of python -m eksml_tpu_torch.train under fsdp "
        f"on {n} device(s), 3 steps in {wall:.1f} s (process start, NCCL, "
        f"cuDNN autotune included): losses rank 0 {losses[0]}, rank 1 "
        f"{losses[1]}; checkpoints {steps}")
    assert losses[0] == losses[1] and sorted(losses[0]) == [1, 2, 3]
    assert steps == [3], steps

    evaluated = ranks_eval(run, 3, train_config())
    return {"wall_s": wall, "losses": losses[0], **evaluated}


def ranks_eval(run: str, step: int, cfg):
    """One eval of ``run``'s checkpoint ``step`` as two ranks under fsdp
    (``eval_rank``), and the same eval in this process on one card:
    rank 0's AP dict must equal this process's to 1e-6."""
    import torch

    from eksml_tpu_torch.evalcoco import run_evaluation
    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.utils import CheckpointManager

    t0 = time.perf_counter()
    res = entry_ranks(2, ["--eval-rank", run], run, timeout=600,
                      command=(os.path.abspath(__file__),), tag="eval_rank")
    eval_wall = time.perf_counter() - t0
    for r, (code, text) in enumerate(res):
        assert code == 0, f"eval rank {r} exited {code}:\n{text[-4000:]}"
    with open(os.path.join(run, "eval_ranks.json")) as f:
        ranked = json.load(f)
    model = MaskRCNN.from_config(cfg)
    model.load_state_dict(CheckpointManager(run).restore(step)["model"])
    model.to("cuda")
    one = run_evaluation(model, cfg, shapes_records(
        os.path.join(run, "shapes_one"), "val2017", EVAL_IMAGES,
        RANKS_EVAL_SEED), device="cuda")
    diff = max(abs(one[k] - ranked["results"][k]) for k in one)
    same = set(one) == set(ranked["results"]) and diff <= 1e-6
    log(f"[ranks] eval of step {ranked['step']} as 2 ranks under fsdp "
        f"({eval_wall:.1f} s with process start): rank 0 bbox AP "
        f"{ranked['results']['bbox/AP']:.6f} segm AP "
        f"{ranked['results']['segm/AP']:.6f}; one process bbox AP "
        f"{one['bbox/AP']:.6f} segm AP {one['segm/AP']:.6f}; equal to 1e-6: "
        f"{same} (max |diff| {diff:.2e})")
    del model
    torch.cuda.empty_cache()
    assert ranked["step"] == step and same, (one, ranked)
    return {"eval_wall_s": eval_wall, "eval_AP_equal": same,
            "eval_AP_max_diff": diff}


# ---------------------------------------------------------------------
# phase 9: one training step, the card against the CPU
# ---------------------------------------------------------------------


def _shared_proposals(proposals, shared: list, where):
    """``MaskRCNN._proposals`` that records its outputs into the empty
    list ``shared`` (the first run), or returns the recorded ones on
    ``where`` (the second)."""
    def call(*args, **kwargs):
        if shared:
            return tuple(t.to(where) for t in shared)
        out = proposals(*args, **kwargs)
        shared.extend(t.detach().cpu() for t in out)
        return out
    return call


def phase_train_reference(seed: int, img: int = 256, tol: float = 1e-4,
                          update_tol: float = 1e-3, extra=(),
                          tag: str = "train_reference",
                          loss_tol: float = None,
                          share_proposals: bool = False):
    """One ``make_train_step`` at SMOKE widths on an ``img``² canvas,
    batch 2, from one set of weights, one batch and one set of
    priorities on the card and on the CPU.  The losses, ``grad_norm``
    and every gradient tensor agree within ``tol`` of each tensor's
    largest magnitude; every parameter update within ``update_tol`` of
    its largest magnitude (a float32 ulp of the parameter is up to ~1e-4
    of the update at this learning rate); the mask targets agree exactly
    except at pixels whose plain value lies within 1e-6 of 0.5.  Returns
    the worst errors and the number of gradient tensors compared.
    ``extra``: config overrides of a model variant; ``loss_tol`` (default ``tol``) holds
    the losses and ``grad_norm``.  Under ``TRAIN.PRECISION=bfloat16``
    each gradient and update tensor is held to twice the CPU's own
    bf16-vs-float32 difference of that tensor on the same step, and no
    less than ``BF16_TENSOR_FLOOR``, instead of ``tol`` and
    ``update_tol``.  ``share_proposals``: the card steps first and the
    CPU step takes the card's RPN proposals, so both sample the same ROIs
    (under bf16 the two devices' logits differ by rounding, and near-ties
    then reorder top-k and NMS: another sampled ROI set is another loss,
    not an error)."""
    import torch

    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.data.loader import make_synthetic_batch
    from eksml_tpu_torch.device import resolve_device
    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.ops.roi_align import batched_multilevel_roi_align
    from eksml_tpu_torch.train import make_optimizer, make_train_step

    dev = resolve_device("cuda")
    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        f"PREPROC.MAX_SIZE={img}",
        f"PREPROC.TRAIN_SHORT_EDGE_SIZE=({img},{img})", "TRAIN.BASE_LR=0.1",
        "TRAIN.WARMUP_STEPS=0", "TRAIN.BATCH_SIZE_PER_CHIP=2", *extra])
    cfg.freeze()
    batch = make_synthetic_batch(cfg, batch_size=2, image_size=img,
                                 seed=seed, gt_mask_size=28)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()
             if k not in ("image_scale", "image_id")}
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    shared = []

    def step(where, cfg):
        model = MaskRCNN.from_config(cfg)
        model.load_state_dict(params)
        model.to(where).train()
        if share_proposals:
            model._proposals = _shared_proposals(model._proposals, shared,
                                                 where)
        pri = model.make_priorities(
            (2, img, img, cfg.DATA.MAX_GT_BOXES),
            torch.Generator().manual_seed(seed))
        opt, sched = make_optimizer(model, cfg)
        grads = {}
        for n, p in model.named_parameters():
            if p.requires_grad:     # the raw gradient, as backward gives it
                p.register_hook(lambda g, n=n: grads.__setitem__(
                    n, g.detach().float().cpu().clone()))
        metrics = make_train_step(
            model, opt, sched, float(cfg.TRAIN.GRADIENT_CLIP))(
            {k: v.to(where) for k, v in batch.items()},
            {k: v.to(where) for k, v in pri.items()}, 0)
        updates = {n: (p.detach().float().cpu() - params[n])
                   for n, p in model.named_parameters()}
        return {k: float(v) for k, v in metrics.items()}, grads, updates, \
            model

    results = {str(where): step(where, cfg) for where in (
        (dev, "cpu") if share_proposals else ("cpu", dev))}
    (lc, gc, uc, mc), (lg, gg, ug, mg) = results["cpu"], results[str(dev)]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))

    def errors(g1, u1, g2, u2):
        return ({n: rel(g1[n], g2[n]) for n in g2},
                {n: rel(u1[n], u2[n]) for n in u2 if u2[n].abs().max() > 0})

    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc}
    assert gc and set(gg) == set(gc), set(gg) ^ set(gc)
    grad_err, upd_err = errors(gg, ug, gc, uc)
    grad_tol = dict.fromkeys(grad_err, tol)
    upd_tol = dict.fromkeys(upd_err, update_tol)
    if cfg.TRAIN.PRECISION == "bfloat16":
        # bf16 gradients are their own noise: the card's and the CPU's
        # bf16 steps are two roundings of one float32 step (same weights,
        # batch, priorities, proposals), so each tensor may differ by
        # twice what the CPU's bf16 step moves that tensor from its
        # float32 one
        f32 = cfg.clone()
        f32.freeze(False)
        f32.TRAIN.PRECISION = "float32"
        f32.freeze()
        _, g32, u32, _ = step("cpu", f32)
        noise_g, noise_u = errors(gc, uc, g32, u32)
        grad_tol = {n: max(2 * noise_g[n], BF16_TENSOR_FLOOR)
                    for n in grad_err}
        upd_tol = {n: max(2 * noise_u.get(n, 0.0), BF16_TENSOR_FLOOR)
                   for n in upd_err}
        tol, update_tol = max(grad_tol.values()), max(upd_tol.values())
        for what, err, tols, noise in (("gradients", grad_err, grad_tol,
                                        noise_g),
                                       ("updates", upd_err, upd_tol,
                                        noise_u)):
            worst = sorted(err, key=lambda n: err[n] / tols[n])[-4:]
            log(f"[{tag}] {what}, card vs CPU against each tensor's "
                "tolerance (twice the CPU's bf16-vs-float32 difference, "
                f"at least {BF16_TENSOR_FLOOR:.3g}), the 4 nearest: "
                + "; ".join(f"{n} {err[n]:.2e} / {tols[n]:.2e} (CPU "
                            f"{noise.get(n, 0.0):.2e})" for n in worst))

    # mask targets: jittered GT boxes on random disc masks
    rng = np.random.RandomState(seed)
    k, g, m0 = 16, cfg.DATA.MAX_GT_BOXES, 28
    gt = batch["gt_boxes"].numpy().copy()
    gt[:, :, 2:] = np.maximum(gt[:, :, 2:], gt[:, :, :2] + 4)
    yy, xx = np.mgrid[:m0, :m0]
    masks = np.stack([((yy - rng.rand() * m0) ** 2
                       + (xx - rng.rand() * m0) ** 2
                       < (rng.rand() * m0) ** 2) for _ in range(2 * g)]
                     ).reshape(2, g, m0, m0).astype(np.float32)
    matched = rng.randint(0, g, (2, k))
    rois = (gt[np.arange(2)[:, None], matched]
            + rng.randn(2, k, 4) * 5).astype(np.float32)
    args = [torch.from_numpy(x) for x in (rois, matched, gt, masks)]
    t_cpu = mc._mask_targets(*args)
    t_gpu = mg._mask_targets(*[a.to(dev) for a in args]).cpu()
    gb = gt[np.arange(2)[:, None], matched]
    gw = np.maximum(gb[..., 2] - gb[..., 0], 1e-4)
    gh = np.maximum(gb[..., 3] - gb[..., 1], 1e-4)
    mrois = np.stack([(rois[..., 0] - gb[..., 0]) / gw * m0,
                      (rois[..., 1] - gb[..., 1]) / gh * m0,
                      (rois[..., 2] - gb[..., 0]) / gw * m0,
                      (rois[..., 3] - gb[..., 1]) / gh * m0], -1)
    sampled = batched_multilevel_roi_align(
        [torch.from_numpy(masks[np.arange(2)[:, None], matched]
                          .reshape(-1, m0, m0, 1))],
        torch.from_numpy(mrois.astype(np.float32)).reshape(-1, 1, 4), (1,),
        28).reshape(2, k, 28, 28)
    differ = t_cpu != t_gpu
    near = (sampled - 0.5).abs() <= 1e-6
    loss_tol = tol if loss_tol is None else loss_tol
    log(f"[{tag}] card vs CPU, SMOKE widths, {img}², batch 2"
        f"{', ' + ' '.join(extra) if extra else ''}"
        f"{', the CPU on the card proposals' if share_proposals else ''}: "
        "losses and grad_norm max rel "
        f"{max(loss_err.values()):.2e}; gradients max "
        f"|diff|/max|CPU| {max(grad_err.values()):.2e} over {len(gc)} "
        f"tensors (worst {max(grad_err, key=grad_err.get)}); updates "
        f"{max(upd_err.values()):.2e} over {len(upd_err)} tensors; mask "
        f"targets differ at {int(differ.sum())} of {differ.numel()} pixels, "
        f"{int((differ & near).sum())} of them within 1e-6 of 0.5 "
        f"(tolerances: losses {loss_tol}, gradients up to {tol:.3g}, "
        f"updates up to {update_tol:.3g})")
    assert max(loss_err.values()) <= loss_tol, loss_err
    assert all(grad_err[n] <= grad_tol[n] for n in grad_err), {
        n: (e, grad_tol[n]) for n, e in grad_err.items() if e > grad_tol[n]}
    assert all(upd_err[n] <= upd_tol[n] for n in upd_err), {
        n: (e, upd_tol[n]) for n, e in upd_err.items() if e > upd_tol[n]}
    assert not (differ & ~near).any(), "mask targets differ"
    return {"losses": max(loss_err.values()),
            "gradients": max(grad_err.values()),
            "updates": max(upd_err.values()), "gradient_tensors": len(gc),
            "loss_values": lc}


# ---------------------------------------------------------------------
# phases 11-13: COCO eval and training on COCO data
# ---------------------------------------------------------------------

EVAL_IMAGES = 32
SHAPE_CATEGORIES = [{"id": 1, "name": "box"}, {"id": 2, "name": "blob"},
                    {"id": 3, "name": "wedge"}]
# SMOKE widths of the eval_reference phase (canvases divisible by the
# largest anchor stride, 64)
REF_IMG = 256
REF_BUCKETS = "PREPROC.BUCKETS=((192,256),(256,192),(256,256))"


def _shape_polygon(cls: int, x, y, w, h, rng) -> list:
    """One shape as a flat COCO polygon: a rectangle, a 16-gon ellipse or
    a wedge (a quadrilateral: the reference's even-odd fill inverts
    polygons of an odd vertex count, and the eval phases hold the port to
    the reference)."""
    if cls == 1:
        pts = [(x, y), (x + w, y), (x + w, y + h), (x, y + h)]
    elif cls == 2:
        t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
        pts = list(zip(x + w / 2 + np.cos(t) * w / 2,
                       y + h / 2 + np.sin(t) * h / 2))
    else:
        tip = x + w * rng.uniform(0.3, 0.7)
        pts = [(tip - 1, y), (tip + 1, y), (x + w, y + h), (x, y + h)]
    return [float(v) for p in pts for v in p]


def shapes_coco(n: int, seed: int, size=(480, 640), id_base: int = 1):
    """``n`` images of solid shapes on textured backgrounds (the classes
    of ``tools/make_shapes_coco.py``, drawn with the port's
    ``polygon_fill``), landscape and portrait in turn around ``size``:
    ``(COCO annotation dict, {file_name: uint8 image})``."""
    from eksml_tpu_torch.data.masks import polygon_fill

    rng = np.random.RandomState(seed)
    images, anns, pixels = [], [], {}
    for i in range(n):
        h, w = size if i % 2 == 0 else size[::-1]
        h += int(rng.randint(-h // 16, h // 16 + 1))
        w += int(rng.randint(-w // 16, w // 16 + 1))
        img = (rng.randint(90, 160) + rng.randint(-25, 25, (h, w, 3))
               ).clip(0, 255).astype(np.uint8)
        name = f"shape_{id_base + i:05d}.jpg"
        images.append({"id": id_base + i, "file_name": name, "height": h,
                       "width": w})
        for _ in range(int(rng.randint(1, 4))):
            cls = int(rng.randint(1, 4))
            bw = float(rng.randint(min(h, w) // 6, min(h, w) // 2))
            bh = float(rng.randint(min(h, w) // 6, min(h, w) // 2))
            x = float(rng.randint(0, int(w - bw)))
            y = float(rng.randint(0, int(h - bh)))
            poly = _shape_polygon(cls, x, y, bw, bh, rng)
            m = polygon_fill(np.asarray(poly).reshape(-1, 2), h, w)
            img[m.astype(bool)] = rng.randint(0, 256, 3)
            xs, ys = poly[0::2], poly[1::2]
            anns.append({"id": len(anns) + 1, "image_id": id_base + i,
                         "category_id": cls, "iscrowd": 0,
                         "bbox": [min(xs), min(ys), max(xs) - min(xs),
                                  max(ys) - min(ys)],
                         "area": float(m.sum()), "segmentation": [poly]})
        pixels[name] = img
    return ({"images": images, "annotations": anns,
             "categories": SHAPE_CATEGORIES}, pixels)


def shapes_records(workdir: str, split: str, n: int, seed: int,
                   size=(480, 640)):
    """The shapes split's annotation JSON written under ``workdir`` and
    read back through the port's ``CocoDataset``; each record carries its
    pixels on ``_image`` (no image file is written or decoded)."""
    from eksml_tpu_torch.data.coco import CocoDataset

    data, pixels = shapes_coco(n, seed, size)
    os.makedirs(os.path.join(workdir, "annotations"), exist_ok=True)
    with open(os.path.join(workdir, "annotations",
                           f"instances_{split}.json"), "w") as f:
        json.dump(data, f)
    records = CocoDataset(workdir, split).records(skip_empty=False)
    for rec in records:
        rec["_image"] = pixels[os.path.basename(rec["path"])]
    return records


def phase_eval(cfg, kernels, trainer, workdir: str, seed: int):
    """``Trainer._run_eval`` once, on the train phase's Trainer, thread
    and weights, over ``EVAL_IMAGES`` shapes images at the default
    config.  Returns the timings, launches, AP and peak memory."""
    import torch

    from eksml_tpu_torch.evalcoco import make_eval_fn

    records = shapes_records(os.path.join(workdir, "eval"), "val2017",
                             EVAL_IMAGES, seed + 11)
    timings, results = {}, {}
    inner = make_eval_fn(cfg, device="cuda", records=records,
                         timings=timings)

    def eval_fn(model, step):
        results.update(inner(model, step))
        return results

    trainer.eval_fn = eval_fn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the eval path's run: every count starts at 0 here
    for k in kernels:
        k.launches = 0
    trainer._run_eval(trainer.step)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    trainer.eval_fn = None
    assert results, "the eval raised (its traceback is logged above)"
    pred = timings["predict_s"]
    batches = len(pred)
    rest = sorted(pred[1:]) or pred
    wall = timings["wall_s"]
    per_image_post = timings["post_s"] / max(1, timings["post_images"])
    log(f"[eval] {len(records)} images at {cfg.PREPROC.MAX_SIZE}² "
        f"(TEST.EVAL_BATCH_SIZE={cfg.TEST.EVAL_BATCH_SIZE}, {batches} "
        f"batches) in {wall:.2f} s = {len(records) / wall:.2f} images/s; "
        f"first batch predict {pred[0]:.3f} s (cuDNN autotune of new "
        f"shapes), batches 2-{batches} median {rest[len(rest) // 2] * 1e3:.1f}"
        f" ms; batch build {np.mean(timings['build_s']) * 1e3:.1f} ms per "
        f"batch (worker thread); paste + RLE {per_image_post * 1e3:.2f} ms "
        f"per image ({timings['detections'] / len(records):.1f} kept "
        f"detections per image; pool of "
        f"{max(1, int(cfg.DATA.NUM_WORKERS or 1))}); "
        f"accumulate {timings['accumulate_s']:.3f} s; peak torch.cuda."
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    log(f"[eval] launches {launches} = {launches[kernels.fwd.name] / batches}"
        f" ROIAlign forward launches per batch")
    log("[eval] AP " + json.dumps({k: round(v, 6) for k, v in
                                   sorted(results.items())}))
    want = {kernels.fwd.name: 2 * batches, kernels.bwd.name: 0,
            kernels.copy.name: 0}
    assert launches == want, (launches, want)
    for k in ("bbox/AP", "segm/AP"):
        assert -1.0 <= results[k] <= 1.0 and np.isfinite(results[k]), k
    return {"wall_s": wall, "images_per_s": len(records) / wall,
            "first_batch_s": pred[0], "median_batch_s": rest[len(rest) // 2],
            "build_ms_per_batch": float(np.mean(timings["build_s"])) * 1e3,
            "post_ms_per_image": per_image_post * 1e3,
            "detections_per_image": timings["detections"] / len(records),
            "accumulate_s": timings["accumulate_s"], "batches": batches,
            "launches": launches, "peak_bytes": peak,
            "bbox_AP": results["bbox/AP"], "segm_AP": results["segm/AP"]}


def eval_reference_config():
    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config

    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        f"PREPROC.MAX_SIZE={REF_IMG}",
        f"PREPROC.TRAIN_SHORT_EDGE_SIZE=({REF_IMG},{REF_IMG})",
        f"PREPROC.TEST_SHORT_EDGE_SIZE={REF_IMG}", REF_BUCKETS,
        "RPN.TEST_PRE_NMS_TOPK=256", "RPN.TEST_POST_NMS_TOPK=128",
        "DATA.NUM_CLASSES=4", "TRAIN.BATCH_SIZE_PER_CHIP=2",
        "TRAIN.LOG_PERIOD=1", "DATA.NUM_WORKERS=2"])
    cfg.freeze()
    return cfg


def eval_card_and_cpu(cfg, records, params, card: str = "cuda"):
    """``run_evaluation`` of one set of weights on the card and on the
    CPU: ``{"cuda"/"cpu": (AP dict, [predict outputs per batch])}``
    (``card``: where the "cuda" run goes; the CPU in rehearsals)."""
    import torch

    from eksml_tpu_torch.evalcoco import runner
    from eksml_tpu_torch.models import MaskRCNN

    out = {}
    for name, device in (("cuda", card), ("cpu", "cpu")):
        model = MaskRCNN.from_config(cfg)
        model.load_state_dict(params)
        model.to(device)
        kept = []

        def predict(m, images, hw, kept=kept):
            res = {k: v.cpu() for k, v in runner.predict(m, images,
                                                         hw).items()}
            kept.append(res)
            return res

        out[name] = (runner.run_evaluation(model, cfg, records,
                                             batch_size=2, device=device,
                                             predict_fn=predict), kept)
        del model
    torch.cuda.empty_cache()
    return out


def compare_eval(out, tols=(("boxes", 1e-3), ("scores", 1e-5),
                            ("masks", 1e-4))):
    """The card's eval against the CPU's: equal batches, classes, validity
    (detections per image) and AP keys; the largest differences of the
    float outputs and of the AP values."""
    (res_g, got), (res_c, want) = out["cuda"], out["cpu"]
    assert len(got) == len(want) and len(got) > 0
    errs = {k: 0.0 for k, _ in tols}
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["valid"].sum(1).tolist() == w["valid"].sum(1).tolist()
        assert bool((g["valid"] == w["valid"]).all())
        assert bool((g["classes"] == w["classes"]).all())
        for k, _ in tols:
            errs[k] = max(errs[k], float((g[k] - w[k]).abs().max()))
    assert set(res_g) == set(res_c) and "segm/AP" in res_g
    errs["AP"] = max(abs(res_g[k] - res_c[k]) for k in res_c)
    return errs


def phase_eval_reference(kernels, seed: int, workdir: str,
                         device: str = "cuda"):
    """At SMOKE widths with ``PREPROC.BUCKETS``: ``run_evaluation`` on the
    card and on the CPU from the same weights over 8 shapes images, held
    to the serve parity tolerances (boxes 1e-3, scores 1e-5, masks 1e-4,
    equal detections per image) and the AP to 1e-6; then one bucketed
    training step on the card from the file-backed loader."""
    import torch

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.data.loader import DetectionLoader
    from eksml_tpu_torch.train import Trainer

    cfg = eval_reference_config()
    records = shapes_records(os.path.join(workdir, "eval_reference"),
                             "val2017", 8, seed + 12, size=(180, 240))
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    out = eval_card_and_cpu(cfg, records, params, card=device)
    errs = compare_eval(out)
    log(f"[eval_reference] {len(records)} images, {len(out['cuda'][1])} "
        f"batches, card vs CPU in {time.perf_counter() - t0:.1f} s: max "
        f"|diff| boxes {errs['boxes']:.2e} px, scores {errs['scores']:.2e},"
        f" masks {errs['masks']:.2e}, AP {errs['AP']:.2e}; detections per "
        f"image equal; card AP bbox {out['cuda'][0]['bbox/AP']:.4f} segm "
        f"{out['cuda'][0]['segm/AP']:.4f}")
    assert errs["boxes"] <= 1e-3 and errs["scores"] <= 1e-5, errs
    assert errs["masks"] <= 1e-4 and errs["AP"] <= 1e-6, errs

    loader = DetectionLoader(records, cfg, 2, seed=seed,
                             with_masks=cfg.MODE_MASK)
    batches = list(loader.batches(1))
    trainer = Trainer(cfg, os.path.join(workdir, "eval_reference_train"),
                      device=device)
    trainer.init_state(params)
    for k in kernels:
        k.launches = 0
    rows = trainer.fit(iter(batches), 1)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    trainer.close()
    log(f"[eval_reference] one bucketed training step on the card, canvas "
        f"{batches[0]['images'].shape[1:3]}: total_loss "
        f"{rows[0]['total_loss']:.5g}, launches {launches}")
    assert np.isfinite(rows[0]["total_loss"])
    assert launches == {kernels.fwd.name: 3, kernels.bwd.name: 2,
                        kernels.copy.name: 2 * len(LEVEL_STRIDES)}, launches
    return {"errors": errs, "train_launches": launches}


def phase_coco(kernels, seed: int, workdir: str, device: str = "cuda"):
    """Where PIL imports: the shapes dataset as JPEGs under ``workdir``
    and ``eksml_tpu_torch.train.main`` without ``--synthetic`` for 2 steps
    at SMOKE widths with ``TRAIN.EVAL_PERIOD=1``; ``val/bbox/AP`` and
    ``val/segm/AP`` must reach metrics.jsonl.  Where PIL does not import,
    one line saying so (the JPEGs can be neither written nor decoded)."""
    import torch

    try:
        import PIL  # noqa: F401 — the JPEGs need it
    except ImportError as e:
        log(f"[coco] train.main on a COCO directory was not run: PIL does "
            f"not import on this machine ({e}), so no JPEG can be written "
            "or decoded here")
        return None
    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config
    from eksml_tpu_torch.train import main

    base = os.path.join(workdir, "coco")
    for split, n, offset in (("train2017", 8, 0), ("val2017", 4, 100)):
        write_shapes_split(base, split, n, seed + offset, size=(180, 240),
                           id_base=1 + offset)
    run = os.path.join(workdir, "coco_run")
    saved = config.to_dict()      # main overrides the global config
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        assert main(["--device", device, "--logdir", run, "--total-steps",
                     "2", "--config",
                     *SMOKE_OVERRIDES, f"PREPROC.MAX_SIZE={REF_IMG}",
                     f"PREPROC.TRAIN_SHORT_EDGE_SIZE=({REF_IMG},{REF_IMG})",
                     f"PREPROC.TEST_SHORT_EDGE_SIZE={REF_IMG}",
                     f"DATA.BASEDIR={base}", "DATA.NUM_CLASSES=4",
                     # COCO files whatever the global config holds
                     "DATA.SYNTHETIC=False",
                     "TRAIN.BATCH_SIZE_PER_CHIP=2", "TRAIN.STEPS_PER_EPOCH=1",
                     "TRAIN.EVAL_PERIOD=1", "TRAIN.CHECKPOINT_PERIOD=2",
                     "TRAIN.LOG_PERIOD=1", "TRAIN.SHARDING.STRATEGY="
                     "replicated"]) == 0
    finally:
        config.freeze(False)
        config.from_dict(saved)
        config.freeze()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    evals = {r["step"]: (r["val/bbox/AP"], r["val/segm/AP"])
             for r in rows if "val/bbox/AP" in r}
    log(f"[coco] train.main on {base}: 2 steps with eval every epoch in "
        f"{wall:.1f} s; val (bbox AP, segm AP) by step {evals}; launches "
        f"{launches}")
    assert sorted(evals) == [1, 2], (evals, launches)
    return {"wall_s": wall, "evals": evals, "launches": launches}


# ---------------------------------------------------------------------
# phases 14-17: the model variants the charts run
# ---------------------------------------------------------------------

#: the optimized chart's operating point (charts/maskrcnn-optimized)
BF16_TRAIN = ("TRAIN.PRECISION=bfloat16", "TRAIN.REMAT=True")
#: the cascade overlay (charts/maskrcnn/values-cascade-r101.yaml)
CASCADE = ("MODE_CASCADE=True", "BACKBONE.RESNET_NUM_BLOCKS=(3,4,23,3)")
CASCADE_STEPS = 4
#: overrides under every variant phase's own (none on the card: full
#: width; a CPU rehearsal sets SMOKE widths here)
VARIANT_BASE = ()
#: card vs CPU under bf16 compute: losses and grad_norm to 8 bf16
#: epsilons (cuDNN's and oneDNN's bf16 convolutions round their outputs
#: after sums in other orders; the CPU tests hold the port to JAX's
#: bf16 at 4 epsilons of a trunk output, 0.2 % of a loss); each
#: gradient and update tensor to twice what bf16 itself moves that
#: tensor on the CPU (phase_train_reference)
BF16_LOSS_TOL = 8 * BF16_EPS
#: the least tolerance of one gradient or update tensor under bf16
#: compute (phase_train_reference): 8 bf16 epsilons of its largest
#: magnitude, where the CPU's own bf16-vs-float32 difference is smaller
BF16_TENSOR_FLOOR = 8 * BF16_EPS
#: card vs CPU with GroupNorm at the variants' seed: the losses to 1e-4
#: as float32, gradients and updates to 5e-2 of each tensor's largest
#: magnitude.  The GN model's gradients there are ill-conditioned: a
#: 1e-7 relative change of the weights moves them by 1.1e-2 of their
#: largest magnitude on the CPU (FreezeBN: 3.2e-6), with the proposals
#: shared or not, so no two orders of summation agree closer
GN_GRAD_TOL = 5e-2


def variant_config(*overrides, training: bool = True):
    """A clone of the global config with ``overrides``, finalized (the
    global config stays as it is, so no phase inherits a variant)."""
    from eksml_tpu_torch.config import config, finalize_configs

    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(VARIANT_BASE) + list(overrides))
    return finalize_configs(training, cfg)


def _train_run(cfg, kernels, seed: int, logdir: str, batches, want,
               tag: str, keep: bool = False):
    """``len(batches)`` steps of ``Trainer.fit`` at ``cfg`` from seed
    weights: step 1 apart from the median of the rest, peak memory after
    step 1, the state bytes, the kernels' launches per step (held to
    ``want``) and finite losses.  The counts start at 0 just before the
    run.  Returns the record (and the trainer, with ``keep``)."""
    import torch

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.train import Trainer

    steps = len(batches)
    trainer = Trainer(cfg, logdir=logdir, device="cuda")
    trainer.init_state(init_params(cfg, torch.Generator().manual_seed(seed)))
    it = iter(batches)
    for k in kernels:
        k.launches = 0
    rows = trainer.fit(it, 1)
    torch.cuda.synchronize()
    step1 = {k.name: k.launches for k in kernels}
    torch.cuda.reset_peak_memory_stats()
    rows += trainer.fit(it, steps, start_step=1)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    param_bytes, opt_bytes = trainer.state_bytes()
    loss_keys = [k for k in rows[0] if k.endswith("_loss")]
    for r in rows:
        log(f"[{tag}] step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.5g}" for k in loss_keys + ["grad_norm"])
            + f"; {r['step_time_ms']:.1f} ms")
    times = sorted(r["step_time_ms"] for r in rows[1:])
    median = float(np.median(times))
    dtypes = sorted({str(v.dtype) for v in trainer.model.state_dict()
                     .values()})
    log(f"[{tag}] step 1 {rows[0]['step_time_ms'] / 1e3:.2f} s; steps "
        f"2-{steps} median {median:.1f} ms (min {times[0]:.1f}, max "
        f"{times[-1]:.1f}); peak after step 1 {peak / 2 ** 30:.2f} GiB; "
        f"state bytes: params {param_bytes}, optimizer {opt_bytes} "
        f"({', '.join(dtypes)}); launches in step 1 {step1}, in {steps} "
        f"steps {launches}")
    for r in rows:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        assert not bad, f"{tag} step {r['step']}: non-finite {bad}"
    assert step1 == want, f"{tag}: launches in one step {step1}, want {want}"
    assert launches == {k: n * steps for k, n in want.items()}, launches
    rec = {"step1_s": rows[0]["step_time_ms"] / 1e3, "median_ms": median,
           "peak_bytes": peak, "param_bytes": param_bytes,
           "opt_bytes": opt_bytes, "launches": launches,
           "launches_per_step": step1, "rows": rows}
    if keep:
        return rec, trainer
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    return rec


def _synthetic_batches(cfg, seed: int, batch: int, steps: int):
    from eksml_tpu_torch.data.loader import DetectionLoader, SyntheticDataset

    ds = SyntheticDataset(num_images=2 * batch, height=800, width=1333,
                          max_boxes=8, num_classes=cfg.DATA.NUM_CLASSES,
                          seed=seed)
    loader = DetectionLoader(ds.records(), cfg, batch, seed=seed,
                             with_masks=cfg.MODE_MASK, gt_mask_size=56)
    return list(loader.batches(steps))


def phase_train_bf16(kernels, seed: int, workdir: str):
    """The optimized chart's operating point: R50-FPN at full width and
    depth, ``TRAIN.PRECISION=bfloat16``, ``TRAIN.REMAT=True``, 1344²,
    batch 4, float32 storage, seed weights: ``TRAIN_STEPS`` steps; then 3
    steps with ``REMAT=False`` and 3 with ``PARAM_DTYPE=bfloat16`` (REMAT
    on), in this thread (their convolutions reuse the first run's cuDNN
    autotune)."""
    base = (f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}", "TRAIN.LOG_PERIOD=1")
    cfg = variant_config(*base, *BF16_TRAIN)
    batches = _synthetic_batches(cfg, seed, BATCH, TRAIN_STEPS)
    want = {kernels.fwd.name: 3, kernels.bwd.name: 2,
            kernels.copy.name: 2 * len(LEVEL_STRIDES)}
    out = {}
    for name, extra, steps in (
            ("remat", (), TRAIN_STEPS),
            ("no_remat", ("TRAIN.REMAT=False",), min(3, TRAIN_STEPS)),
            ("param_bf16", ("TRAIN.PARAM_DTYPE=bfloat16",),
             min(3, TRAIN_STEPS))):
        cfg = variant_config(*base, *BF16_TRAIN, *extra)
        out[name] = _train_run(cfg, kernels, seed,
                               os.path.join(workdir, f"train_bf16_{name}"),
                               batches[:steps], want, f"train_bf16 {name}")
    r, n, p = out["remat"], out["no_remat"], out["param_bf16"]
    log(f"[train_bf16] peak after step 1: REMAT {r['peak_bytes'] / 2 ** 30:.2f}"
        f" GiB, no REMAT {n['peak_bytes'] / 2 ** 30:.2f} GiB; state bytes "
        f"f32 storage {r['param_bytes'] + r['opt_bytes']}, bf16 storage "
        f"{p['param_bytes'] + p['opt_bytes']}")
    assert p["param_bytes"] * 2 == r["param_bytes"], (p, r)
    assert p["opt_bytes"] * 2 == r["opt_bytes"], (p, r)
    out["memory"] = {
        name: _step_memory(variant_config(*base, *BF16_TRAIN, *extra),
                           seed, batches[0], f"train_bf16 {name}")
        for name, extra in (("remat", ()),
                            ("no_remat", ("TRAIN.REMAT=False",)))}
    out["launches"] = r["launches"]
    return out


def _step_memory(cfg, seed: int, batch, tag: str) -> dict:
    """Where one training forward and backward of ``cfg``'s model holds
    its memory (seed weights, ``batch``; bytes above the weights): what
    the backbone and FPN forward alone keep for the backward, what the
    whole forward keeps, the forward's peak and the backward's peak."""
    import torch

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.data.loader import HOST_ONLY_KEYS
    from eksml_tpu_torch.device import resolve_device
    from eksml_tpu_torch.models import MaskRCNN

    dev = resolve_device("cuda")
    model = MaskRCNN.from_config(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(
        seed)))
    model.to(dev).train()
    x = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
         if k not in HOST_ONLY_KEYS}
    b, h, w = x["images"].shape[:3]
    pri = model.make_priorities((b, h, w, x["gt_boxes"].shape[1]),
                                torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    feats = model._features(x["images"])
    torch.cuda.synchronize()
    features_kept = torch.cuda.memory_allocated() - base
    del feats
    # the forward cut at each top-level module's start and end: the
    # peak of each piece (the code before a module, the module itself)
    # and what is allocated when it ends
    segments = {}

    def mark(label):
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        now = torch.cuda.memory_allocated() - base
        if peak >= segments.get(label, (-1, 0))[0]:
            segments[label] = (peak, now)
        torch.cuda.reset_peak_memory_stats()

    hooks = []
    for name, child in model.named_children():
        hooks.append(child.register_forward_pre_hook(
            lambda m, a, name=name: mark(f"before {name}")))
        hooks.append(child.register_forward_hook(
            lambda m, a, o, name=name: mark(f"in {name}")))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = model(x, pri)["total_loss"]
    mark("after the last module (losses)")
    for h in hooks:
        h.remove()
    rec = {"features_kept": features_kept,
           "forward_kept": torch.cuda.memory_allocated() - base,
           "forward_peak": max(p for p, _ in segments.values()),
           "forward_segments": segments}
    top = sorted(segments.items(), key=lambda kv: -kv[1][0])[:3]
    log(f"[{tag}] the forward's largest peaks above the weights: " + "; ".join(
        f"{label} {p / 2 ** 30:.2f} GiB ({n / 2 ** 30:.2f} GiB allocated "
        "at its end)" for label, (p, n) in top))
    torch.cuda.reset_peak_memory_stats()
    loss.backward()
    torch.cuda.synchronize()
    rec["backward_peak"] = torch.cuda.max_memory_allocated() - base
    log(f"[{tag}] memory of one step above the weights: the backbone and "
        f"FPN forward keep {rec['features_kept'] / 2 ** 30:.2f} GiB for "
        f"the backward, the whole forward keeps "
        f"{rec['forward_kept'] / 2 ** 30:.2f} GiB; peak in the forward "
        f"{rec['forward_peak'] / 2 ** 30:.2f} GiB, in the backward "
        f"{rec['backward_peak'] / 2 ** 30:.2f} GiB")
    del model, x, pri, loss
    torch.cuda.empty_cache()
    return rec


def phase_serve_bf16(kernels, seed: int):
    """The serve chart's default (``TRAIN.PRECISION=bfloat16``) through
    the serve phase's path, then the card against the CPU on one SMOKE
    batch (256², bf16)."""
    cfg = variant_config("SERVE.MAX_BATCH_DELAY_MS=250",
                         "TRAIN.PRECISION=bfloat16", training=False)
    engine, rec = phase_serve(cfg, kernels, seed, tag="serve_bf16")
    engine.close()
    del engine
    rec["reference"] = serve_bf16_reference(seed)
    return rec


def serve_bf16_reference(seed: int, img: int = 256):
    """SMOKE widths in bf16 compute, the same weights on the card and on
    the CPU, a batch of 2 ``img``² images: P2..P6 and the box logits to
    ``BF16_LOSS_TOL`` of each tensor's largest magnitude (the phase
    reference's comparison), and ``predict``'s outputs finite and of the
    contract's shapes on both."""
    import torch

    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.device import resolve_device
    from eksml_tpu_torch.models import MaskRCNN

    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        f"PREPROC.MAX_SIZE={img}", f"PREPROC.TEST_SHORT_EDGE_SIZE={img}",
        "TRAIN.PRECISION=bfloat16"])
    cfg.freeze()
    model = MaskRCNN.from_config(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(
        seed)))
    model.to(resolve_device("cuda")).eval()
    phase_reference(model, seed, tol=BF16_LOSS_TOL, tag="serve_bf16")
    return {"tolerance": BF16_LOSS_TOL}


def phase_cascade(kernels, seed: int, workdir: str, records=None):
    """The cascade overlay: Cascade R-CNN on R101-FPN at full width,
    float32, 1344², batch 1, seed weights: ``CASCADE_STEPS`` steps of
    ``Trainer.fit`` (launches 5 / 4 / 16 per step), then one predict
    batch (4 forward launches), timed after a first call that pays the
    new shapes' autotune."""
    import torch

    cfg = variant_config(f"TRAIN.BATCH_SIZE_PER_CHIP={CASCADE_BATCH}",
                         "TRAIN.LOG_PERIOD=1", *CASCADE)
    batches = _synthetic_batches(cfg, seed, CASCADE_BATCH, CASCADE_STEPS)
    stages = CASCADE_STAGES
    want = {kernels.fwd.name: stages + 2, kernels.bwd.name: stages + 1,
            kernels.copy.name: (stages + 1) * len(LEVEL_STRIDES)}
    rec, trainer = _train_run(cfg, kernels, seed,
                              os.path.join(workdir, "cascade"), batches,
                              want, "cascade", keep=True)
    model = trainer.model
    model.eval()
    x = torch.from_numpy(batches[0]["images"]).to(trainer.device)
    hw = torch.from_numpy(batches[0]["image_hw"]).float().to(trainer.device)
    t0 = time.perf_counter()
    model.predict(x, hw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = model.predict(x, hw)
    torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in kernels}
    d = model.test_results_per_im
    log(f"[cascade] predict of batch {CASCADE_BATCH} at "
        f"{tuple(x.shape[1:3])}: first {first_s:.2f} s (autotune), then "
        f"{predict_ms:.1f} ms; launches {launches}; "
        f"{int(out['valid'].sum())} valid of {d}")
    assert launches == {kernels.fwd.name: stages + 1, kernels.bwd.name: 0,
                        kernels.copy.name: 0}, launches
    assert out["boxes"].shape == (CASCADE_BATCH, d, 4)
    assert out["masks"].shape == (CASCADE_BATCH, d, 28, 28)
    for k in ("boxes", "scores", "masks"):
        v = out[k][out["valid"]] if k != "masks" else out[k]
        assert bool(torch.isfinite(v).all()), k
    if records:
        for name, recs in records.items():
            step = [r for r in recs if r["call"] == CASCADE_STEP_CALL]
            if step:
                log(f"[cascade] {name} per step (kernel phase, batch "
                    f"{CASCADE_BATCH}): {step[0]['ms']:.4f} ms, bound "
                    f"{step[0]['bound_ms'] * 1e3:.1f} us")
    trainer.close()
    del trainer, model, out
    torch.cuda.empty_cache()
    rec.update(predict_first_s=first_s, predict_ms=predict_ms,
               predict_launches=launches)
    return rec


def phase_variants_reference(seed: int, img: int = 256):
    """One training step on the card and one on the CPU from the same
    weights, batch and priorities (``phase_train_reference``) for each
    variant: bf16 compute, GroupNorm, the cascade, REMAT."""
    out = {}
    for name, extra, tols in (
            ("bfloat16", ("TRAIN.PRECISION=bfloat16",),
             dict(loss_tol=BF16_LOSS_TOL, share_proposals=True)),
            ("gn", ("BACKBONE.NORM=GN",), dict(loss_tol=1e-4,
                                                tol=GN_GRAD_TOL,
                                                update_tol=GN_GRAD_TOL)),
            ("cascade", ("MODE_CASCADE=True",), {}),
            ("remat", ("TRAIN.REMAT=True",), {})):
        r = phase_train_reference(seed, img, extra=extra,
                                  tag=f"variants_reference {name}", **tols)
        out[name] = {k: v for k, v in r.items() if k != "loss_values"}
    return out


# ---------------------------------------------------------------------
# phase 18: observability in the trainer
# ---------------------------------------------------------------------

#: steps of the observed ``train.main`` run; its loader stalls once, for
#: ``OBSERVE_STALL_S`` under a ``OBSERVE_STALE_S`` /healthz bound, before
#: the first batch it builds after the scraper's two debugz requests (at
#: the latest before the fourth batch from the end)
OBSERVE_STEPS = 20
OBSERVE_STALE_S = 6.0
OBSERVE_STALL_S = 10.0
#: one-step captures the executor takes in one process
OBSERVE_CAPTURES = 20
#: the goodput bank's buckets against the run's wall time (run_start to
#: the entry point's return: the final bank row is written before the
#: last checkpoint's background write is drained and the trainer closed)
BUCKET_SUM_TOL = 0.05
#: "other" at most this share of a capture's device time: the bound
#: tests/test_profiling.py holds the reference's attribution to
OTHER_MAX_PCT = 30.0
#: (wrapper name, the device kernels' name prefix, the component a
#: capture must give them)
KERNEL_COMPONENTS = (("roi_align_fwd", "roi_align_fwd_", "roi-fwd"),
                     ("roi_align_bwd", "roi_align_bwd_", "roi-bwd"),
                     ("copy_to_global", "copy_bulk_kernel", "roi-bwd"))
#: steps per configuration and turn of the telemetry-off/on comparison
OVERHEAD_STEPS = 8
#: the families the first /metrics scrape must hold (preregistered by
#: the fit loop, as the reference's)
CORE_FAMILIES = ("eksml_resilience_preemptions", "eksml_resilience_rollbacks",
                 "eksml_checkpoint_saves", "eksml_data_quarantined_records",
                 "eksml_goodput_ratio", "eksml_goodput_seconds",
                 "eksml_badput_seconds", "eksml_flight_events",
                 "eksml_train_step_duration_ms")


def _http(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _families(body: str) -> dict:
    """OpenMetrics text → {sample name with labels: value}."""
    out = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def check_capture(path: str, tag: str) -> dict:
    """Attribution of one capture's trace: the table by component, each
    kernel's component and share; fails unless all three kernels are
    there under their components and ``other`` stays within
    ``OTHER_MAX_PCT``."""
    from eksml_tpu_torch.profiling import TraceAttribution

    attr = TraceAttribution(path)
    table = attr.component_table(top_n=12)
    kmap = attr.kernel_map()
    total = table["device_total_ms"]
    assert table["basis"] == "device" and total > 0, \
        f"{tag}: the capture saw no device time"
    kernels = {}
    for name, prefix, comp in KERNEL_COMPONENTS:
        hits = {k: v for k, v in kmap.items() if prefix in k}
        assert hits, f"{tag}: no {prefix}* kernel in the capture"
        comps = set().union(*hits.values())
        assert comps == {comp}, f"{tag}: {prefix} under {comps}, not {comp}"
        ms = sum(sum(v.values()) for v in hits.values())
        kernels[name] = {"device_kernels": sorted(hits), "component": comp,
                         "ms": round(ms, 4),
                         "share_pct": round(100 * ms / total, 3)}
    assert table["other_pct"] <= OTHER_MAX_PCT, \
        f"{tag}: other {table['other_pct']}% > {OTHER_MAX_PCT}%"
    log(f"[observe] {tag}: {total:.2f} ms of device time in "
        f"{table['device_events']} events ({table['unlinked_device_events']}"
        f" unjoined); by component (%): "
        + json.dumps(table["component_pct"]))
    log(f"[observe] {tag}: the port's kernels: " + json.dumps(kernels))
    for k in table["top_kernels"][:8]:
        log(f"[observe]   {k['ms']:9.3f} ms {k['pct']:5.1f}% x{k['count']:<4d}"
            f" {k['component']:14s} {k['name'][:80]}")
    return {"component_pct": table["component_pct"],
            "other_pct": table["other_pct"], "device_ms": total,
            "kernels": kernels}


def observe_main(kernels, workdir: str, device: str = "cuda"):
    """``train.main`` at full width, f32, with the chart's telemetry
    (ephemeral port, a short /healthz bound, tracing, goodput) and
    ``--profile 2``, while a thread scrapes /metrics, /healthz and the
    /debugz endpoints; the loader stalls once, after the scraper's
    debugz requests."""
    from eksml_tpu_torch import train
    from eksml_tpu_torch.config import config
    from eksml_tpu_torch.data import loader as loader_mod

    run = os.path.join(workdir, "observe")
    os.makedirs(run, exist_ok=True)
    port_file = os.path.join(run, "telemetry-host0.port")
    seen = {"healthz": [], "ratio": [], "families": None, "debugz": [],
            "stacks": None, "stall": None}
    debugz_done = threading.Event()
    stop = threading.Event()

    def scrape():
        port = None
        last_metrics = 0.0
        while not stop.is_set():
            if port is None and os.path.exists(port_file):
                with open(port_file) as f:
                    port = int(f.read())
            if port is not None:
                try:
                    code, _ = _http(port, "/healthz")
                    seen["healthz"].append((time.monotonic(), code))
                    if time.monotonic() - last_metrics > 0.5:
                        last_metrics = time.monotonic()
                        code, body = _http(port, "/metrics")
                        assert code == 200, f"/metrics answered {code}"
                        fams = _families(body)
                        if seen["families"] is None:
                            seen["families"] = sorted(
                                {l.split("{")[0].split(" ")[2]
                                 for l in body.splitlines()
                                 if l.startswith("# TYPE")})
                            seen["stacks"] = _http(port, "/debugz/stacks")[0]
                        seen["ratio"].append(fams.get("eksml_goodput_ratio"))
                        done = fams.get('eksml_flight_events_total'
                                        '{kind="profile_capture_done"}', 0)
                        n = len(seen["debugz"])
                        if (n == 0 and done >= 1) or (n == 1 and done >= 2):
                            code, body = _http(port,
                                               "/debugz/profile?steps=1")
                            seen["debugz"].append(
                                (code, json.loads(body)["detail"]))
                            if n == 1:
                                debugz_done.set()
                except (OSError, ValueError) as e:
                    seen.setdefault("errors", []).append(repr(e))
            stop.wait(0.2)

    real_batches = loader_mod.DetectionLoader.batches

    def stalling(self, *a, **k):
        for i, b in enumerate(real_batches(self, *a, **k)):
            if seen["stall"] is None and (debugz_done.is_set()
                                          or i == OBSERVE_STEPS - 4):
                t0 = time.monotonic()
                time.sleep(OBSERVE_STALL_S)
                seen["stall"] = (t0, time.monotonic())
            yield b

    saved = config.to_dict()
    th = threading.Thread(target=scrape, name="observe-scraper", daemon=True)
    th.start()
    for k in kernels:
        k.launches = 0
    loader_mod.DetectionLoader.batches = stalling
    try:
        rc = train.main([
            "--device", device, "--synthetic", "--logdir", run,
            "--total-steps", str(OBSERVE_STEPS), "--profile", "2",
            "--config", f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}",
            "TRAIN.LOG_PERIOD=1", f"TRAIN.STEPS_PER_EPOCH={OBSERVE_STEPS}",
            "TELEMETRY.PORT=0",
            f"TELEMETRY.HEALTHZ_STALE_SEC={OBSERVE_STALE_S}",
            "TELEMETRY.TRACING.ENABLED=True",
            "TELEMETRY.GOODPUT.ENABLED=True"])
        t_end = time.time()
    finally:
        loader_mod.DetectionLoader.batches = real_batches
        stop.set()
        th.join(timeout=30)
        config.freeze(False)
        config.from_dict(saved)
        config.freeze()
    launches = {k.name: k.launches for k in kernels}
    assert rc == 0, f"train.main returned {rc}"
    _per_step(kernels, launches, OBSERVE_STEPS)

    # the endpoints
    assert seen["families"], f"no /metrics scrape answered 200: {seen}"
    missing = sorted(set(CORE_FAMILIES) - set(seen["families"]))
    assert not missing, f"/metrics lacks the families {missing}"
    assert seen["stacks"] == 200, f"/debugz/stacks answered {seen['stacks']}"
    ratios = [r for r in seen["ratio"] if r is not None]
    assert len(set(ratios)) >= 2, f"eksml_goodput_ratio did not move: {ratios}"
    codes = [c for c, _ in seen["debugz"]]
    assert codes == [200, 429], f"/debugz/profile answered {seen['debugz']}"
    assert "cooldown" in seen["debugz"][1][1], seen["debugz"]
    assert seen["stall"], "the run ended before the loader stalled"
    t0, t1 = seen["stall"]
    before = [c for t, c in seen["healthz"] if t < t0]
    during = [c for t, c in seen["healthz"] if t0 <= t <= t1]
    outside_503 = sum(c == 503 for t, c in seen["healthz"]
                      if not t0 <= t <= t1)
    assert 200 in before, f"/healthz before the stall: {before}"
    assert 503 in during, f"/healthz during the stall: {during}"
    first_503 = next(t for t, c in seen["healthz"]
                     if c == 503 and t0 <= t <= t1)
    log(f"[observe] /metrics: {len(seen['families'])} families, goodput "
        f"ratio {ratios[0]} .. {ratios[-1]} over {len(ratios)} scrapes; "
        f"/debugz/profile {seen['debugz']}; /healthz {len(before)} answers "
        f"before the stall (200: {before.count(200)}), 503 after "
        f"{first_503 - t0:.1f} s of a {OBSERVE_STALL_S:.0f} s stall under a "
        f"{OBSERVE_STALE_S:.0f} s bound, {outside_503} answers of 503 "
        "outside the stall; scrape errors: "
        + json.dumps(seen.get("errors", [])[:3]))

    # the files
    with open(os.path.join(run, "trace-host0.json")) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"}
    assert {"data_wait", "globalize_batch", "train_step"} <= spans, spans
    with open(os.path.join(run, "events-host0.jsonl")) as f:
        events = [json.loads(line) for line in f]
    seg_start = [e["time"] for e in events if e["kind"] == "run_start"][-1]
    with open(os.path.join(run, "goodput-host0.jsonl")) as f:
        final = [json.loads(line) for line in f][-1]
    assert final.get("final"), final
    wall = t_end - seg_start
    total = sum(final["buckets"].values())
    assert abs(total - wall) <= BUCKET_SUM_TOL * wall, (total, wall, final)
    log(f"[observe] goodput bank: buckets sum to {total:.3f} s against the "
        f"run's {wall:.3f} s (run_start to return), mode {final['mode']}, "
        f"ratio {final['goodput_ratio']}; buckets (s) "
        + json.dumps(final["buckets"]))
    traces = sorted(os.listdir(os.path.join(run, "profile")))
    cli = os.path.join(run, "profile", "trace-step2-host0.json")
    assert os.path.exists(cli), traces
    PROFILER_WINDOWS["n"] += len(traces)
    with open(cli) as f:
        users = sum(1 for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "user_annotation")
    return {"launches": launches, "attribution": check_capture(
                cli, "f32 capture of steps 2-3 (--profile 2)"),
            "scopes_per_step": users / 2, "traces": traces,
            "goodput": final, "wall_s": wall,
            "healthz_503_after_s": first_503 - t0}


def _capture_fit(trainer, batch, step: int):
    """One ``fit`` over two batches whose second step the executor
    captures (the run ends with the batches, so no final checkpoint);
    returns the new step and the capture's record."""
    trainer.fit(iter([batch, batch]), 10 ** 9, start_step=step,
                profile_steps=1)
    PROFILER_WINDOWS["n"] += 1
    cap = trainer.last_capture
    assert cap is not None and cap["end_step"] == step + 2, cap
    assert cap["profiler"] and cap["trace"], \
        f"capture after step {step + 1} did not start or write: {cap}"
    return step + 2, cap


def observe_bf16(seed: int, workdir: str, device: str = "cuda"):
    """The optimized chart's point (bf16 + REMAT, f32 storage) captured
    by the executor, then ``OBSERVE_CAPTURES`` more one-step captures in
    this process: the last must still see the kernels."""
    import torch

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.train import Trainer

    cfg = variant_config(f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}",
                         "TRAIN.LOG_PERIOD=1", *BF16_TRAIN,
                         "TELEMETRY.PORT=0", "TRAIN.STEPS_PER_EPOCH=1000",
                         "TELEMETRY.TRACING.MAX_CAPTURES_PER_RUN=100")
    batch = _synthetic_batches(cfg, seed, BATCH, 1)[0]
    trainer = Trainer(cfg, os.path.join(workdir, "observe_bf16"),
                      device=device)
    trainer.init_state(init_params(cfg, torch.Generator().manual_seed(seed)))
    step, cap = _capture_fit(trainer, batch, 0)
    first = check_capture(cap["trace"], "bf16 + REMAT capture of step 2")
    counts = []
    t0 = time.perf_counter()
    for i in range(OBSERVE_CAPTURES):
        step, cap = _capture_fit(trainer, batch, step)
        comps = cap["table"]["component_pct"]
        counts.append((cap["table"]["device_events"],
                       "roi-fwd" in comps and "roi-bwd" in comps))
        if i + 1 < OBSERVE_CAPTURES:
            os.remove(cap["trace"])      # the disk keeps the last one
    wall = time.perf_counter() - t0
    log(f"[observe] {OBSERVE_CAPTURES} more one-step captures in "
        f"{wall:.1f} s ({PROFILER_WINDOWS['n']} torch.profiler windows in "
        "this process so far): (device events, "
        f"ROIAlign components present) per capture {counts}")
    last = check_capture(cap["trace"], f"capture {OBSERVE_CAPTURES + 1} of "
                         "this trainer's executor")
    trainer.close()
    return {"bf16": first, "captures": counts, "last": last,
            "captures_wall_s": wall}


#: ``profiler_windows``' sequences: (name, CPU activity too, seconds
#: between one window's end and the next one's start, one-element
#: kernels launched right after the window's start, seconds between
#: launches, launches per window, windows)
WINDOW_SEQUENCES = (
    ("cuda_back_to_back", False, 0.0, 0, 0.0, 10, 20),
    ("cuda_100ms_apart", False, 0.1, 0, 0.0, 10, 10),
    ("cuda_launches_1ms_apart", False, 0.1, 0, 0.001, 100, 2),
    ("cuda_after_16_primers", False, 0.1, 16, 0.0, 10, 10),
    ("cuda_after_64_primers", False, 0.1, 64, 0.0, 10, 10),
    ("cuda_launches_1ms_apart_after_64_primers", False, 0.1, 64, 0.001,
     100, 2),
    ("cpu_cuda_1s_apart_after_64_primers", True, 1.0, 64, 0.0, 10, 4))


def profiler_windows(kernels, seed: int):
    """How many of a window's kernels torch.profiler records, window by
    window, in sequences (``WINDOW_SEQUENCES``) that differ in the
    activities (CUDA only, as the kernel phase's ``device_ms``; CPU and
    CUDA, as the trainer's captures), the gap between windows (back to
    back, as ``device_ms``; apart, as the trainer's captures), the
    one-element kernels launched first, and the spacing of the window's
    launches; each launch a mask-target call.  Returns {sequence:
    [kernels recorded per window]}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    masks, rois = mask_target_inputs(np.random.RandomState(seed),
                                     MASK_TARGETS[2] * BATCH)
    feats = (torch.from_numpy(masks).cuda(),)
    r = torch.from_numpy(rois).cuda()
    seen = {}
    primer = torch.zeros(1, device="cuda")
    for (name, with_cpu, gap, primers, spacing, launches,
         n) in WINDOW_SEQUENCES:
        activities = ([ProfilerActivity.CPU] if with_cpu else []) + [
            ProfilerActivity.CUDA]
        seen[name] = []
        for _ in range(n):
            kernels.fwd(feats, r, (1,), MASK_TARGETS[1])
            torch.cuda.synchronize()
            time.sleep(gap)
            with profile(activities=activities) as prof:
                for _ in range(primers):
                    primer.add_(1)
                for _ in range(launches):
                    kernels.fwd(feats, r, (1,), MASK_TARGETS[1])
                    if spacing:
                        time.sleep(spacing)
                torch.cuda.synchronize()
            PROFILER_WINDOWS["n"] += 1
            seen[name].append(sum(
                e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and "roi_align_fwd_" in e.key))
    log("[observe] torch.profiler windows, kernels recorded per window, in "
        "order: " + json.dumps(seen))
    return seen


def mask_target_launch(kernels, seed: int, iters: int = 200):
    """The mask-target ROIAlign call (``MASK_TARGETS``: 512 maps of 56²,
    C = 1, out 28) timed apart from its kernel: the host's time for the
    call to return (the wrapper alone, and the model's call through
    ``dispatch_roi_align``: scope, autograd Function, wrapper), the
    CUDA-event time per back-to-back call, and the kernel's device-only
    time."""
    import torch

    from eksml_tpu_torch.ops.roi_align import dispatch_roi_align

    masks, rois = mask_target_inputs(np.random.RandomState(seed),
                                     MASK_TARGETS[2] * BATCH)
    feats = (torch.from_numpy(masks).cuda(),)
    r = torch.from_numpy(rois).cuda()
    out = MASK_TARGETS[1]
    calls = {"wrapper": lambda: kernels.fwd(feats, r, (1,), out),
             "dispatch_roi_align": lambda: dispatch_roi_align(
                 feats, r, (1,), out)}
    res = {}
    with torch.no_grad():
        for name, fn in calls.items():
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            host = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            host.sort()
            res[name] = {"host_median_ms": host[len(host) // 2],
                         "host_p10_ms": host[len(host) // 10],
                         "host_p90_ms": host[len(host) * 9 // 10],
                         "event_ms": time_ms(fn, iters=50, warmup=5)}
        res["device_ms"] = device_ms(calls["wrapper"], "roi_align_fwd_",
                                     iters=50)
    log(f"[observe] mask-target call ({len(rois)} maps of "
        f"{masks.shape[1]}x{masks.shape[2]}, C=1, out {out}): "
        + json.dumps(res))
    assert res["device_ms"], "the profiler saw no mask-target kernel"
    return res


def _scope_cost(n: int = 100000) -> float:
    """Microseconds per enter and exit of one named_scope range with no
    profiler active (the host cost the scopes add to every step)."""
    from eksml_tpu_torch.profiling import named_scope

    t0 = time.perf_counter()
    for _ in range(n):
        with named_scope("backbone"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def observe_overhead(seed: int, workdir: str, batches,
                     device: str = "cuda"):
    """The f32 step median with the telemetry layer off, fully on
    (exporter, spans, goodput, the anomaly detector, the cross-rank
    aggregation) and on without the aggregation, in one process on this
    thread, in turns (off, on_no_aggregate, on, on, on_no_aggregate,
    off), ``OVERHEAD_STEPS`` steps each over the train phase's batches
    with every step a log step (``TRAIN.LOG_PERIOD=1``: the log step's
    work in every step, the worst case of the default 20); the first
    step of each turn is left out."""
    import torch

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.train import Trainer

    base = (f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}", "TRAIN.LOG_PERIOD=1",
            "TRAIN.STEPS_PER_EPOCH=1000")
    on = ("TELEMETRY.PORT=0", "TELEMETRY.TRACING.ENABLED=True",
          "TELEMETRY.TRACING.ANOMALY_TRIGGER=True",
          "TELEMETRY.GOODPUT.ENABLED=True")
    cfgs = {"off": variant_config(*base, "TELEMETRY.ENABLED=False"),
            "on_no_aggregate": variant_config(
                *base, *on, "TELEMETRY.AGGREGATE_HOSTS=False"),
            "on": variant_config(*base, *on)}
    trainers, steps, times = {}, {}, {name: [] for name in cfgs}
    for name, cfg in cfgs.items():
        trainers[name] = Trainer(cfg, os.path.join(workdir,
                                                   f"overhead_{name}"),
                                 device=device)
        trainers[name].init_state(init_params(
            cfg, torch.Generator().manual_seed(seed)))
        steps[name] = 0
    for name in list(cfgs) + list(cfgs)[::-1]:
        src = [batches[i % len(batches)] for i in range(OVERHEAD_STEPS)]
        # the run ends with the batches: no final checkpoint
        rows = trainers[name].fit(iter(src), 10 ** 9, start_step=steps[name])
        steps[name] += OVERHEAD_STEPS
        times[name] += [r["step_time_ms"] for r in rows[1:]]
    for t in trainers.values():
        t.close()
    out = {"scope_us": _scope_cost()}
    for name, v in times.items():
        v = sorted(v)
        out[name] = {"median_ms": v[len(v) // 2],
                     "q1_ms": v[(len(v) - 1) // 4],
                     "q3_ms": v[(3 * (len(v) - 1)) // 4], "ms": times[name]}
    off = out["off"]["median_ms"]
    log(f"[observe] step median (every step a log step, "
        f"{2 * (OVERHEAD_STEPS - 1)} steps each in turns): " + ", ".join(
            f"{name} {r['median_ms']:.1f} ms (quartiles {r['q1_ms']:.1f}-"
            f"{r['q3_ms']:.1f}, {(r['median_ms'] / off - 1) * 100:+.2f} %)"
            for name, r in out.items() if name != "scope_us")
        + f"; one named_scope range with no profiler active "
        f"{out['scope_us']:.2f} us")
    return out


def phase_observe(kernels, seed: int, workdir: str, batches,
                  device: str = "cuda"):
    """The telemetry layer in the trainer at full width (the main path:
    ``train.main`` with the chart's telemetry), the f32 and bf16 steps
    by component, 20 captures in one process, the mask-target call's
    launch path and the layer's cost on the step.  ``device``: "cpu"
    rehearses the control flow (with ``check_capture`` and
    ``mask_target_launch`` replaced)."""
    out = observe_main(kernels, workdir, device)
    out.update(observe_bf16(seed, workdir, device))
    out["mask_target_call"] = mask_target_launch(kernels, seed)
    out["profiler_windows"] = profiler_windows(kernels, seed)
    out["overhead"] = observe_overhead(seed, workdir, batches, device)
    out["overhead"]["scopes_per_step"] = out["scopes_per_step"]
    out["overhead"]["scope_ms_per_step"] = (
        out["scopes_per_step"] * out["overhead"]["scope_us"] / 1e3)
    return out


#: the roofline phase's points: (label, bench rung, bench flags, the
#: observe phase's capture at the same point); the first two are the
#: train and train_bf16 phases' shapes (warm), the last is the ladder's
#: headline rung
ROOFLINE_POINTS = (
    ("f32", "1344_b4", ("--precision", "float32"), "attribution"),
    ("bf16_remat", "1344_b4", ("--precision", "bfloat16", "--remat", "1"),
     "bf16"),
    ("1344_b8_remat", "1344_b8_remat", ("--precision", "bfloat16"), None),
)
ROOFLINE_STEPS = 10
ROOFLINE_EVAL_IMAGES = 8
AP_TOL = 1e-6


def _shares_line(rec, observed_pct) -> str:
    """Each component's predicted ms and share of the predicted step,
    beside the observe phase's share of captured device time."""
    total = rec["predicted_step_time_ms"]
    rows = []
    for comp, ms in rec["predicted_components_ms"].items():
        seen = (observed_pct or {}).get(comp)
        rows.append(f"{comp} {ms:.3f} ms {100 * ms / total:.1f}%"
                    + (f" (observed {seen}%)" if observed_pct is not None
                       else ""))
    return ", ".join(rows)


def roofline_points(kernels, seed: int, observed=None, device="cuda"):
    """Each ``ROOFLINE_POINTS`` point through ``tools/bench.py``'s rung in
    this process (on this thread: the train phases' cuDNN autotune is
    reused): measured and predicted step, MFU, FLOPs, the components'
    predicted ms beside the observe phase's shares, the liveness peak
    against ``max_memory_allocated`` and its largest tensors, and the
    kernels' launches (3 / 2 / 8 per step, the counted step included)."""
    import torch

    from eksml_tpu_torch.tools import bench

    out = {}
    for label, rung, flags, capture in ROOFLINE_POINTS:
        for k in kernels:
            k.launches = 0
        args = bench.parse_args(
            ["--rungs", rung, "--steps", str(ROOFLINE_STEPS), "--seed",
             str(seed), "--device", device, *flags, "--config",
             *VARIANT_BASE])
        rec = bench.run_rung(bench.select_rungs(rung)[0], args)
        if device == "cuda":
            torch.cuda.synchronize()
        steps = 1 + (rec["warmup"] - 1) + rec["steps"]
        launches = {k.name: k.launches for k in kernels}
        want = {kernels.fwd.name: 3 * steps, kernels.bwd.name: 2 * steps,
                kernels.copy.name: 2 * len(LEVEL_STRIDES) * steps}
        assert launches == want, (label, launches, want)
        rec["launches"] = launches
        gap = (None if rec["measured_peak_bytes"] is None else
               rec["measured_peak_bytes"] - rec["predicted_peak_hbm_bytes"])
        before = rec["measured_allocated_before_step_bytes"]
        log(f"[roofline] {label} ({rung}, {rec['precision']}, REMAT "
            f"{rec['remat']}, batch {rec['batch_size']} at "
            f"{rec['image_size']}): measured median step "
            f"{rec['step_time_ms']:.2f} ms (min {rec['step_time_min_ms']:.2f},"
            f" max {rec['step_time_max_ms']:.2f}; step 1 "
            f"{rec['first_step_s']:.2f} s), predicted "
            f"{rec['predicted_step_time_ms']:.2f} ms ("
            + ", ".join(f"{k} {v:.2f}" for k, v in
                        rec["predicted_sections_ms"].items())
            + f"); {rec['tflops_per_step']:.4f} TFLOP per step without "
            f"REMAT's recompute ({rec['recompute_tflops']:.4f} recomputed), "
            f"MFU {rec['mfu'] * 100:.2f}% of {rec['mfu_peak']['name']} "
            f"{rec['mfu_peak']['flops_per_s']:.3g} FLOP/s; "
            f"{rec['value']:.2f} images/s; launches {launches}")
        observed_pct = (observed[capture]["component_pct"]
                        if observed and capture else None)
        log(f"[roofline] {label} by component: "
            + _shares_line(rec, observed_pct))
        log(f"[roofline] {label} memory: predicted liveness peak "
            f"{rec['predicted_peak_hbm_bytes'] / 2 ** 30:.3f} GiB at "
            f"{rec['predicted_peak_op']} ({rec['predicted_peak_component']};"
            f" resident {rec['predicted_resident_bytes'] / 2 ** 30:.3f} "
            "GiB), max_memory_allocated "
            + (f"{rec['measured_peak_bytes'] / 2 ** 30:.3f} GiB (allocated "
               f"before the step {before / 2 ** 30:.3f} GiB; measured - "
               f"predicted {gap / 2 ** 30:+.3f} GiB)"
               if gap is not None else "not measured")
            + "; live at the peak by component (GiB): " + json.dumps(
                {k: round(v / 2 ** 30, 3) for k, v in
                 rec["predicted_live_at_peak_bytes"].items()})
            + "; largest live tensors: " + json.dumps(
                rec["predicted_top_tensors"]))
        log("[roofline] ladder line: " + json.dumps(rec))
        out[label] = rec
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def roofline_eval_ckpt(life, seed: int, workdir: str, device="cuda"):
    """``python -m eksml_tpu_torch.tools.eval_ckpt`` in this process on the
    lifecycle run's newest checkpoint over ``ROOFLINE_EVAL_IMAGES`` shapes
    JPEGs, and the eval phase's evaluator (``run_evaluation``) on the same
    weights and images: the AP dicts to ``AP_TOL``."""
    import contextlib
    import io

    import torch

    from eksml_tpu_torch.data.coco import CocoDataset
    from eksml_tpu_torch.evalcoco import run_evaluation
    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.tools import eval_ckpt
    from eksml_tpu_torch.train import cast_for_storage
    from eksml_tpu_torch.utils.checkpoint import CheckpointManager

    base = os.path.join(workdir, "roofline_coco")
    write_shapes_split(base, "val2017", ROOFLINE_EVAL_IMAGES, seed + 11)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = eval_ckpt.main(["--logdir", life["run"], "--data", base,
                             "--device", device, "--config",
                             *VARIANT_BASE])
    wall = time.perf_counter() - t0
    assert rc == 0, f"eval_ckpt exited {rc}"
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    cfg = variant_config()
    model = MaskRCNN.from_config(cfg).to(device)
    cast_for_storage(model, cfg.TRAIN.PARAM_DTYPE)
    model.load_state_dict(CheckpointManager(life["run"]).restore(
        got["step"])["model"])
    model.eval()
    records = CocoDataset(base, "val2017").records(skip_empty=False)
    with torch.no_grad():
        want = run_evaluation(model, cfg, records, device=device)
    del model
    diff = {k: abs(got[k] - v) for k, v in want.items()}
    log(f"[roofline] eval_ckpt on the lifecycle run's step {got['step']} "
        f"({got['num_images']} images, {wall:.1f} s in process): "
        + json.dumps({k: got[k] for k in sorted(want)})
        + f"; the eval phase's run_evaluation on the same weights: largest "
        f"AP difference {max(diff.values()):.3g} (tolerance {AP_TOL})")
    assert set(want) <= set(got) and max(diff.values()) <= AP_TOL, diff
    return {"step": got["step"], "ap": {k: got[k] for k in sorted(want)},
            "max_ap_diff": max(diff.values()), "wall_s": wall}


def phase_roofline(kernels, seed: int, workdir: str, observed=None,
                   life=None, device: str = "cuda"):
    """The step's roofline on the card (``profiling/predict.py``) through
    the ladder (``tools/bench.py``) at the f32 and bf16 + REMAT training
    points and the ladder's ``1344_b8_remat`` rung, then ``eval_ckpt`` on
    the lifecycle run's checkpoint (when the lifecycle phase ran)."""
    out = {"points": roofline_points(kernels, seed, observed, device)}
    if life is not None:
        out["eval_ckpt"] = roofline_eval_ckpt(life, seed, workdir, device)
    else:
        log("[roofline] eval_ckpt did not run: it reads the lifecycle "
            "phase's checkpoints (add lifecycle)")
    return out


RANKS_EVAL_SEED = 11


def eval_rank(run: str) -> int:
    """``--eval-rank RUN``: one rank of a JobSet-formed group restores the
    newest checkpoint under ``RUN`` into a Trainer under ``fsdp`` and
    runs ``Trainer._run_eval`` over ``EVAL_IMAGES`` shapes images; rank
    0 writes its AP dict to ``RUN/eval_ranks.json``."""
    from eksml_tpu_torch.config import config, finalize_configs
    from eksml_tpu_torch.evalcoco import make_eval_fn
    from eksml_tpu_torch.parallel.distributed import (initialize_from_env,
                                                      process_index,
                                                      shutdown)
    from eksml_tpu_torch.train import Trainer

    logging.basicConfig(level=logging.INFO)
    config.freeze(False)
    config.update_args(["TRAIN.SHARDING.STRATEGY=fsdp", "TRAIN.NUM_CHIPS=2",
                        f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}"])
    cfg = finalize_configs(is_training=True)
    initialize_from_env(cfg, device="cuda")
    try:
        records = shapes_records(
            os.path.join(run, f"shapes{process_index()}"), "val2017",
            EVAL_IMAGES, RANKS_EVAL_SEED)
        results = {}
        inner = make_eval_fn(cfg, device="cuda", records=records)

        def eval_fn(model, step):
            results.update(inner(model, step))
            return results

        trainer = Trainer(cfg, run, device="cuda", eval_fn=eval_fn)
        step = trainer.restore_or_init()
        t0 = time.perf_counter()
        trainer._run_eval(step)
        log(f"[eval-rank {process_index()}] eval of step {step} in "
            f"{time.perf_counter() - t0:.1f} s: {len(results)} results")
        if process_index() == 0:
            assert results, "the eval raised on rank 0"
            with open(os.path.join(run, "eval_ranks.json"), "w") as f:
                json.dump({"step": step, "results": results}, f)
        trainer.close()
    finally:
        shutdown()
    return 0


# ---------------------------------------------------------------------
# phase autotune: cuDNN's algorithm choice, paid at every process start
# ---------------------------------------------------------------------

#: the training points through the ladder's rung code
#: (``tools/bench.run_rung``): (label, mode, precision, rung, flags).
#: The charts' points take the step-shaping ``--config`` items of the
#: chart's one-card render (``AUTOTUNE_CHART_KEYS``): the f32 chart at
#: batch 1 on the square 1344² canvas it pads to, the optimized overlay
#: (bf16, REMAT, batch 4) at the landscape bucket its images take
AUTOTUNE_LADDER = (
    ("train_f32_b4", "train", "float32", "1344_b4",
     ("--precision", "float32")),
    ("train_bf16_remat_b4", "train", "bfloat16", "1344_b4",
     ("--precision", "bfloat16", "--remat", "1")),
    ("chart_f32_b1", "train", "float32",
     {"name": "chart_1344_b1", "image_size": 1344, "pad_hw": None,
      "batch_size": 1}, ("--precision", "float32")),
    ("chart_optimized_b4", "train", "bfloat16",
     {"name": "chart_832x1344_b4", "image_size": 1344,
      "pad_hw": (832, 1344), "batch_size": 4},
     ("--precision", "bfloat16")),
)
#: the chart render's ``--config`` keys that shape the training step
AUTOTUNE_CHART_KEYS = ("MODE_MASK", "MODE_FPN", "TRAIN.BATCH_SIZE_PER_CHIP",
                       "TRAIN.PRECISION", "TRAIN.REMAT",
                       "TRAIN.GRADIENT_CLIP", "BACKBONE.NORM")
#: the serving points: the serve phase's config at each precision
AUTOTUNE_SERVE = (("serve_f32", "float32"), ("serve_bf16", "bfloat16"))
#: timed steps of a ladder point, timed batch-4 forwards of a serving one
AUTOTUNE_STEPS = 10
SERVE_BATCH4_CALLS = 10
AUTOTUNE_BUDGET = 600.0
AUTOTUNE_LINE = "AUTOTUNE_RESULT "
AUTOTUNE_READY = "AUTOTUNE_READY"
#: settings measured beside ``compile_cache.SETTINGS`` that no row of its
#: policy takes: the first two algorithms of cuDNN's list only, and
#: cuDNN's heuristics (no timing, the first algorithm that runs)
AUTOTUNE_EXTRA_SETTINGS = {
    "autotune_limit_2": {"benchmark": True, "benchmark_limit": 2},
    "heuristics": {"benchmark": False, "benchmark_limit": 10}}
#: (precision, setting) left out at every point of that precision: each
#: measured run failed it at each such point (f32 under cuDNN's
#: heuristics: 25-31 % slower steps in seven runs, PERF.md section 6)
AUTOTUNE_SETTLED = (("float32", "heuristics"),)
#: the points whose verdict every measured run gave alike (PERF.md
#: section 6): there the rule must choose the policy's setting, where
#: the point's full autotune ran in a fresh process (a reading late in
#: this process runs a few percent slow, which is the margin the other
#: settings are judged by)
AUTOTUNE_HELD = ("train_f32_b4",)
#: the rule (PERF.md section 5): another setting's median step (serving:
#: batch-4 latency) passes when it is at most the full autotune's plus
#: the larger of this share of it and the full autotune's own spread
AUTOTUNE_NOISE_SHARE = 0.01


def _spread(times) -> float:
    """The interquartile range of timed steps (ms)."""
    q1, q3 = np.percentile(np.asarray(times, np.float64), [25, 75])
    return float(q3 - q1)


def serve_batch4_ms(engine, seed: int, calls: int = SERVE_BATCH4_CALLS):
    """``calls`` batch-4 forwards of the engine (four seeded images of the
    serve phase's sizes, preprocessed into their bucket), each timed to
    its numpy outputs, in ms."""
    rng = np.random.RandomState(seed + 7)
    pre = [engine.preprocess(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
           for h, w in ((480, 640), (640, 480), (800, 1333), (600, 600))]
    buckets = {p[3] for p in pre}
    assert len(buckets) == 1, f"the four images take buckets {buckets}"
    images = np.stack([p[0] for p in pre])
    hw = np.asarray([p[2] for p in pre], np.float32)
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        engine.infer(images, hw, pre[0][3])
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def autotune_chart_items(values_files=()) -> list:
    """The step-shaping ``--config`` items of the training chart's
    one-card render (with ``values_files``)."""
    c, _, _ = chart_container("charts/maskrcnn-gpu", values_files,
                              CHARTS_ONE_CARD)
    items = list(c["command"][c["command"].index("--config") + 1:])
    return [a for a in items if a.split("=", 1)[0] in AUTOTUNE_CHART_KEYS]


def autotune_specs(seed: int):
    """One spec per point: what a fresh process runs."""
    specs = []
    for label, mode, precision, rung, flags in AUTOTUNE_LADDER:
        argv = ["--steps", str(AUTOTUNE_STEPS), "--seed", str(seed),
                *flags, "--config", *VARIANT_BASE]
        if label.startswith("chart_"):
            files = (("values-optimized.yaml",) if "optimized" in label
                     else ())
            argv += autotune_chart_items(files)
        else:
            rung = next(r for r in _bench_rungs() if r["name"] == rung)
        specs.append({"label": label, "mode": mode, "precision": precision,
                      "kind": "ladder", "rung": rung, "argv": argv,
                      "seed": seed})
    for label, precision in AUTOTUNE_SERVE:
        specs.append({"label": label, "mode": "serve",
                      "precision": precision, "kind": "serve",
                      "config": ["SERVE.MAX_BATCH_DELAY_MS=250",
                                 f"TRAIN.PRECISION={precision}"],
                      "seed": seed})
    return specs


def _bench_rungs():
    from eksml_tpu_torch.tools import bench

    return bench.RUNGS


def autotune_settings(spec) -> tuple:
    """The settings the autotune phase measures at the point ``spec``."""
    from eksml_tpu_torch.utils.compile_cache import SETTINGS

    return tuple(s for s in (*SETTINGS, *AUTOTUNE_EXTRA_SETTINGS)
                 if (spec["precision"], s) not in AUTOTUNE_SETTLED)


def autotune_child(spec_json: str) -> int:
    """One point under one setting in this fresh process (``python3
    chip_smoke.py --autotune-child SPEC``): every row of the policy table
    takes the setting under test, and the point runs through the port's
    own code.  Its set-up (cuDNN's and cuBLAS's libraries, the model and
    the batch on the card) comes first; then the process prints
    ``AUTOTUNE_READY`` and waits for the parent's release (one point on
    the card at a time) before its step 1 (serving: the warmup).  One
    ``AUTOTUNE_RESULT`` JSON line reports step 1, the timed steps, the
    peaks and the ROIAlign launches."""
    import torch

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.ops.roi_align import KERNELS
    from eksml_tpu_torch.serve import InferenceEngine
    from eksml_tpu_torch.tools import bench
    from eksml_tpu_torch.utils import compile_cache

    spec = json.loads(spec_json)
    compile_cache.SETTINGS.update(AUTOTUNE_EXTRA_SETTINGS)
    compile_cache.POLICY = {k: spec["setting"]
                            for k in compile_cache.POLICY}
    held = {}
    # the children set up together on the machine's cores: one host
    # thread each until the release
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def hold():
        """Set up: load the libraries, then wait for the release."""
        torch.set_num_threads(threads)
        held["libraries_s"] = prime_libraries()
        held["free_bytes"] = int(torch.cuda.mem_get_info()[0])
        held["ready_s"] = time.time() - spec["launched_at"]
        print(AUTOTUNE_READY, flush=True)
        sys.stdin.readline()
        held["go"] = time.time()
        for k in KERNELS:
            k.launches = 0

    if spec["kind"] == "ladder":
        rec = bench.run_rung(spec["rung"], bench.parse_args(spec["argv"]),
                             count=False, ready=hold)
        steps = 1 + (rec["warmup"] - 1) + rec["steps"]
        out = {"start_s": rec["first_step_s"],
               "times_ms": rec["step_times_ms"],
               "peak_bytes": rec["measured_peak_bytes"],
               "process_peak_bytes": int(torch.cuda.max_memory_allocated()),
               "cudnn": rec["cudnn"], "steps": steps,
               "batch": rec["batch_size"], "canvas": rec["image_size"],
               "precision": rec["precision"], "remat": rec["remat"]}
    else:
        cfg = variant_config(*spec["config"], training=False)
        params = init_params(cfg, torch.Generator().manual_seed(
            spec["seed"]))
        engine = InferenceEngine(cfg, params=params)
        hold()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warmed = engine.warmup()
        torch.cuda.synchronize()
        start = time.perf_counter() - t0
        warm_peak = int(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        times = serve_batch4_ms(engine, spec["seed"])
        out = {"start_s": start, "times_ms": times,
               "peak_bytes": int(torch.cuda.max_memory_allocated()),
               "process_peak_bytes": warm_peak,
               "cudnn": engine.cudnn["setting"], "warm_shapes": warmed,
               "batches": len(times)}
        engine.close()
    out["launches"] = {k.name: k.launches for k in KERNELS}
    out.update({k: held[k] for k in ("libraries_s", "free_bytes",
                                     "ready_s")})
    out["released_s"] = time.time() - held["go"]
    print(AUTOTUNE_LINE + json.dumps(out), flush=True)
    return 0


def prime_libraries() -> float:
    """A small convolution forward and backward and a matrix product in
    float32 and bfloat16 on the card, in a point's set-up: cuDNN's and
    cuBLAS's libraries load here, once per process, as they had in the
    process whose earlier phases the reused point comes from.  Returns
    its seconds."""
    import torch

    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 8, 16, 16, device="cuda", dtype=dtype,
                        requires_grad=True)
        w = torch.randn(8, 8, 3, 3, device="cuda", dtype=dtype,
                        requires_grad=True)
        y = torch.nn.functional.conv2d(x, w, padding=1).flatten(1)
        (y @ y.T).sum().backward()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class AutotuneChildren:
    """The autotune phase's fresh processes (``python3 chip_smoke.py
    --autotune-child SPEC``), all started at once: each imports the port
    and sets its point up, all together (:meth:`wait_ready`); then
    :meth:`result` releases them one at a time, so no two points run on
    the card together, and the next is released once the previous
    printed its result (its exit overlaps the next one's step 1)."""

    def __init__(self, jobs, workdir: str):
        here = os.path.dirname(os.path.abspath(__file__))
        self.t0 = time.perf_counter()
        self.procs = {}
        for spec, setting in jobs:
            log_path = os.path.join(workdir, f"autotune-{spec['label']}-"
                                             f"{setting}.log")
            arg = json.dumps(dict(spec, setting=setting,
                                  launched_at=time.time()))
            with open(log_path, "w") as f:
                proc = subprocess.Popen(
                    [sys.executable, os.path.join(here, "chip_smoke.py"),
                     "--autotune-child", arg], stdin=subprocess.PIPE,
                    stdout=f, stderr=subprocess.STDOUT, cwd=here,
                    env=dict(os.environ, PYTHONPATH=here), text=True,
                    start_new_session=True)
            self.procs[(spec["label"], setting)] = (proc, log_path)

    def wait_ready(self) -> float:
        """Wait until every child has set up and waits for its release;
        returns the seconds since the first start."""
        deadline = time.monotonic() + AUTOTUNE_BUDGET
        waiting = dict(self.procs)
        while waiting:
            for key, (proc, log_path) in list(waiting.items()):
                with open(log_path) as f:
                    text = f.read()
                if AUTOTUNE_READY in text.splitlines():
                    del waiting[key]
                elif proc.poll() is not None:
                    log(f"[autotune] {key[0]} {key[1]}: exited "
                        f"{proc.returncode} in its set-up:\n{text[-4000:]}")
                    raise AssertionError(f"autotune child {key} failed")
            assert time.monotonic() < deadline, (
                f"autotune children {sorted(waiting)} not set up in "
                f"{AUTOTUNE_BUDGET} s")
            if waiting:
                time.sleep(0.2)
        return time.perf_counter() - self.t0

    def result(self, spec, setting: str) -> dict:
        """Release one child and return its result once it printed it:
        the released process's seconds to its result (``released_s``),
        its set-up before the release (``ready_s``, off the phase's
        critical path)."""
        proc, log_path = self.procs[(spec["label"], setting)]
        proc.stdin.write("go\n")
        proc.stdin.close()
        deadline = time.monotonic() + AUTOTUNE_BUDGET
        lines = []
        while not lines and proc.poll() is None:
            assert time.monotonic() < deadline, (
                f"autotune child {spec['label']} {setting}: no result in "
                f"{AUTOTUNE_BUDGET} s")
            time.sleep(0.05)
            with open(log_path) as f:
                lines = [line for line in f.read().splitlines()
                         if line.startswith(AUTOTUNE_LINE)]
        with open(log_path) as f:
            text = f.read()
        lines = [line for line in text.splitlines()
                 if line.startswith(AUTOTUNE_LINE)]
        if len(lines) != 1 or proc.returncode not in (None, 0):
            log(f"[autotune] {spec['label']} {setting}: exited "
                f"{proc.returncode}:\n{text[-4000:]}")
            raise AssertionError(f"autotune child {spec['label']} "
                                 f"{setting} failed")
        rec = json.loads(lines[0][len(AUTOTUNE_LINE):])
        assert rec["cudnn"] == setting, (rec["cudnn"], setting)
        return rec

    def close(self) -> None:
        """Wait for every child's exit (code 0); kill what is left."""
        bad = []
        for key, (proc, _) in self.procs.items():
            try:
                if proc.stdin and not proc.stdin.closed:
                    proc.stdin.close()      # never released: exits on EOF
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)
                rc = proc.wait()
            if rc != 0:
                bad.append((key, rc))
        assert not bad, f"autotune children exited {bad}"


def _check_autotune_launches(kernels, spec, rec) -> None:
    if spec["kind"] == "ladder":
        n = rec["steps"]
        want = {kernels.fwd.name: 3 * n, kernels.bwd.name: 2 * n,
                kernels.copy.name: 2 * len(LEVEL_STRIDES) * n}
    else:
        want = {kernels.fwd.name: 2 * (rec["warm_shapes"] + rec["batches"]),
                kernels.bwd.name: 0, kernels.copy.name: 0}
    assert rec["launches"] == want, (spec["label"], rec["launches"], want)


def autotune_verdict(recs: dict):
    """The rule at one point: ``{setting: record}`` -> (the settings that
    pass, the one chosen, the noise bound in ms).  A setting passes when
    its median step is at most the full autotune's plus the larger of
    ``AUTOTUNE_NOISE_SHARE`` of it and the full autotune's own spread;
    among those that pass, the least start (step 1 or warmup) wins."""
    full = recs["autotune"]
    bound = max(AUTOTUNE_NOISE_SHARE * full["median_ms"], full["spread_ms"])
    passing = sorted(s for s, r in recs.items()
                     if r["median_ms"] <= full["median_ms"] + bound)
    return passing, min(passing, key=lambda s: recs[s]["start_s"]), bound


def autotune_policy(points: dict) -> dict:
    """The policy the rule gives each (mode, precision): a setting that
    passes at every point of the key, the least summed start among
    them."""
    keys = {}
    for p in points.values():
        keys.setdefault((p["mode"], p["precision"]), []).append(p)
    out = {}
    for key, ps in sorted(keys.items()):
        ok = [s for s in ps[0]["settings"]
              if all(s in p["passing"] for p in ps)]
        out[key] = min(ok, key=lambda s: sum(p["settings"][s]["start_s"]
                                             for p in ps))
    return out


def check_autotune_policy(points: dict) -> None:
    """``compile_cache.POLICY`` held to this run's verdicts: its setting
    passes the rule at every point of its row (it never trades steady
    time beyond the noise), and at ``AUTOTUNE_HELD`` the rule chooses it
    where the full autotune there was measured in a fresh process."""
    from eksml_tpu_torch.utils.compile_cache import POLICY

    for label, p in points.items():
        applied = POLICY[(p["mode"], p["precision"])]
        assert applied in p["passing"], (label, applied, p["passing"])
        if label not in AUTOTUNE_HELD:
            continue
        if p["settings"]["autotune"]["fresh"]:
            assert p["chosen"] == applied, (label, p["chosen"], applied)
        else:
            log(f"[autotune] {label}: the verdict is not held, its full "
                "autotune was read in this process")


def _autotune_points(kernels, specs, reuse, children) -> dict:
    """Each point's settings (reused or released from ``children``), the
    rule's verdict, printed."""
    from eksml_tpu_torch.utils.compile_cache import POLICY

    points = {}
    for spec in specs:
        label = spec["label"]
        applied = POLICY[(spec["mode"], spec["precision"])]
        recs = {}
        for setting in autotune_settings(spec):
            if setting == applied and label in reuse:
                rec = dict(reuse[label], cudnn=setting, fresh=False)
            else:
                rec = children.result(spec, setting)
                _check_autotune_launches(kernels, spec, rec)
                rec.update(source="a fresh process", fresh=True)
            rec["median_ms"] = float(np.median(rec["times_ms"]))
            rec["spread_ms"] = _spread(rec["times_ms"])
            recs[setting] = rec
            log(f"[autotune] {label} {setting} ({rec['source']}): "
                f"{'warmup' if spec['kind'] == 'serve' else 'step 1'} "
                f"{rec['start_s']:.2f} s; "
                f"{'batch-4 forward' if spec['kind'] == 'serve' else 'step'}"
                f" median {rec['median_ms']:.2f} ms (IQR "
                f"{rec['spread_ms']:.2f}, min {min(rec['times_ms']):.2f}, "
                f"max {max(rec['times_ms']):.2f}, {len(rec['times_ms'])} "
                f"timed); peak {_gib(rec['peak_bytes'])} GiB"
                + (f" (process {_gib(rec['process_peak_bytes'])} GiB)"
                   if rec.get("process_peak_bytes") else "")
                + (f"; released to result {rec['released_s']:.1f} s "
                   f"(set up before the release in {rec['ready_s']:.1f} s,"
                   f" the libraries' load {rec['libraries_s']:.2f} s of it;"
                   f" free on the card at the release "
                   f"{_gib(rec['free_bytes'])} GiB)"
                   if "released_s" in rec else "")
                + f"; launches {rec.get('launches')}")
        passing, chosen, bound = autotune_verdict(recs)
        log(f"[autotune] {label}: the noise bound {bound:.2f} ms over the "
            f"full autotune's {recs['autotune']['median_ms']:.2f} ms; pass "
            f"{passing}; the rule takes {chosen}")
        points[label] = {"mode": spec["mode"],
                         "precision": spec["precision"],
                         "passing": passing, "chosen": chosen,
                         "bound_ms": bound, "_recs": recs,
                         "settings": {s: {k: r.get(k) for k in (
                             "start_s", "median_ms", "spread_ms",
                             "peak_bytes", "process_peak_bytes",
                             "released_s", "ready_s", "libraries_s",
                             "free_bytes", "source", "fresh")}
                             for s, r in recs.items()}}
    return points


def phase_autotune(kernels, seed: int, workdir: str, reuse=None):
    """cuDNN's algorithm choice at each point (``AUTOTUNE_LADDER``,
    ``AUTOTUNE_SERVE``) under each setting (``autotune_settings``), each
    in a fresh process (``AutotuneChildren``: set up together, each
    loading cuDNN's and cuBLAS's libraries (``prime_libraries``) and
    putting its model and batch on the card, then released one at a
    time), except where an earlier phase of this process already
    measured the setting this process's policy applies on a fresh thread
    (``reuse``: the train phase's step 1 with the roofline phase's f32
    steps).  Prints step 1 (serving: the warmup), the median step with
    its spread, the peaks and the launches of each, the rule's verdict
    per point and the policy it gives, and holds
    ``compile_cache.POLICY`` to the verdicts
    (``check_autotune_policy``)."""
    import torch

    from eksml_tpu_torch.utils.compile_cache import POLICY

    reuse = reuse or {}
    specs = autotune_specs(seed)
    jobs = [(spec, setting) for spec in specs
            for setting in autotune_settings(spec)
            if not (spec["label"] in reuse and setting == POLICY[
                (spec["mode"], spec["precision"])])]
    # the children's set-up shares the card with this process
    torch.cuda.empty_cache()
    children = AutotuneChildren(jobs, workdir)
    try:
        ready_s = children.wait_ready()
        log(f"[autotune] {len(jobs)} fresh processes set up together "
            f"(imports, the libraries' load, the model and batch on the "
            f"card) in {ready_s:.1f} s")
        points = _autotune_points(kernels, specs, reuse, children)
    finally:
        children.close()
    recs = [r for p in points.values() for r in p.pop("_recs").values()
            if r.get("launches")]
    launches = {k.name: sum(r["launches"][k.name] for r in recs)
                for k in kernels}
    policy = autotune_policy(points)
    log("[autotune] the policy the rule gives: " + json.dumps(
        {f"{m} {p}": s for (m, p), s in sorted(policy.items())})
        + "; compile_cache.POLICY: " + json.dumps(
        {f"{m} {p}": s for (m, p), s in sorted(POLICY.items())}))
    check_autotune_policy(points)
    return {"points": points, "launches": launches, "ready_s": ready_s,
            "policy": {f"{m} {p}": s for (m, p), s in sorted(policy.items())},
            "applied": {f"{m} {p}": s for (m, p), s in sorted(POLICY.items())}}


def _gib(n) -> str:
    return "n/a" if n is None else f"{n / 2 ** 30:.2f}"


def autotune_reuse(train, roofline) -> dict:
    """The f32 point at 1344², batch 4, as earlier phases of this process
    measured it under its policy: step 1 of the train phase (on a fresh
    thread) with the timed steps of the roofline phase's f32 rung.  Only
    this point: a step 1 late in this process read 1.3-2x that of a fresh
    process at bf16 (20.15 s against 9.87 s under the same shapes), which
    decides nothing only where the full autotune takes ~115 s."""
    points = (roofline or {}).get("points", {})
    if not train or "f32" not in points:
        return {}
    r = points["f32"]
    return {"train_f32_b4": {
        "start_s": train["rows"][0]["step_time_ms"] / 1e3,
        "times_ms": r["step_times_ms"], "peak_bytes": r["measured_peak_bytes"],
        "source": "step 1 of this process's train phase, steps of the "
                  "roofline phase's f32 rung"}}


# ---------------------------------------------------------------------
# phase charts: the GPU charts' rendered commands, run as the pods would
# ---------------------------------------------------------------------

#: a one-card install of the training chart (``--set``)
CHARTS_ONE_CARD = {"maskrcnn.gpus": 1, "maskrcnn.gpus_per_node": 1}
#: steps of each training leg: the chart logs every 20th step
#: (TRAIN.LOG_PERIOD), so the row at 40 is the mean of steps 21-40
CHARTS_STEPS = 40
#: the optimized leg is stopped once /healthz reports this step
CHARTS_SIGTERM_STEP = 3
CHARTS_TRAIN_IMAGES = 16
CHARTS_VAL_IMAGES = 4
CHARTS_BUDGET = 900.0
#: the TensorPack R50 layout: (blocks, bottleneck width) per group
R50_GROUPS = ((3, 64), (4, 128), (6, 256), (3, 512))
LAUNCH_LINE = "ROIAlign kernel launches in this process: "


def write_shapes_split(base: str, split: str, n: int, seed: int,
                       size=(480, 640), id_base: int = 1) -> None:
    """The shapes split as a COCO directory under ``base``: JPEGs in
    ``base/split`` and ``base/annotations/instances_<split>.json`` (needs
    PIL)."""
    from PIL import Image

    data, pixels = shapes_coco(n, seed, size=size, id_base=id_base)
    os.makedirs(os.path.join(base, split))
    for name, img in pixels.items():
        Image.fromarray(img).save(os.path.join(base, split, name),
                                  quality=92)
    os.makedirs(os.path.join(base, "annotations"), exist_ok=True)
    with open(os.path.join(base, "annotations",
                           f"instances_{split}.json"), "w") as f:
        json.dump(data, f)


def write_r50_npz(path: str, seed: int) -> int:
    """A seeded stand-in for ``ImageNet-R50-AlignPadding.npz`` in the
    TensorPack layout ``models/backbone_loader.py`` reads, written from
    the R50 architecture (``R50_GROUPS``), not from the port's state dict:
    ``conv0/W`` [7, 7, 3, 64] and ``group{g}_block{b}/conv{1,2,3}`` (and
    ``convshortcut`` in block 0) kernels in HWIO, each conv with its
    ``bn/gamma``, ``bn/beta``, ``bn/mean/EMA`` and ``bn/variance/EMA``.
    Returns the count of arrays."""
    rng = np.random.RandomState(seed)
    arrays = {}

    def conv(name, k, cin, cout, gamma=(0.8, 1.2)):
        arrays[f"{name}/W"] = (rng.standard_normal((k, k, cin, cout))
                               * np.sqrt(2.0 / (k * k * cin))
                               ).astype(np.float32)
        arrays[f"{name}/bn/gamma"] = rng.uniform(*gamma, cout).astype(
            np.float32)
        arrays[f"{name}/bn/beta"] = rng.uniform(-0.05, 0.05, cout).astype(
            np.float32)
        arrays[f"{name}/bn/mean/EMA"] = rng.uniform(-0.05, 0.05, cout
                                                    ).astype(np.float32)
        arrays[f"{name}/bn/variance/EMA"] = rng.uniform(
            0.9, 1.1, cout).astype(np.float32)

    conv("conv0", 7, 3, 64)
    cin = 64
    for g, (blocks, width) in enumerate(R50_GROUPS):
        for b in range(blocks):
            key = f"group{g}_block{b}"
            conv(f"{key}/conv1", 1, cin, width)
            conv(f"{key}/conv2", 3, width, width)
            # a small last scale per block, as a trained ResNet's: the
            # residual sum keeps the activations' scale through 16 blocks
            conv(f"{key}/conv3", 1, width, 4 * width, gamma=(0.05, 0.25))
            if b == 0:
                conv(f"{key}/convshortcut", 1, cin, 4 * width)
            cin = 4 * width
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **arrays)
    return len(arrays)


def chart_container(chart: str, files=(), overrides=None,
                    release: str = "eksml"):
    """The workload container of ``chart``'s render (with values files
    and ``--set`` overrides, installed as ``release``), its pod spec and
    its document."""
    import yaml

    from eksml_tpu_torch.tools import render_charts

    docs = [d for d in yaml.safe_load_all(
        render_charts.render(chart, files, overrides, release)) if d]
    for d in docs:
        if d["kind"] == "JobSet":
            pod = d["spec"]["replicatedJobs"][0]["template"]["spec"][
                "template"]["spec"]
            return pod["containers"][0], pod, d
        if d["kind"] == "Deployment":
            pod = d["spec"]["template"]["spec"]
            return pod["containers"][0], pod, d
    raise AssertionError(f"{chart}: no workload in the render")


def chart_train_argv(release: str, files, workdir: str, device: str):
    """The training chart's command and env for a one-card install as
    ``release`` (``helm install <release> charts/maskrcnn-gpu -f
    <files> --set maskrcnn.gpus=1,maskrcnn.gpus_per_node=1``; the release
    names the run directory), as the pod would run it, with only these
    changed (each printed): ``/efs``
    under ``workdir``, ``TELEMETRY.PORT`` and ``COORDINATOR_ADDRESS`` on
    free ports, ``PROCESS_ID`` the completion index 0 (the downward API's
    value), ``python3`` this interpreter, ``PYTHONPATH`` the checkout (the
    image's ``ENV``), ``--total-steps`` appended.  Returns (argv, env, the
    trainer's --config items, the telemetry port, the logdir)."""
    c, _, _ = chart_container("charts/maskrcnn-gpu", files, CHARTS_ONE_CARD,
                              release)
    cmd = list(c["command"])
    efs = os.path.join(workdir, "efs")
    tport, cport = _free_port(), _free_port()
    changes = [f"python3 -> {sys.executable}", f"/efs -> {efs}",
               f"TELEMETRY.PORT -> {tport}"]
    argv = [sys.executable]
    for a in cmd[1:]:
        if a.startswith("/efs/"):
            a = efs + a[len("/efs"):]
        elif "=/efs/" in a:
            key, _, path = a.partition("=")
            a = f"{key}={efs}{path[len('/efs'):]}"
        elif a.startswith("TELEMETRY.PORT="):
            a = f"TELEMETRY.PORT={tport}"
        argv.append(a)
    items = argv[argv.index("--config") + 1:]
    argv += list(VARIANT_BASE)
    if device != "cuda":
        argv += ["--device", device]
    argv += ["--total-steps", str(CHARTS_STEPS)]
    changes.append(f"--total-steps {CHARTS_STEPS} appended")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, PROCESS_ID="0")
    for e in c["env"]:
        if "value" in e:
            env[e["name"]] = e["value"]
    env["COORDINATOR_ADDRESS"] = f"127.0.0.1:{cport}"
    changes += [f"COORDINATOR_ADDRESS -> 127.0.0.1:{cport}",
                "PROCESS_ID -> 0 (the completion index)",
                f"PYTHONPATH -> {here}"]
    logdir = argv[argv.index("--logdir") + 1]
    log(f"[charts] release {release}: {' '.join(cmd)}\n[charts]   "
        "changed: " + "; ".join(changes))
    return argv, env, items, tport, logdir


class ChartPod:
    """One run of a chart's container command: its own session (a kill
    ends its ranks too), output to ``log_path``, ``/healthz`` of the
    trainer's exporter on ``port`` polled for the step."""

    def __init__(self, argv, env, log_path: str, port: int):
        self.log_path, self.port = log_path, port
        self.t0 = time.perf_counter()
        with open(log_path, "w") as f:
            self.proc = subprocess.Popen(
                argv, env=env, stdout=f, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                start_new_session=True)

    def health(self):
        try:
            status, body = _http(self.port, "/healthz")
        except OSError:
            return None
        return json.loads(body) if status in (200, 503) else None

    def wait_step(self, step: int) -> float:
        """Seconds from the start until /healthz reports ``step`` (0: until
        it answers)."""
        deadline = time.monotonic() + CHARTS_BUDGET
        while time.monotonic() < deadline:
            h = self.health()
            if h is not None and (h.get("step") or 0) >= step:
                return time.perf_counter() - self.t0
            assert self.proc.poll() is None, \
                f"exited {self.proc.returncode} before step {step}"
            time.sleep(0.05)
        raise AssertionError(f"no step {step} in {CHARTS_BUDGET} s")

    def wait(self) -> int:
        return self.proc.wait(timeout=CHARTS_BUDGET)

    def text(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def kill(self) -> None:
        import signal

        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()
        log(f"[charts] output of {os.path.basename(self.log_path)}:\n"
            + self.text()[-4000:])


def logged_launches(text: str, prefix: str = "") -> dict:
    """The kernel launch counts a process logged at its exit."""
    lines = [line for line in text.splitlines()
             if line.startswith(prefix) and LAUNCH_LINE in line]
    assert len(lines) == 1, lines
    return json.loads(lines[0].split(LAUNCH_LINE, 1)[1])


def run_train_leg(tag: str, argv, env, port: int, logdir: str,
                  workdir: str, first: int = 1, sigterm_step=None):
    """One launch of the training chart's command: the launcher's exit
    code, the rank's log and the leg's timings (to /healthz reporting
    step ``first``: the first step this launch trains).  With
    ``sigterm_step`` the launcher gets SIGTERM (as kubelet sends it to the
    pod's PID 1) once /healthz reports that step."""
    import re
    import signal

    # this leg's rows: the logdir's files grow across legs
    files = [os.path.join(logdir, name)
             for name in ("metrics.jsonl", "events-host0.jsonl")]
    since = [len(_rows(f)) if os.path.exists(f) else 0 for f in files]
    pod = ChartPod(argv, env, os.path.join(workdir, f"charts-{tag}.log"),
                   port)
    out = {}
    try:
        out["healthz_s"] = pod.wait_step(0)     # the exporter is up
        out["first_step_s"] = pod.wait_step(first)
        if sigterm_step is not None:
            pod.wait_step(sigterm_step)
            t_term = time.perf_counter()
            pod.proc.send_signal(signal.SIGTERM)
            rc = pod.wait()
            out["sigterm_to_exit_s"] = time.perf_counter() - t_term
        else:
            rc = pod.wait()
        out["wall_s"] = time.perf_counter() - pod.t0
    except BaseException:
        pod.kill()
        raise
    text = pod.text()
    out["rc"] = rc
    keep = re.compile(r"WARNING|ERROR|Traceback|loaded \d+/|resuming|"
                      r"preempted|step \d+/\d+ loss|training complete|"
                      + re.escape(LAUNCH_LINE))
    log(f"[charts] {tag}: the launcher's lines of note:\n" + "\n".join(
        line for line in text.splitlines() if keep.search(line)
        and "absl" not in line)[-6000:])
    rows, events = (_rows(f)[n:] for f, n in zip(files, since))
    out["rows"] = rows
    out["compile_ms"] = [e["compile_ms"] for e in events
                         if e.get("kind") == "compile_done"]
    out["launches"] = logged_launches(text, "[rank 0] ")
    m = re.search(r"\[rank 0\] .*resuming from checkpoint step (\d+)", text)
    out["resumed_from"] = int(m.group(1)) if m else None
    m = re.search(r"\[rank 0\] .*preempted at step (\d+)", text)
    out["preempted_at"] = int(m.group(1)) if m else None
    m = re.search(r"\[rank 0\] .*backbone weights: loaded (\d+)/(\d+)", text)
    out["backbone"] = (int(m.group(1)), int(m.group(2))) if m else None
    out["text"] = text
    log(f"[charts] {tag}: rc {rc}, /healthz up {out['healthz_s']:.1f} s, "
        f"first step (/healthz step {first}) {out['first_step_s']:.1f} s "
        f"after the launcher started; its first step (compile_done) "
        f"{out['compile_ms']} ms; logged rows "
        + json.dumps([{k: r[k] for k in ("step", "total_loss",
                                         "step_time_ms") if k in r}
                      for r in rows])
        + f"; launches {out['launches']}; wall {out['wall_s']:.1f} s")
    return out


def _eval_batches(items, base: str) -> int:
    """Batches of the trainer's end-of-run eval on ``base``'s val2017
    under the chart's config (the evaluator's own plan)."""
    from eksml_tpu_torch.data.coco import CocoDataset
    from eksml_tpu_torch.evalcoco.runner import _plan

    cfg = variant_config(*items, training=True)
    records = CocoDataset(base, cfg.DATA.VAL).records(skip_empty=False)
    return len(_plan(cfg, records, len(records), 1,
                     max(1, int(cfg.TEST.EVAL_BATCH_SIZE))))


def _check_leg_launches(kernels, leg, steps: int, eval_batches: int,
                        tag: str) -> None:
    got = leg["launches"]
    want = {kernels.fwd.name: 3 * steps + 2 * eval_batches,
            kernels.bwd.name: 2 * steps, kernels.copy.name: 8 * steps}
    assert got == want, (tag, got, want)


def _check_serve_launches(kernels, served) -> None:
    """Two forwards per warmed shape and per dispatched batch."""
    want = {kernels.fwd.name: 2 * (served["warm_shapes"]
                                   + served["batches"]),
            kernels.bwd.name: 0, kernels.copy.name: 0}
    assert served["launches"] == want, (served, want)


#: the port's viz notebooks, run by the charts phase's notebook leg
NOTEBOOKS = ("mask-rcnn-eksml-gpu-viz.ipynb",
             "mask-rcnn-eksml-gpu-optimized-viz.ipynb")
NOTEBOOK_CHILD = """
import json, sys
from eksml_tpu_torch.tools.run_notebook import run
from eksml_tpu_torch.ops.roi_align import KERNELS
run(sys.argv[1])
print("JAX MODULES", sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "eksml_tpu")))
print(sys.argv[2] + json.dumps({k.name: k.launches for k in KERNELS}))
"""


def check_event_files(logdir: str) -> dict:
    """The run's TensorBoard event files read with the port's reader
    (each record's CRCs checked): every scalar of every ``metrics.jsonl``
    row at its step, equal as float32."""
    from eksml_tpu_torch.utils import tfevents

    files = sorted(f for f in os.listdir(logdir) if "tfevents" in f)
    assert files, f"no event files in {logdir}"
    events = tfevents.read_scalars(logdir)
    n = 0
    for r in _rows(os.path.join(logdir, "metrics.jsonl")):
        if "step" not in r:
            continue
        for k, v in r.items():
            if k in ("step", "time") or not isinstance(v, float):
                continue
            got = events.get(k, {}).get(r["step"])
            assert got == np.float32(v), (k, r["step"], got, v)
            n += 1
    log(f"[charts] event files {files}: {n} scalars, each equal as float32 "
        f"to its metrics.jsonl row")
    assert n > 0
    return {"files": len(files), "scalars": n}


def notebook_leg(kernels, workdir: str, device: str = "cuda") -> dict:
    """The port's two viz notebooks (``container-gpu-viz/notebooks``)
    run cell by cell as scripts (``tools/run_notebook``), each in a
    process of its own, both at once, against the runs under the
    charts' ``/efs`` (``FS_ROOT``) as the Jupyter pod would run them:
    their detection counts, no JAX module loaded, and 2 ROIAlign forward
    launches each (one predict forward)."""
    import re

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here,
               FS_ROOT=os.path.join(workdir, "efs"), EKSML_NB_DEVICE=device,
               EKSML_NB_CONFIG=" ".join(VARIANT_BASE))
    env.pop("DATA_DIR", None)
    procs = {}
    t0 = time.perf_counter()
    for name in NOTEBOOKS:
        path = os.path.join(here, "container-gpu-viz", "notebooks", name)
        f = open(os.path.join(workdir, f"notebook-{name}.log"), "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", NOTEBOOK_CHILD, path, LAUNCH_LINE],
            stdout=f, stderr=subprocess.STDOUT, cwd=here, env=env,
            start_new_session=True), f)
    out = {}
    try:
        for name, (proc, f) in procs.items():
            rc = proc.wait(timeout=CHARTS_BUDGET)
            f.close()
            with open(f.name) as g:
                text = g.read()
            assert rc == 0, (name, rc, text[-3000:])
            launches = logged_launches(text)
            count = int(re.search(r"^(\d+) detections$", text,
                                  re.M).group(1))
            assert "JAX MODULES []" in text, text[-2000:]
            assert "<PIL.Image.Image image mode=RGB" in text
            want = {kernels.fwd.name: 2, kernels.bwd.name: 0,
                    kernels.copy.name: 0}
            assert launches == want, (name, launches, want)
            lines = [line for line in text.splitlines()
                     if line.startswith(("using run:", "latest step:",
                                         "image:", "output/", "resize"))
                     or re.match(r"^\d+ detections$", line)]
            log(f"[charts] notebook {name}: " + "; ".join(lines)
                + f"; launches {launches}")
            out[name] = {"detections": count, "launches": launches}
    finally:
        for proc, f in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
            f.close()
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_charts(kernels, seed: int, workdir: str, device: str = "cuda"):
    """The GPU charts' rendered commands for a one-card install
    (``gpus=1, gpus_per_node=1``), run as the pods would
    (``chart_train_argv`` lists what changes): the default (float32)
    training chart through ``eksml_tpu_torch.launch`` for
    ``CHARTS_STEPS`` steps on the shapes COCO split and a stand-in R50
    npz (every array loaded), its checkpoint and end-of-run eval; the
    optimized overlay stopped by SIGTERM (exit 77 after the forced
    checkpoint) and relaunched (resumes at that step + 1, runs to the
    end); the serve chart's stable command on that run (``/healthz``
    200, 4 requests, drain); the autoscaler chart's argv through the
    operator's parser, with the kubectl commands a transition issues."""
    from eksml_tpu_torch.resilience.autoscale import topology_ladder
    from eksml_tpu_torch.tools import eksml_operator as op

    out = {}
    data = os.path.join(workdir, "efs", "data")
    t0 = time.perf_counter()
    write_shapes_split(data, "train2017", CHARTS_TRAIN_IMAGES, seed)
    write_shapes_split(data, "val2017", CHARTS_VAL_IMAGES, seed + 100,
                       id_base=1001)
    n_arrays = write_r50_npz(os.path.join(
        data, "pretrained-models", "ImageNet-R50-AlignPadding.npz"), seed)
    log(f"[charts] staged {data}: shapes train2017 ({CHARTS_TRAIN_IMAGES} "
        f"JPEGs), val2017 ({CHARTS_VAL_IMAGES}), a stand-in R50 npz of "
        f"{n_arrays} arrays, in {time.perf_counter() - t0:.1f} s")

    # the default chart: float32, batch 1
    argv, env, items, port, logdir = chart_train_argv("maskrcnn", (),
                                                      workdir, device)
    f32 = run_train_leg("f32", argv, env, port, logdir, workdir)
    assert f32["rc"] == 0, (f32["rc"], f32["text"][-3000:])
    assert f32["backbone"] == (n_arrays, n_arrays), f32["backbone"]
    steps = [r["step"] for r in f32["rows"] if "total_loss" in r]
    assert steps == [20, CHARTS_STEPS], steps
    assert all(np.isfinite(r["total_loss"]) for r in f32["rows"]
               if "total_loss" in r)
    assert any("val/bbox/AP" in r for r in f32["rows"]), f32["rows"]
    assert os.path.isdir(os.path.join(logdir, "checkpoints",
                                      str(CHARTS_STEPS)))
    _check_leg_launches(kernels, f32, CHARTS_STEPS,
                        _eval_batches(items, data), "f32")
    out["f32"] = {k: f32[k] for k in ("healthz_s", "first_step_s",
                                      "compile_ms", "wall_s", "launches")}
    out["f32"]["step_time_ms"] = [r["step_time_ms"] for r in f32["rows"]
                                  if "step_time_ms" in r]
    out["events"] = check_event_files(logdir)
    # the Jupyter pod's notebooks, while the f32 run is the only one
    # under /efs (the notebooks take the newest run directory)
    out["notebooks"] = notebook_leg(kernels, workdir, device)

    # the optimized overlay: SIGTERM, exit 77, relaunch, resume
    argv, env, items, port, logdir = chart_train_argv(
        "maskrcnn-optimized", ("values-optimized.yaml",), workdir, device)
    stopped = run_train_leg("optimized", argv, env, port, logdir, workdir,
                            sigterm_step=CHARTS_SIGTERM_STEP)
    assert stopped["rc"] == 77, (stopped["rc"], stopped["text"][-3000:])
    assert stopped["backbone"] == (n_arrays, n_arrays), stopped["backbone"]
    ck = stopped["preempted_at"]
    assert ck is not None and ck >= CHARTS_SIGTERM_STEP, ck
    assert os.path.isdir(os.path.join(logdir, "checkpoints", str(ck)))
    _check_leg_launches(kernels, stopped, ck, 0, "optimized")
    again = run_train_leg("optimized-relaunch", argv, env, port, logdir,
                          workdir, first=ck + 1)
    assert again["rc"] == 0, (again["rc"], again["text"][-3000:])
    assert again["resumed_from"] == ck, (again["resumed_from"], ck)
    steps = [r["step"] for r in again["rows"] if "total_loss" in r]
    assert steps[0] > ck and steps[-1] == CHARTS_STEPS, steps
    _check_leg_launches(kernels, again, CHARTS_STEPS - ck,
                        _eval_batches(items, data), "optimized-relaunch")
    out["optimized"] = {
        "first_step_s": stopped["first_step_s"],
        "compile_ms": stopped["compile_ms"], "checkpoint_step": ck,
        "sigterm_to_exit_s": stopped["sigterm_to_exit_s"],
        "relaunch_first_step_s": again["first_step_s"],
        "relaunch_compile_ms": again["compile_ms"],
        "step_time_ms": [r["step_time_ms"] for r in again["rows"]
                         if "step_time_ms" in r],
        "launches": [stopped["launches"], again["launches"]]}
    log(f"[charts] optimized: SIGTERM after step {CHARTS_SIGTERM_STEP} -> "
        f"exit 77 in {stopped['sigterm_to_exit_s']:.1f} s (forced "
        f"checkpoint {ck}); relaunch resumed at {ck + 1}, its first step "
        f"{again['first_step_s']:.1f} s after the launcher started")

    # the serve chart's stable track on the optimized run
    c, _, _ = chart_container("charts/serve-gpu")
    cmd = list(c["command"])
    port_file = os.path.join(workdir, "charts-serve.port")
    sargv = [sys.executable] + [
        logdir if a.startswith("/efs/") else a for a in cmd[1:]] + [
        *VARIANT_BASE, "--port", "0", "--port-file", port_file]
    if device != "cuda":
        sargv += ["--device", device]
    log(f"[charts] serve: {' '.join(cmd)}\n[charts]   changed: "
        f"python3 -> {sys.executable}; --checkpoint-dir -> {logdir}; "
        "--port 0 --port-file appended")
    served = chart_subprocess(sargv, workdir, port_file,
                              log_path=os.path.join(workdir,
                                                    "charts-serve.log"),
                              tag="charts")
    _check_serve_launches(kernels, served)
    out["serve"] = {k: served[k] for k in ("ready_s", "params_step",
                                           "latency_ms", "launches",
                                           "batches", "warm_shapes")}

    # the autoscaler chart: its argv through the operator's parser
    c, _, dep = chart_container("charts/autoscaler-gpu")
    args = op.build_parser().parse_args(c["command"][3:])
    _, _, js = chart_container("charts/maskrcnn-gpu")
    assert (args.mode, args.capacity_resource) == ("kubectl",
                                                   "nvidia.com/gpu")
    assert (args.jobset, args.namespace) == (
        js["metadata"]["name"], js["metadata"]["namespace"])
    acfg = variant_config(*args.config)
    options = tuple(acfg.RESILIENCE.AUTOSCALE.CHIP_OPTIONS)
    cmds = {t.chips: op.kubectl_transition_cmds(args.jobset, args.namespace,
                                                t)
            for t in topology_ladder(options, strategy="replicated")}
    assert sorted(cmds) == sorted(options), cmds
    log(f"[charts] autoscaler: {' '.join(c['command'])}\n[charts]   a "
        "transition's kubectl commands (no cluster here): " + json.dumps(
            {n: [" ".join(x) for x in v] for n, v in cmds.items()}))
    out["autoscaler_options"] = list(options)

    out["launches"] = {k.name: sum(leg["launches"][k.name] for leg in (
        f32, stopped, again, served, *(
            v for v in out["notebooks"].values() if isinstance(v, dict))))
        for k in kernels}
    from eksml_tpu_torch.utils.compile_cache import POLICY

    log(f"[charts] restarts under the cuDNN policy "
        f"{json.dumps({f'{m} {p}': v for (m, p), v in POLICY.items()})}: "
        f"the f32 chart's step 1 {f32['compile_ms'][0] / 1e3:.1f} s (earlier "
        f"runs on the card: 24.9-27.6 s), launcher start to step 1 "
        f"{f32['first_step_s']:.1f} s (47.7-52.0 s); the optimized "
        f"overlay's relaunch to its first resumed step "
        f"{again['first_step_s']:.1f} s (28.1-31.2 s); the serve chart's "
        f"/healthz 200 after {served['ready_s']:.1f} s (19.9-20.5 s)")
    return out


# ---------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma list out of {PHASES} (default: all)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-rank", default=None, metavar="RUN",
                   help="internal: one rank of the ranks phase's eval")
    p.add_argument("--autotune-child", default=None, metavar="SPEC",
                   help="internal: one point of the autotune phase")
    args = p.parse_args(argv)
    phases = [s for s in args.phases.split(",") if s]
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")
    if "fleet" in phases and "lifecycle" not in phases:
        p.error("the fleet phase serves the lifecycle phase's checkpoints: "
                "add lifecycle")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    if args.eval_rank:
        return eval_rank(args.eval_rank)
    if args.autotune_child:
        return autotune_child(args.autotune_child)
    from eksml_tpu_torch.ops.roi_align import KERNELS

    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    walls = {}
    # the kernels build first whatever phases run
    timed(walls, "build", phase_build, KERNELS)
    records = (timed(walls, "kernel", phase_kernel, KERNELS, args.seed)
               if "kernel" in phases else {})
    # the lifecycle phase reloads into the serve phase's engine and
    # resumes the train phase's run
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    engine = serve = train = life = dist_out = fleet = operator = None
    ranks = evaluated = eval_ref = coco = None
    bf16 = serve16 = cascade = variants = observed = charts = None
    roofline = autotune = None
    try:
        if {"serve", "reference", "profile", "lifecycle"} & set(phases):
            engine, serve = timed(walls, "serve", phase_serve,
                                  serve_config(), KERNELS, args.seed)
        if "reference" in phases:
            timed(walls, "reference", phase_reference, engine.model,
                  args.seed)
        if "profile" in phases:
            timed(walls, "profile", phase_profile, engine, args.seed)
        if {"train", "lifecycle", "dist", "eval"} & set(phases):
            cfg = train_config()
            trainer, batches, train = timed(
                walls, "train", phase_train, cfg, KERNELS, args.seed,
                os.path.join(workdir, "train"),
                extra_batches=("profile" in phases)
                + ("lifecycle" in phases))
            if "profile" in phases:
                # one batch to a total one step further: the profiled
                # step is not the run's last, which checkpoints
                timed(walls, "profile (training step)", profile_window,
                      f"training step {TRAIN_STEPS + 1} at "
                      f"{CANVAS}x{CANVAS}, batch {BATCH}",
                      lambda: trainer.fit(
                          iter([next(batches)]), TRAIN_STEPS + 2,
                          start_step=TRAIN_STEPS))
            if "eval" in phases:
                evaluated = timed(walls, "eval", phase_eval, cfg, KERNELS,
                                  trainer, workdir, args.seed)
            if "lifecycle" in phases:
                life = timed(walls, "lifecycle", phase_lifecycle, cfg,
                             KERNELS, trainer, batches, engine, serve,
                             workdir)
            trainer.close()
            del trainer, batches
            torch.cuda.empty_cache()
            if "fleet" in phases:
                fleet = timed(walls, "fleet", phase_fleet, KERNELS,
                              args.seed, workdir, life["run"])
            if "operator" in phases:
                operator = timed(walls, "operator", phase_operator, workdir)
            if "dist" in phases:
                dist_out = timed(walls, "dist", phase_dist, cfg, KERNELS,
                                 args.seed, train, workdir)
        if engine is not None:
            engine.close()
            del engine
            torch.cuda.empty_cache()
        if "operator" in phases and operator is None:
            operator = timed(walls, "operator", phase_operator, workdir)
        if "ranks" in phases:
            ranks = timed(walls, "ranks", phase_ranks, workdir)
        if "train_reference" in phases:
            timed(walls, "train_reference", phase_train_reference, args.seed)
        if "eval_reference" in phases:
            eval_ref = timed(walls, "eval_reference", phase_eval_reference,
                             KERNELS, args.seed, workdir)
        if "coco" in phases:
            coco = timed(walls, "coco", phase_coco, KERNELS, args.seed,
                         workdir)
        if "train_bf16" in phases:
            bf16 = timed(walls, "train_bf16", phase_train_bf16, KERNELS,
                         args.seed, workdir)
        if "serve_bf16" in phases:
            serve16 = timed(walls, "serve_bf16", phase_serve_bf16, KERNELS,
                            args.seed)
        if "cascade" in phases:
            cascade = timed(walls, "cascade", phase_cascade, KERNELS,
                            args.seed, workdir, records)
        if "variants_reference" in phases:
            variants = timed(walls, "variants_reference",
                             phase_variants_reference, args.seed)
        if "observe" in phases:
            observed = timed(
                walls, "observe", phase_observe, KERNELS, args.seed,
                workdir, train["batches"][:2] if train else
                _synthetic_batches(train_config(), args.seed, BATCH, 2))
        if "roofline" in phases:
            roofline = timed(walls, "roofline", phase_roofline, KERNELS,
                             args.seed, workdir, observed, life)
        if "autotune" in phases:
            autotune = timed(walls, "autotune", phase_autotune, KERNELS,
                             args.seed, workdir,
                             autotune_reuse(train, roofline))
        if "charts" in phases:
            charts = timed(walls, "charts", phase_charts, KERNELS, args.seed,
                           workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f}s; "
        "wall by phase: " + json.dumps(
            {k: round(v, 1) for k, v in walls.items()}))

    if records:
        out = []
        for k in KERNELS:
            recs = records[k.name]
            f32 = [r for r in recs if r["dtype"] == "float32"]
            # the figure for the line: the kernel's calls in one training
            # step, float32 (the train path runs all three kernels)
            main_rec = next(r for r in f32 if r["call"] == STEP_CALL)
            launches = None
            if train is not None:        # the train path runs all three
                launches = train["launches"][k.name]
            elif serve is not None and k is KERNELS.fwd:
                launches = serve["launches"][k.name]
            out.append({
                "name": k.name,
                "route": "cuda",
                "source": k.source,
                "replaces": k.replaces,
                "launches": launches,
                "launches_by_path": {
                    "serve": serve["launches"][k.name] if serve else None,
                    "train": train["launches"][k.name] if train else None,
                    "lifecycle": life["launches"][k.name] if life else None,
                    "fleet": fleet["launches"][k.name] if fleet else None,
                    "dist": (dist_out["launches"][k.name] if dist_out
                             else None),
                    "eval": (evaluated["launches"][k.name] if evaluated
                             else None),
                    "eval_reference_train_step": (
                        eval_ref["train_launches"][k.name] if eval_ref
                        else None),
                    "coco": coco["launches"][k.name] if coco else None,
                    "train_bf16": (bf16["launches"][k.name] if bf16
                                   else None),
                    "serve_bf16": (serve16["launches"][k.name] if serve16
                                   else None),
                    "cascade": (cascade["launches"][k.name] if cascade
                                else None),
                    "cascade_predict": (
                        cascade["predict_launches"][k.name] if cascade
                        else None),
                    "observe": (observed["launches"][k.name] if observed
                                else None),
                    "roofline": ({label: rec["launches"][k.name]
                                  for label, rec in
                                  roofline["points"].items()}
                                 if roofline else None),
                    # the fresh processes' own counts, summed
                    "autotune": (autotune["launches"][k.name] if autotune
                                 else None),
                    "charts": (charts["launches"][k.name] if charts
                               else None)},
                "max_abs_err": max(r["max_abs_err"] for r in f32),
                "figure": f"{STEP_CALL}, float32",
                "ms": main_rec["ms"],
                "plain_ms": main_rec["plain_ms"],
                "bound_ms": main_rec["bound_ms"],
                "bound_by": main_rec["bound_by"],
                "library_ms": main_rec["library_ms"],
                "library": ("dst.copy_(src)" if k is KERNELS.copy
                            else "none"),
                # the same kernel's calls in one step of the bf16
                # training point and of the cascade (batch 1)
                **{key: _step_summary(recs, call) for key, call in (
                    ("bf16_step", BF16_STEP_CALL),
                    ("cascade_step", CASCADE_STEP_CALL))},
                # the component the observe phase's captures gave the
                # kernel and its share of the captured steps' device time
                **({f"observe_{point}": observed[key]["kernels"][k.name]
                    for point, key in (("f32", "attribution"),
                                       ("bf16", "bf16"))}
                   if observed else {}),
                "shapes": recs,
            })
        print(json.dumps({"kernels": out}), flush=True)
    card = gpu_name_and_limit()
    cards = "; ".join(card.splitlines())    # one line per device
    if life is not None:
        keys = ("ckpt_bytes", "save_blocking_ms", "save_write_ms",
                "restore_ms", "reload_verify_ms", "reload_restore_ms",
                "reload_swap_ms")
        log(f"[lifecycle] on {cards}: " + json.dumps(
            {key: life[key] for key in keys}))
    if fleet is not None:
        log(f"[fleet] on {cards}: " + json.dumps(
            {k: v for k, v in fleet.items() if k != "launches"}))
    if operator is not None:
        log(f"[operator] on {cards}: " + json.dumps({
            leg: {k: v for k, v in rec.items() if k != "run"}
            for leg, rec in operator.items()}))
    if dist_out is not None:
        keys = ("nccl_init_ms", "warm_ms", "replicated", "fsdp")
        log(f"[dist] on {cards}: plain train phase median "
            f"{train['median_s'] * 1e3:.1f} ms, peak {train['peak_bytes']} B; "
            + json.dumps({key: dist_out[key] for key in keys}))
    if ranks is not None:
        log(f"[ranks] on {cards}: " + json.dumps(ranks))
    if evaluated is not None:
        log(f"[eval] on {cards}: " + json.dumps(
            {k: v for k, v in evaluated.items() if k != "launches"}))
    if eval_ref is not None:
        log(f"[eval_reference] on {cards}: " + json.dumps(eval_ref["errors"]))
    if bf16 is not None:
        log(f"[train_bf16] on {cards}: " + json.dumps({
            name: {k: r[k] for k in ("step1_s", "median_ms", "peak_bytes",
                                     "param_bytes", "opt_bytes",
                                     "launches_per_step")}
            for name, r in bf16.items() if name not in ("launches",
                                                         "memory")})
            + "; memory of one step above the weights: "
            + json.dumps(bf16["memory"])
            + (f"; float32 train phase of this call: median "
               f"{train['median_s'] * 1e3:.1f} ms, peak "
               f"{train['peak_bytes']} B" if train else ""))
    if serve16 is not None:
        log(f"[serve_bf16] on {cards}: " + json.dumps(
            {k: serve16[k] for k in ("warmup_s", "wall_s", "images_per_s",
                                     "latency_ms", "warmup_peak_bytes",
                                     "serve_peak_bytes", "launches")}))
    if cascade is not None:
        log(f"[cascade] on {cards}: " + json.dumps(
            {k: cascade[k] for k in ("step1_s", "median_ms", "peak_bytes",
                                     "launches_per_step", "predict_first_s",
                                     "predict_ms", "predict_launches")}))
    if variants is not None:
        log(f"[variants_reference] on {cards}: " + json.dumps(variants))
    if observed is not None:
        log(f"[observe] on {cards}: " + json.dumps({
            "f32_step_by_component": observed["attribution"],
            "bf16_step_by_component": observed["bf16"],
            "captures": observed["captures"],
            "profiler_windows": PROFILER_WINDOWS["n"],
            "goodput": observed["goodput"], "wall_s": observed["wall_s"],
            "healthz_503_after_s": observed["healthz_503_after_s"],
            "mask_target_call": observed["mask_target_call"],
            "profiler_windows_seen": observed["profiler_windows"],
            "overhead": observed["overhead"]}))
    if roofline is not None:
        keys = ("step_time_ms", "first_step_s", "predicted_step_time_ms",
                "predicted_sections_ms", "tflops_per_step",
                "recompute_tflops", "mfu", "value",
                "predicted_peak_hbm_bytes", "measured_peak_bytes",
                "measured_allocated_before_step_bytes")
        log(f"[roofline] on {cards}: " + json.dumps(
            {"points": {label: {k: rec[k] for k in keys}
                        for label, rec in roofline["points"].items()},
             "eval_ckpt": roofline.get("eval_ckpt")}))
    if autotune is not None:
        log(f"[autotune] on {cards}: " + json.dumps(
            {k: v for k, v in autotune.items() if k != "launches"}))
    if charts is not None:
        log(f"[charts] on {cards}: " + json.dumps(
            {k: v for k, v in charts.items() if k != "launches"}))
    print(card, flush=True)
    if set(phases) != set(PHASES):
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
