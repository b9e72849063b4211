#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``eksml_tpu_torch``) on one CUDA card.

Phases (any failure raises and exits non-zero; nothing falls back):

1. build   — compile every CUDA source of the port with nvcc (all at
             once) and print the build time and nvcc's register/spill
             summary.
2. kernel  — hold each kernel against its plain PyTorch version on the
             card at the shapes the main paths give it and time both
             with CUDA events: the ROIAlign forward at predict's two
             calls and training's three (box, mask, and the mask
             targets: one level, one channel), the backward at
             training's two, in float32 and bfloat16, and the
             accumulator copy on the four level shapes; then each
             kernel's calls in one training step.
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
             1344² canvas, batch 4, float32) with seeded random weights:
             6 steps of Trainer.fit over the port's DetectionLoader, the
             losses, grad_norm and step times, peak memory, and the
             three kernels' launches per step.
7. train_reference — one training step on the card against the CPU at
             SMOKE widths on a 256² canvas: losses, every gradient and
             every update, and the mask targets.

Then it prints one JSON line of kernel records, the card's name and power
limit, and, last, ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import base64
import copy
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

PHASES = ("build", "kernel", "serve", "reference", "profile", "train",
          "train_reference")

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def fpn_levels(rois: np.ndarray, n_levels: int) -> np.ndarray:
    """Level index (0 = P2) of each ROI of ``rois`` [..., 4] by the
    kernels' FPN rule over ``n_levels`` levels."""
    from eksml_tpu_torch.ops.roi_align import assign_fpn_levels

    import torch

    lv = assign_fpn_levels(torch.from_numpy(rois.reshape(-1, 4)),
                           max_level=1 + n_levels).numpy() - 2
    return lv.reshape(rois.shape[:-1])


def roi_footprint(roi: np.ndarray, out_size: int, sampling: int, hw,
                  stride: int):
    """(rows, columns) of one ROI on its level's map of size ``hw`` =
    (H, W) at ``stride``: the map rows and columns that a tap of nonzero
    weight of its samples reaches inside the map, sorted, each at most
    2·out·s long, in the kernels' float32 arithmetic.  The backward
    changes exactly the pixels rows × columns; the footprint design
    issues one reduction per such pixel and channel group."""
    x1, y1, x2, y2 = np.asarray(roi, np.float32) * np.float32(1.0 / stride)
    frac = ((np.arange(sampling, dtype=np.float32) + np.float32(0.5))
            / np.float32(sampling))
    grid = (np.arange(out_size, dtype=np.float32)[:, None]
            + frac[None, :]).reshape(-1)

    def axis(lo, hi, n):
        size = max(hi - lo, np.float32(1e-4)) / np.float32(out_size)
        v = (lo - np.float32(0.5)) + grid * size
        v0 = np.floor(v)
        w1 = v - v0
        w0 = np.float32(1.0) - w1
        pix = np.concatenate([v0[w0 != 0], (v0 + 1)[w1 != 0]])
        return np.unique(pix[(pix >= 0) & (pix <= n - 1)]).astype(np.int64)

    return axis(y1, y2, hw[0]), axis(x1, x2, hw[1])


def footprints(rois: np.ndarray, out_size: int, sampling: int, sizes,
               strides):
    """(image, level index, rows, columns) of every ROI of ``rois``
    [B, N, 4] on the levels ``sizes`` [(H, W), ...] at ``strides``."""
    levels = fpn_levels(rois, len(strides))
    return [(bi, lv, *roi_footprint(rois[bi, ri], out_size, sampling,
                                    sizes[lv], strides[lv]))
            for bi in range(rois.shape[0]) for ri in range(rois.shape[1])
            for lv in [levels[bi, ri]]]


def touched_pixels(rois: np.ndarray, out_size: int, sampling: int,
                   sizes, strides) -> int:
    """Map pixels (per channel) that the taps of a multilevel ROIAlign
    call on ``rois`` [B, N, 4] touch with nonzero weight at least once,
    counted on this data; the levels are ``sizes`` [(H, W), ...] at
    ``strides``."""
    touched = [[np.zeros(hw, bool) for hw in sizes]
               for _ in range(rois.shape[0])]
    for bi, lv, rows, cols in footprints(rois, out_size, sampling, sizes,
                                         strides):
        touched[bi][lv][np.ix_(rows, cols)] = True
    return sum(int(t.sum()) for per_b in touched for t in per_b)


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


def bytes_and_ops(rois: np.ndarray, out_size: int, sampling: int,
                  esize: int, backward: bool = False, sizes=None,
                  strides=LEVEL_STRIDES, channels: int = CHANNELS):
    """Least bytes and the operations (a multiply and an add per tap per
    channel) of one multilevel ROIAlign call on ``rois`` [B, N, 4] over
    levels ``sizes`` [(H, W), ...] at ``strides`` (default: P2..P5 of the
    canvas) with ``channels`` channels.  Forward: each map pixel the taps
    touch, read once, plus the output written once, in the map's dtype.
    Backward: the output gradient read once in its dtype, plus each
    touched accumulator pixel read and written once in float32."""
    if sizes is None:
        sizes = [(CANVAS // s, CANVAS // s) for s in strides]
    b, n = rois.shape[:2]
    pixels = touched_pixels(rois, out_size, sampling, sizes, strides)
    out_elems = b * n * out_size * out_size * channels
    if backward:
        nbytes = out_elems * esize + pixels * channels * 4 * 2
    else:
        nbytes = pixels * channels * esize + out_elems * esize
    ops = out_elems * sampling * sampling * 4 * 2
    return nbytes, ops


def bound_of(nbytes: int, ops: int):
    """(bound ms, what bounds it) on the data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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
            kernels.fwd, feats32, rng, np.random.RandomState(seed + 1)),
        kernels.bwd.name: kernel_backward(kernels, feats32, rng, gen),
        kernels.copy.name: kernel_copy(kernels.copy, feats32, gen),
    }
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


def kernel_forward(kernel, feats32, rng, mask_rng):
    """The forward kernel against ``batched_multilevel_roi_align`` at
    every call the main paths make: predict's two and training's box and
    mask calls on P2..P5 in float32 and bfloat16, and training's mask
    targets (float32, one level, one channel) on seeded masks from
    ``mask_rng``; then the sum of training's three calls in float32."""
    import torch

    dev = feats32[0].device
    n_max = max(n for _, _, n in CALLS + TRAIN_CALLS)
    rois_all = np.stack([make_rois(rng, n_max) for _ in range(BATCH)])
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        feats = tuple(f.to(dtype) for f in feats32)
        fmax = max(float(f.float().abs().max()) for f in feats)
        for path, calls in (("predict", CALLS), ("train", TRAIN_CALLS)):
            for call, out_size, n in calls:
                rois_np = np.ascontiguousarray(rois_all[:, :n])
                records.append(_forward_call(
                    kernel, path, call, feats, rois_np, LEVEL_STRIDES,
                    out_size, fmax)[0])
        del feats
    call, out_size, n = MASK_TARGETS
    masks, mrois = mask_target_inputs(mask_rng, BATCH * n)
    rec, got, want = _forward_call(
        kernel, "train", call, (torch.from_numpy(masks).to(dev),), mrois,
        (1,), out_size, 1.0)
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
                                 and r["dtype"] == "float32"]))
    return records


def _forward_call(kernel, path, call, feats, rois_np, strides, out_size,
                  scale):
    """One forward call checked against the plain version (``scale``:
    the largest feature magnitude) and timed beside it; returns the
    record and both outputs."""
    import torch

    from eksml_tpu_torch.ops.roi_align import batched_multilevel_roi_align

    dtype = feats[0].dtype
    b, n = rois_np.shape[:2]
    rois = torch.from_numpy(rois_np).to(feats[0].device)
    got = kernel(feats, rois, strides, out_size)
    want = batched_multilevel_roi_align(feats, rois, strides, out_size)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = _check(kernel.name, f"{path} {call} o={out_size} B*N={b}*{n} "
                 f"C={feats[0].shape[-1]} levels={len(feats)}", dtype, diff,
                 want.float(), scale)
    ms, lo, hi = time_repeats(lambda: kernel(feats, rois, strides,
                                             out_size), iters=20, warmup=3)
    log(f"[kernel]   median of 5 timings of 20 launches {ms:.4f} ms "
        f"(min {lo:.4f}, max {hi:.4f})")
    plain_ms = time_ms(lambda: batched_multilevel_roi_align(
        feats, rois, strides, out_size), iters=3, warmup=1)
    nbytes, ops = bytes_and_ops(
        rois_np, out_size, 2, feats[0].element_size(),
        sizes=[tuple(f.shape[1:3]) for f in feats], strides=strides,
        channels=feats[0].shape[-1])
    return (_record(path, call, dtype, out_size, b * n, err, ms, plain_ms,
                    None, nbytes, ops), got, want)


def _step_record(records):
    """One training step's calls of a kernel (``records``, float32),
    summed: the times as measured call by call, the bound from the
    summed bytes and operations."""
    total = {k: sum(r[k] for r in records)
             for k in ("ms", "plain_ms", "bytes", "ops")}
    bound_ms, bound_by = bound_of(total["bytes"], total["ops"])
    log(f"[kernel]   {STEP_CALL} ({' + '.join(r['call'] for r in records)}"
        f"): kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.3f} ms, "
        f"bound {bound_ms * 1e3:.1f} us ({total['bytes'] / 1e6:.1f} MB, "
        f"{bound_by}), {bound_ms / total['ms'] * 100:.1f}% of bound")
    return {"path": "train", "call": STEP_CALL, "dtype": "float32",
            "max_abs_err": max(r["max_abs_err"] for r in records),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            **total}


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
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and match in e.key)
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
                                backward=True)
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
        got = kernel(src)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), src.view(torch.int32))
        shape = "x".join(str(d) for d in src.shape)
        log(f"[kernel] {kernel.name} [{shape}] float32: bitwise equal to "
            f"clone() {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{kernel.name} differs from clone() at "
                                 f"[{shape}]")
        del got
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
        rec = _record("train", f"[{shape}]", torch.float32, None, None, 0.0,
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
    records.append(_record("train", STEP_CALL, torch.float32, None, None,
                           0.0, turns["kernel"], turns["clone"],
                           turns["copy_"],
                           sum(2 * s.numel() * 4 for s, _ in pairs), 0))
    del srcs, dsts, pairs
    return records


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


def phase_serve(cfg, kernels, seed: int):
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
        log(f"[serve] warmup: {warmed} shape(s) "
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
        log(f"[serve] 8 requests in {wall:.3f}s: {len(images) / wall:.3f} "
            f"images/s; latency ms min {lat[0]:.1f} median "
            f"{lat[len(lat) // 2]:.1f} max {lat[-1]:.1f}")
        log("[serve] per-request spans, median (max) ms: " + ", ".join(
            f"{k} {v[len(v) // 2]:.1f} ({v[-1]:.1f})"
            for k, v in spans.items()))
        log(f"[serve] batches dispatched {dispatched}, batch fills "
            f"{sorted(fills)}, request_path_compiles {rpc}, detections "
            f"above TEST.RESULT_SCORE_THRESH {n_valid}")
        log(f"[serve] peak torch.cuda.max_memory_allocated: warmup "
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
                        "launches": launches}
    finally:
        server.drain(timeout=60)


# ---------------------------------------------------------------------
# phase 4: the card against the CPU on a small input
# ---------------------------------------------------------------------


def phase_reference(model_gpu, seed: int, tol: float = 1e-3):
    """Same weights on the card and on the CPU, one 256² image: the FPN
    features, the ROIAlign output for the card's proposals (kernel on the
    card, plain version on the CPU) and the box-head logits agree within
    ``tol`` of each tensor's largest magnitude."""
    import torch

    from eksml_tpu_torch.ops.roi_align import dispatch_roi_align

    model_cpu = copy.deepcopy(model_gpu).cpu()
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 256, (1, 256, 256, 3))
                         .astype(np.uint8))
    hw = torch.tensor([[256.0, 200.0]])

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))

    with torch.inference_mode():
        fg = model_gpu._features(x.cuda())
        fc = model_cpu._features(x)
        errs = {f"P{i + 2}": rel(a, b) for i, (a, b) in enumerate(zip(fg, fc))}
        out = model_gpu.predict(x.cuda(), hw.cuda())
        logits, deltas = model_gpu.rpn(fg)
        anchors = model_gpu._anchors((256, 256), fg[0].device)
        boxes, _ = model_gpu._proposals(logits, deltas, anchors, hw.cuda(),
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
    log("[reference] card vs CPU, max|diff| / max|CPU|: "
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
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): an operator's own entry
    # also carries the device time of the kernels it launched
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    log(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms * 100:.1f}%), "
        f"{len(kernels)} kernel names")
    ours = ("roi_align_fwd_kernel", "roi_align_bwd_", "copy_bulk_kernel")
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


def phase_train(cfg, kernels, seed: int, extra_batches: int = 0):
    """``TRAIN_STEPS`` steps of ``Trainer.fit`` at the default config:
    step 1 (cuDNN autotune) apart from the median of the rest, peak
    memory after step 1, the kernels' launches per step, and the checks
    that the step trained what it must and froze the rest."""
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
    trainer = Trainer(cfg, logdir=".", device="cuda")
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
                "learning_rate")) + f"; {r['step_time_s'] * 1e3:.1f} ms")
    times = sorted(r["step_time_s"] for r in rows[1:])
    median = times[len(times) // 2]
    log(f"[train] step 1 (cuDNN autotune) {rows[0]['step_time_s']:.2f} s; "
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
                         "launches": launches, "launches_step1": step1}


# ---------------------------------------------------------------------
# phase 7: one training step, the card against the CPU
# ---------------------------------------------------------------------


def phase_train_reference(seed: int, img: int = 256, tol: float = 1e-4,
                          update_tol: float = 1e-3):
    """One ``make_train_step`` at SMOKE widths on an ``img``² canvas,
    batch 2, from one set of weights, one batch and one set of
    priorities on the card and on the CPU.  The losses, ``grad_norm``
    and every gradient tensor agree within ``tol`` of each tensor's
    largest magnitude; every parameter update within ``update_tol`` of
    its largest magnitude (a float32 ulp of the parameter is up to ~1e-4
    of the update at this learning rate); the mask targets agree exactly
    except at pixels whose plain value lies within 1e-6 of 0.5.  Returns
    the worst errors and the number of gradient tensors compared."""
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
        "TRAIN.WARMUP_STEPS=0", "TRAIN.BATCH_SIZE_PER_CHIP=2"])
    cfg.freeze()
    batch = make_synthetic_batch(cfg, batch_size=2, image_size=img,
                                 seed=seed, gt_mask_size=28)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()
             if k not in ("image_scale", "image_id")}
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    results = {}
    for where in ("cpu", dev):
        model = MaskRCNN.from_config(cfg)
        model.load_state_dict(params)
        model.to(where).train()
        pri = model.make_priorities(
            (2, img, img, cfg.DATA.MAX_GT_BOXES),
            torch.Generator().manual_seed(seed))
        opt, sched = make_optimizer(model, cfg)
        grads = {}
        for n, p in model.named_parameters():
            if p.requires_grad:     # the raw gradient, as backward gives it
                p.register_hook(lambda g, n=n: grads.__setitem__(
                    n, g.detach().cpu().clone()))
        metrics = make_train_step(
            model, opt, sched, float(cfg.TRAIN.GRADIENT_CLIP))(
            {k: v.to(where) for k, v in batch.items()},
            {k: v.to(where) for k, v in pri.items()}, 0)
        updates = {n: (p.detach().cpu() - params[n])
                   for n, p in model.named_parameters()}
        results[str(where)] = ({k: float(v) for k, v in metrics.items()},
                               grads, updates, model)
    (lc, gc, uc, mc), (lg, gg, ug, mg) = results["cpu"], results[str(dev)]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))

    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc}
    assert gc and set(gg) == set(gc), set(gg) ^ set(gc)
    grad_err = {n: rel(gg[n], gc[n]) for n in gc}
    upd_err = {n: rel(ug[n], uc[n]) for n in uc if uc[n].abs().max() > 0}

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
    log(f"[train_reference] card vs CPU, SMOKE widths, {img}², batch 2: "
        "losses and grad_norm max rel "
        f"{max(loss_err.values()):.2e}; gradients max "
        f"|diff|/max|CPU| {max(grad_err.values()):.2e} over {len(gc)} "
        f"tensors (worst {max(grad_err, key=grad_err.get)}); updates "
        f"{max(upd_err.values()):.2e} over {len(upd_err)} tensors; mask "
        f"targets differ at {int(differ.sum())} of {differ.numel()} pixels, "
        f"{int((differ & near).sum())} of them within 1e-6 of 0.5 "
        f"(tolerances {tol} and {update_tol})")
    assert max(loss_err.values()) <= tol, loss_err
    assert max(grad_err.values()) <= tol, {
        n: e for n, e in grad_err.items() if e > tol}
    assert max(upd_err.values()) <= update_tol, {
        n: e for n, e in upd_err.items() if e > update_tol}
    assert not (differ & ~near).any(), "mask targets differ"
    return {"losses": max(loss_err.values()),
            "gradients": max(grad_err.values()),
            "updates": max(upd_err.values()), "gradient_tensors": len(gc)}


# ---------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma list out of {PHASES} (default: all)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    phases = [s for s in args.phases.split(",") if s]
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    from eksml_tpu_torch.ops.roi_align import KERNELS

    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # the kernels build first whatever phases run
    phase_build(KERNELS)
    records = phase_kernel(KERNELS, args.seed) if "kernel" in phases else {}
    engine = serve = None
    if {"serve", "reference", "profile"} & set(phases):
        engine, serve = phase_serve(serve_config(), KERNELS, args.seed)
    if "reference" in phases:
        phase_reference(engine.model, args.seed)
    if "profile" in phases:
        phase_profile(engine, args.seed)
    if engine is not None:
        engine.close()
    train = None
    if "train" in phases:
        trainer, batches, train = phase_train(
            train_config(), KERNELS, args.seed,
            extra_batches=1 if "profile" in phases else 0)
        if "profile" in phases:
            profile_window(
                f"training step {TRAIN_STEPS + 1} at {CANVAS}x{CANVAS}, "
                f"batch {BATCH}", lambda: trainer.fit(
                    batches, TRAIN_STEPS + 1, start_step=TRAIN_STEPS))
        del trainer, batches
        torch.cuda.empty_cache()
    if "train_reference" in phases:
        phase_train_reference(args.seed)
    log(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f}s")

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
                    "train": train["launches"][k.name] if train else None},
                "max_abs_err": max(r["max_abs_err"] for r in f32),
                "figure": f"{STEP_CALL}, float32",
                "ms": main_rec["ms"],
                "plain_ms": main_rec["plain_ms"],
                "bound_ms": main_rec["bound_ms"],
                "bound_by": main_rec["bound_by"],
                "library_ms": main_rec["library_ms"],
                "library": ("dst.copy_(src)" if k is KERNELS.copy
                            else "none"),
                "shapes": recs,
            })
        print(json.dumps({"kernels": out}), flush=True)
    print(gpu_name_and_limit(), flush=True)
    if set(phases) != set(PHASES):
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
