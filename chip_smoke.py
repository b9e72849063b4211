#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``eksml_tpu_torch``) on one CUDA card.

Phases (any failure raises and exits non-zero; nothing falls back):

1. build   — compile every CUDA source of the port with nvcc (all at
             once) and print the build time and nvcc's register/spill
             summary.
2. kernel  — hold each kernel against its plain PyTorch version on the
             card at the shapes predict gives it, in float32 and
             bfloat16, and time both with CUDA events.
3. serve   — default config (R50-FPN, 81 classes, FPN 256, one 1344²
             bucket, batch rungs (1, 4), uint8 input, float32) with
             seeded random weights: start the port's ServingServer,
             warm it up, POST 8 images of mixed sizes concurrently to
             /v1/predict, and check the answers, the zero request-path
             compiles and that the ROIAlign kernel launched twice per
             dispatched batch.
4. reference — the card's forward against the same weights on the CPU
             on a small canvas (features, ROIAlign in context, box head).
5. profile — one batch-4 forward at the 1344² bucket under
             torch.profiler: device time by kernel and the device's busy
             share of the forward's wall time.

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

PHASES = ("build", "kernel", "serve", "reference", "profile")

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# predict shapes at the 1344² canvas: P2..P5 and the two ROIAlign calls
CANVAS = 1344
LEVEL_STRIDES = (4, 8, 16, 32)
CHANNELS = 256
BATCH = 4
CALLS = (("box_head", 7, 1000), ("mask_head", 14, 100))


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
    results = build.build([k.name for k in kernels])
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


def make_rois(rng: np.random.RandomState, n: int) -> np.ndarray:
    """[n, 4] xyxy boxes on the canvas: mostly log-uniform sizes, plus
    border-hugging, sub-pixel and larger-than-canvas boxes."""
    kinds = rng.choice(4, size=n, p=[0.7, 0.1, 0.1, 0.1])
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


def bytes_and_ops(rois: np.ndarray, out_size: int, sampling: int,
                  esize: int):
    """Least bytes (each feature pixel the taps touch, read once, plus
    the output written once) and the operations (a multiply and an add
    per tap per channel) of one multilevel ROIAlign call on ``rois``
    [B, N, 4], counted on this data."""
    from eksml_tpu_torch.ops.roi_align import assign_fpn_levels

    import torch

    b, n = rois.shape[:2]
    levels = (assign_fpn_levels(torch.from_numpy(rois.reshape(-1, 4)))
              .numpy() - 2).reshape(b, n)
    sizes = [CANVAS // s for s in LEVEL_STRIDES]
    touched = [[np.zeros((sz, sz), bool) for sz in sizes] for _ in range(b)]
    frac = (np.arange(sampling, dtype=np.float32) + 0.5) / sampling
    grid = (np.arange(out_size, dtype=np.float32)[:, None]
            + frac[None, :]).reshape(-1)
    for bi in range(b):
        for ri in range(n):
            lv = levels[bi, ri]
            sc = np.float32(1.0 / LEVEL_STRIDES[lv])
            x1, y1, x2, y2 = rois[bi, ri] * sc
            bh = max(y2 - y1, np.float32(1e-4)) / np.float32(out_size)
            bw = max(x2 - x1, np.float32(1e-4)) / np.float32(out_size)
            ys = np.floor(y1 - np.float32(0.5) + grid * bh)
            xs = np.floor(x1 - np.float32(0.5) + grid * bw)
            lim = sizes[lv] - 1
            rows = np.unique(np.concatenate([ys, ys + 1]))
            cols = np.unique(np.concatenate([xs, xs + 1]))
            rows = rows[(rows >= 0) & (rows <= lim)].astype(int)
            cols = cols[(cols >= 0) & (cols <= lim)].astype(int)
            if rows.size and cols.size:
                touched[bi][lv][np.ix_(rows, cols)] = True
    pixels = sum(int(t.sum()) for per_b in touched for t in per_b)
    out_elems = b * n * out_size * out_size * CHANNELS
    nbytes = pixels * CHANNELS * esize + out_elems * esize
    ops = out_elems * sampling * sampling * 4 * 2
    return nbytes, ops


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


def bf16_ulp(x):
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch

    a = x.abs().float()
    _, e = torch.frexp(a)
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    return torch.where(a == 0, torch.zeros_like(a), ulp)


def phase_kernel(kernel, seed: int):
    import torch

    from eksml_tpu_torch.ops.roi_align import batched_multilevel_roi_align

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats32 = tuple(
        torch.randn((BATCH, CANVAS // s, CANVAS // s, CHANNELS),
                    generator=gen, device=dev) for s in LEVEL_STRIDES)
    rng = np.random.RandomState(seed)
    rois_all = np.stack([make_rois(rng, max(n for _, _, n in CALLS))
                         for _ in range(BATCH)])
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        feats = tuple(f.to(dtype) for f in feats32)
        fmax = max(float(f.float().abs().max()) for f in feats)
        for call, out_size, n in CALLS:
            rois_np = np.ascontiguousarray(rois_all[:, :n])
            rois = torch.from_numpy(rois_np).to(dev)
            got = kernel(feats, rois, LEVEL_STRIDES, out_size)
            want = batched_multilevel_roi_align(feats, rois, LEVEL_STRIDES,
                                                out_size)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dtype == torch.float32:
                tol = 1e-5 * fmax
                ok = err <= tol
                tol_text = f"1e-5*max|feat| = {tol:.3g}"
            else:
                slack = 1e-5 * fmax
                ok = bool((diff <= bf16_ulp(want.float()) + slack).all())
                tol_text = "1 bf16 ulp of the plain value + 1e-5*max|feat|"
            name = str(dtype).replace("torch.", "")
            log(f"[kernel] {kernel.name} {call} o={out_size} "
                f"B*N={BATCH}*{n} {name}: max|kernel-plain| = {err:.3g} "
                f"(tolerance {tol_text}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"{kernel.name} disagrees with its plain version at "
                    f"{call} {name}: max error {err}")
            ms = time_ms(lambda: kernel(feats, rois, LEVEL_STRIDES,
                                        out_size), iters=20, warmup=3)
            plain_ms = time_ms(lambda: batched_multilevel_roi_align(
                feats, rois, LEVEL_STRIDES, out_size), iters=3, warmup=1)
            nbytes, ops = bytes_and_ops(rois_np, out_size, 2,
                                        feats[0].element_size())
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_FLOPS_PER_S * 1e3
            bound_ms = max(t_bytes, t_ops)
            log(f"[kernel]   kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                f"bound {bound_ms * 1e3:.1f} us "
                f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), "
                f"{bound_ms / ms * 100:.1f}% of bound")
            records.append({
                "call": call, "dtype": name, "out_size": out_size,
                "rois": BATCH * n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops})
    del feats32
    torch.cuda.empty_cache()
    return records


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
        for name, count in launches.items():
            assert count > 0, f"{name} never launched on the main path"
            assert count == 2 * dispatched, (
                f"{name}: {count} launches for {dispatched} batches "
                "(predict makes 2 ROIAlign calls per forward)")
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


def phase_profile(engine, seed: int, top: int = 15):
    import torch
    from torch.profiler import ProfilerActivity, profile

    bh, bw = engine.buckets[-1]
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (4, bh, bw, 3)).astype(np.uint8)
    hw = np.tile(np.asarray([[bh, bw]], np.float32), (4, 1))
    engine.infer(images, hw, len(engine.buckets) - 1, rung=4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.infer(images, hw, len(engine.buckets) - 1, rung=4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    log(f"[profile] batch-4 forward at {bh}x{bw}: wall {wall_ms:.1f} ms "
        f"(profiled), device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms * 100:.1f}%), {len(kernels)} kernel names")
    for name, ms, count in kernels[:top]:
        log(f"[profile]   {ms:8.2f} ms {ms / max(busy_ms, 1e-9) * 100:5.1f}%"
            f" x{count:<5d} {name[:90]}")


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
    from eksml_tpu_torch.ops.roi_align import dispatch_roi_align

    kernels = [dispatch_roi_align]
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # the kernels build first whatever phases run
    phase_build(kernels)
    records = phase_kernel(dispatch_roi_align, args.seed) \
        if "kernel" in phases else []
    engine = serve = None
    if {"serve", "reference", "profile"} & set(phases):
        engine, serve = phase_serve(serve_config(), kernels, args.seed)
    if "reference" in phases:
        phase_reference(engine.model, args.seed)
    if "profile" in phases:
        phase_profile(engine, args.seed)
    if engine is not None:
        engine.close()
    log(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f}s")

    if records:
        k = dispatch_roi_align
        main_rec = next(r for r in records if r["dtype"] == "float32"
                        and r["call"] == "box_head")
        line = {"kernels": [{
            "name": k.name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            # counted only in the serve phase's run of the main path
            "launches": serve["launches"][k.name] if serve else None,
            "max_abs_err": max(r["max_abs_err"] for r in records
                               if r["dtype"] == "float32"),
            "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": None,
            "library": "none",
            "kernel_ms": main_rec["ms"],
            "bound_us": main_rec["bound_ms"] * 1e3,
            "shapes": records,
        }]}
        print(json.dumps(line), flush=True)
    print(gpu_name_and_limit(), flush=True)
    if set(phases) != set(PHASES):
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
