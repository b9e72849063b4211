"""Training throughput and MFU of the port on one card: the ladder of
``bench.py`` (the reference's, at the repository root), run as::

    python -m eksml_tpu_torch.tools.bench [--rungs 1344_b4,...]
        [--steps 20] [--warmup 3] [--precision bfloat16|float32]
        [--remat 0|1] [--param-dtype float32|bfloat16]
        [--config KEY=VALUE ...] [--device cuda] [--out DIR]

Each rung (:data:`RUNGS`, the reference's names and geometry) builds the
model from the config at its canvas and batch with seeded weights, keeps
one synthetic batch on the device, and runs the real training step
(``train.make_train_step``; the first rung, ``micro_256_b1_fwd``, the
training forward only): step 1 apart (``first_step_s``: cuDNN's autotune
of every new shape), one step counted by the roofline
(``profiling/predict.py``) among the warmup steps, then ``--steps``
timed steps, each ended on the device.  It prints one JSON line per rung
(and writes ``bench_rung_<name>.json`` under ``--out``):

- ``step_time_ms``: the median timed step (each in ``step_times_ms``);
  ``value``: images/s per GPU; ``cudnn``: the algorithm choice the rung
  ran under (``utils/compile_cache.py``);
- ``tflops_per_step``: the counted FLOPs without REMAT's recompute
  (``recompute_tflops`` apart); ``mfu``: those FLOPs per second over the
  data-sheet peak of the rung's precision, named in ``mfu_peak``;
- ``predicted_step_time_ms`` and its sections, the predicted liveness
  peak (its operation, the live set by component, the largest live
  tensors) beside ``torch.cuda.max_memory_allocated`` of the last timed
  step and the bytes allocated before it;
- the card's name and power limit (``nvidia-smi``).

``--precision`` (default bfloat16, the optimized chart's), ``--remat``
and ``--param-dtype`` apply to every rung; ``1344_b8_remat`` always
runs REMAT with bfloat16 storage, as in the reference.  Not ported, being
the TPU tunnel's: the preflight and init retries, banking into
``artifacts/``, ``vs_baseline`` against a V100, ``--roi-backend`` (the
port has one route per device).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

RUNGS = (
    {"name": "micro_256_b1_fwd", "image_size": 256, "pad_hw": None,
     "batch_size": 1, "forward_only": True, "steps": 3, "warmup": 1},
    {"name": "512_b1", "image_size": 512, "pad_hw": None,
     "batch_size": 1},
    {"name": "832x1344_b4", "image_size": 1344, "pad_hw": (832, 1344),
     "batch_size": 4},
    {"name": "1344_b4", "image_size": 1344, "pad_hw": None,
     "batch_size": 4},
    {"name": "1344_b8_remat", "image_size": 1344, "pad_hw": None,
     "batch_size": 8, "remat": True, "param_dtype": "bfloat16"},
)


def select_rungs(names: Optional[str]) -> List[Dict[str, Any]]:
    """The rungs named in the comma list ``names`` (None or empty: all),
    in ladder order; an unknown name raises."""
    if not names:
        return list(RUNGS)
    wanted = [n.strip() for n in names.split(",") if n.strip()]
    known = {r["name"] for r in RUNGS}
    bad = [n for n in wanted if n not in known]
    if not wanted or bad:
        raise ValueError(f"--rungs {names!r}: unknown rung(s) {bad} "
                         f"(known: {[r['name'] for r in RUNGS]})")
    return [r for r in RUNGS if r["name"] in wanted]


def card_name_and_limit(device) -> Optional[str]:
    """``nvidia-smi``'s ``name, power.limit`` of the card (None on the
    CPU or where nvidia-smi does not answer)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    index = device.index if device.index is not None else 0
    return out[index] if index < len(out) else None


def rung_config(base_cfg, rung: Dict[str, Any], args):
    """A clone of ``base_cfg`` at the rung's canvas, batch, precision,
    REMAT and storage, with ``--config`` applied last."""
    from eksml_tpu_torch.config import finalize_configs

    h, w = rung["pad_hw"] or (rung["image_size"],) * 2
    cfg = base_cfg.clone()
    cfg.freeze(False)
    cfg.TRAIN.PRECISION = args.precision
    cfg.TRAIN.REMAT = bool(args.remat or rung.get("remat"))
    cfg.TRAIN.PARAM_DTYPE = rung.get("param_dtype", args.param_dtype)
    cfg.TRAIN.BATCH_SIZE_PER_CHIP = rung["batch_size"]
    cfg.PREPROC.MAX_SIZE = max(h, w)
    cfg.PREPROC.TRAIN_SHORT_EDGE_SIZE = (min(h, w), min(h, w))
    cfg.PREPROC.BUCKETS = ((h, w),) if h != w else ()
    cfg.update_args(list(args.config))
    return finalize_configs(True, cfg)


def seeded_model(cfg, device, seed: int):
    """The model of ``cfg`` on ``device`` in its storage dtype, with the
    weights ``init_params`` draws from ``seed``.  The caller's global RNG
    is left as it was."""
    import torch

    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.train import cast_for_storage

    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        model = MaskRCNN.from_config(cfg)
    model = model.to(device)
    cast_for_storage(model, cfg.TRAIN.PARAM_DTYPE)
    model.load_state_dict(init_params(
        cfg, torch.Generator().manual_seed(seed)))
    return model


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rung(rung: Dict[str, Any], args, base_cfg=None,
             device=None, count: bool = True,
             ready=None) -> Dict[str, Any]:
    """One rung of the ladder on ``device`` (default ``args.device``);
    → its record (the JSON line).  ``count=False`` runs the second
    warmup step uncounted: the record then holds the measured keys only,
    none of the roofline's.  ``ready``, if given, is called once the
    batch, the model and the optimizer are on the device, just before
    step 1 (a caller that times processes one at a time holds each
    there)."""
    import numpy as np
    import torch

    from eksml_tpu_torch.config import config as global_cfg
    from eksml_tpu_torch.data.loader import (DetectionLoader,
                                             SyntheticDataset,
                                             batch_tensors)
    from eksml_tpu_torch.device import resolve_device
    from eksml_tpu_torch.profiling import predict as predict_mod
    from eksml_tpu_torch.train import make_optimizer, make_train_step
    from eksml_tpu_torch.utils.compile_cache import choose_cudnn_algorithms

    device = resolve_device(device or args.device)
    cfg = rung_config(base_cfg if base_cfg is not None else global_cfg,
                      rung, args)
    cudnn = choose_cudnn_algorithms(cfg, "train")
    h, w = rung["pad_hw"] or (rung["image_size"],) * 2
    fwd_only = bool(rung.get("forward_only"))
    steps = int(rung.get("steps") or args.steps)
    warmup = max(2, int(rung.get("warmup") or args.warmup))
    b = int(cfg.TRAIN.BATCH_SIZE_PER_CHIP)

    ds = SyntheticDataset(num_images=b, height=h, width=w,
                          num_classes=cfg.DATA.NUM_CLASSES, seed=args.seed)
    host = next(iter(DetectionLoader(
        ds.records(), cfg, b, seed=args.seed, with_masks=cfg.MODE_MASK,
        gt_mask_size=56).batches(1)))
    batch = {k: v.to(device) for k, v in batch_tensors(host).items()}
    # the canvas the config gave the batch (--config may move it)
    h, w = (int(d) for d in batch["images"].shape[1:3])
    model = seeded_model(cfg, device, args.seed)
    model.train()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    optimizer = None
    if fwd_only:
        def step(batch, priorities, _i):
            with torch.no_grad():
                return model(batch, priorities)
    else:
        optimizer, sched = make_optimizer(model, cfg)
        step = make_train_step(model, optimizer, sched,
                               float(cfg.TRAIN.GRADIENT_CLIP))

    def priorities():
        return model.make_priorities(
            (b, h, w, batch["gt_boxes"].shape[1]), gen)

    def timed(i: int):
        pri = priorities()
        _sync(device)
        t0 = time.perf_counter()
        out = step(batch, pri, i)
        _sync(device)
        return out, time.perf_counter() - t0

    if ready is not None:
        ready()
    out, first_s = timed(0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else None)
    pred = None
    if count:
        # one warmup step counted (the trainer's first-step pricing path)
        pri = priorities()
        counter = predict_mod.train_counter(model, optimizer, batch, pri)
        with counter:
            out = step(batch, pri, 1)
        if counter.error is not None:
            raise RuntimeError("the step counter failed") from counter.error
        meta = predict_mod.train_meta(model, batch)
        if fwd_only:
            meta.update(kind="forward", grad_bytes=0)
        counts = counter.counts(**meta)
        pred = predict_mod.predict_for_step(
            counts, device_kind=kind, precision=str(cfg.TRAIN.PRECISION))
    else:
        out, _ = timed(1)
    for i in range(2, warmup):
        out, _ = timed(i)
    times = []
    measured_peak = measured_before = None
    for i in range(steps):
        if device.type == "cuda" and i == steps - 1:
            torch.cuda.reset_peak_memory_stats(device)
            measured_before = int(torch.cuda.memory_allocated(device))
        out, dt = timed(warmup + i)
        times.append(dt * 1e3)
    if device.type == "cuda":
        measured_peak = int(torch.cuda.max_memory_allocated(device))
    loss = float(out["total_loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"rung {rung['name']}: non-finite loss {loss}")

    step_ms = float(np.median(times))
    precision = str(cfg.TRAIN.PRECISION)
    rec = {
        "metric": ("maskrcnn_r50fpn_fwd_microbench" if fwd_only
                   else "maskrcnn_r50fpn_train_throughput"),
        "operating_point": rung["name"],
        "value": b / (step_ms / 1e3),
        "unit": "images/sec/gpu",
        "batch_size": b,
        "image_size": [h, w],
        "precision": precision,
        "remat": bool(cfg.TRAIN.REMAT),
        "param_dtype": str(cfg.TRAIN.PARAM_DTYPE),
        "forward_only": fwd_only,
        "steps": steps,
        "warmup": warmup,
        "first_step_s": first_s,
        "step_time_ms": step_ms,
        "step_time_min_ms": min(times),
        "step_time_max_ms": max(times),
        "step_times_ms": times,
        "cudnn": cudnn["setting"],
        "loss": loss,
        "measured_peak_bytes": measured_peak,
        "measured_allocated_before_step_bytes": measured_before,
        "device": str(device),
        "device_kind": kind or "cpu",
        "card": card_name_and_limit(device),
    }
    if pred is None:
        return rec
    peak = float(predict_mod.chip_spec(pred["target"])["peak_flops"][
        precision])
    tflops = pred["model_flops"] / 1e12
    hbm = pred["hbm"]
    rec.update({
        "tflops_per_step": tflops,
        "recompute_tflops": pred["recompute_flops"] / 1e12,
        "mfu": tflops * 1e12 / (step_ms / 1e3) / peak,
        "mfu_peak": {"name": f"{pred['target']} {precision} data-sheet "
                             "peak (dense)", "flops_per_s": peak},
        "predicted_step_time_ms": pred["predicted_step_time_ms"],
        "predicted_sections_ms": pred["sections_ms"],
        "predicted_components_ms": pred["components_ms"],
        "predicted_target": pred["target"],
        "predicted_peak_hbm_bytes": hbm.get("peak_hbm_bytes"),
        "predicted_hbm_headroom_bytes": hbm["capacity"]["headroom_bytes"],
        "predicted_resident_bytes": sum(hbm["resident_bytes"].values()),
        "predicted_peak_op": hbm.get("peak_instruction"),
        "predicted_peak_component": hbm.get("peak_component"),
        "predicted_live_at_peak_bytes": hbm["live_at_peak_by_component"],
        "predicted_top_tensors": hbm["top_tensors"][:5],
    })
    return rec


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="the port's training ladder: images/s per GPU, MFU "
                    "and the roofline beside the measurement")

    def positive_int(s):
        v = int(s)
        if v < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return v

    p.add_argument("--rungs", default="",
                   help="comma list of rungs (default: all, cheapest "
                        f"first): {', '.join(r['name'] for r in RUNGS)}")
    p.add_argument("--steps", type=positive_int, default=20)
    p.add_argument("--warmup", type=positive_int, default=3,
                   help="untimed steps, step 1 and the counted one "
                        "included (at least 2)")
    p.add_argument("--precision", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--remat", type=int, nargs="?", const=1, default=0,
                   choices=(0, 1), help="TRAIN.REMAT on every rung")
    p.add_argument("--param-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", nargs="*", default=[],
                   help="KEY=VALUE overrides, applied last")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default=None,
                   help="directory for bench_rung_<name>.json")
    return p.parse_args(argv)


def main(argv=None, base_cfg=None) -> List[Dict[str, Any]]:
    """Run the selected rungs; print and return their records.  An
    unknown rung raises before anything runs; a rung that fails raises
    (the later rungs do not run)."""
    args = parse_args(argv)
    rungs = select_rungs(args.rungs)
    records = []
    for rung in rungs:
        t0 = time.perf_counter()
        rec = run_rung(rung, args, base_cfg=base_cfg)
        rec["wall_s"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        if args.out:
            from eksml_tpu_torch.fsio import atomic_write_json

            os.makedirs(args.out, exist_ok=True)
            atomic_write_json(os.path.join(
                args.out, f"bench_rung_{rung['name']}.json"), rec)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
    sys.exit(0)
