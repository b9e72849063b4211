"""Hermetic predicted-step-time gate of the port — no card needed (the
port of ``tools/perf_gate.py``).

Run as::

    # gate (no card needed with --device cpu): the default rungs x
    # replicated, fsdp, tensor, 2d
    python -m eksml_tpu_torch.tools.perf_gate --device cpu

    # accept an intended prediction change / first-time banking
    python -m eksml_tpu_torch.tools.perf_gate --device cpu \
        --update-baseline [--rungs 128_b1,256_b1,...] [--bank artifacts/h100]

    # calibration only (no counting): the ladder's lines against their
    # own predictions
    python -m eksml_tpu_torch.tools.perf_gate --calibrate-only \
        --artifacts <python -m eksml_tpu_torch.tools.bench --out DIR>

The reference lowers its train step for a TPU and prices the compiled
HLO.  The port has no HLO: for each rung of :data:`PRED_RUNGS` it runs
one real training step at SMOKE widths (``config.SMOKE_OVERRIDES``; the
canvas and batch are the rung's) under the step counter
(``profiling/predict.py`` ``count_train_step``) and prices the count on
the H100 roofline (``predict_for_step``), the collectives from the
sharding plan (``plan_collectives``); a serving rung (``--serve``)
counts one ``model.predict`` (``count_predict_step``).  The liveness
peak (``profiling/memory.py`` ``analyze_memory``) rides every
``replicated`` and serving record; every training record carries its
``storage_per_device`` (:func:`storage_per_device`).

- **bank**: ``perf_pred_h100_<rung>_<strategy>_<precision>.json`` in
  ``--bank`` (default ``artifacts/h100/``), written by
  ``--update-baseline``; serving rungs
  ``perf_pred_h100_serve_<bucket>_b<n>_<precision>.json``.
- **gate**: a fresh prediction more than ``--max-regress-pct`` slower
  than its baseline FAILs naming the component
  (``compare_predictions``: "backbone-bwd predicted +34%"), and so does
  a peak-memory regression beyond the same bound, a peak that does not
  fit the card, or a ``2d`` record that stores no less per device than
  ``replicated``'s at the same rung.
- **calibration**: every run reports the ladder's measured steps over
  their predictions (``calibrate(calibration_points(--artifacts))``).

Strategies: ``replicated`` (DDP), ``fsdp`` (FSDP2), ``tensor`` and
``2d`` (the partition rules' DTensors), priced over the reference's
lowering mesh ``(1, fsdp_axis, model_axis)`` with ``fsdp`` sizing only
the fsdp axis, ``tensor`` only the model axis and ``2d`` both.  One
process counts the step, so every record's compute is a replica's whole
step and the strategies differ in their collectives
(``plan_collectives``).  The liveness peak of that count is not one
device's under a sharded plan, so the ``fsdp``, ``tensor`` and ``2d``
records carry no ``hbm`` peak; what each device stores between steps
(its parameter shards, their momentum, the FrozenBN statistics) comes
from the plan's layouts instead, and the reference's memory cross-gate
holds ``2d``'s below ``replicated``'s (:func:`storage_cross_rows`; the
reference compares liveness peaks).  The multi-node rungs
(``128_b1_s2``, ``128_b1_s4``) take the reference's ``2d`` inside a node
and the port's ``fsdp`` (HSDP), priced both hierarchically and as one
flat ring, and FAIL unless hierarchical is strictly faster.  Absolute milliseconds are SMOKE-width:
the gate compares ratios.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from eksml_tpu_torch.fsio import atomic_write_json, atomic_write_text

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the card the bank prices for (``predict.CHIP_SPECS``)
TARGET = "h100"
DEFAULT_BANK = os.path.join(REPO, "artifacts", TARGET)

# Rung geometries (canvas x batch, plus the knobs a rung pre-plans) —
# the reference's, so a ladder rung pairs with its prediction by name.
PRED_RUNGS: Dict[str, Dict[str, Any]] = {
    "128_b1": {"image_size": 128, "batch_size": 1},
    "256_b1": {"image_size": 256, "batch_size": 1},
    "512_b1": {"image_size": 512, "batch_size": 1},
    "512_b4": {"image_size": 512, "batch_size": 4},
    "832x1344_b4": {"pad_hw": (832, 1344), "batch_size": 4},
    "1344_b4": {"image_size": 1344, "batch_size": 4},
    "1344_b8_remat": {"image_size": 1344, "batch_size": 8,
                      "remat": True, "param_dtype": "bfloat16"},
    # multi-node rungs: 2d (the reference's) or FSDP2 inside a node, the
    # shards all-reduced across nodes; priced hierarchical and flat from
    # the same count — the rung FAILs unless hierarchical is strictly
    # faster
    "128_b1_s2": {"image_size": 128, "batch_size": 1,
                  "num_slices": 2, "strategies": ("fsdp", "2d")},
    "128_b1_s4": {"image_size": 128, "batch_size": 1,
                  "num_slices": 4, "strategies": ("fsdp", "2d")},
}

DEFAULT_RUNGS = "128_b1,256_b1,128_b1_s2,128_b1_s4"
DEFAULT_STRATEGIES = "replicated,fsdp,tensor,2d"

# Serving (bucket, batch) rungs priced by --serve: the engine's predict
# forward at SMOKE widths.
SERVE_PRED_RUNGS: Dict[str, Dict[str, Any]] = {
    "serve_128x128_b1": {"pad_hw": (128, 128), "batch_size": 1},
    "serve_128x128_b4": {"pad_hw": (128, 128), "batch_size": 4},
}

DEFAULT_SERVE_RUNGS = "serve_128x128_b1,serve_128x128_b4"


def pred_key(rung: str, strategy: str, precision: str) -> str:
    return f"{rung}_{strategy}_{precision}"


def baseline_path(bank_dir: str, key: str, target: str = TARGET) -> str:
    return os.path.join(bank_dir, f"perf_pred_{target}_{key}.json")


def _utcnow() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _load_json(path: str) -> Optional[Dict]:
    from eksml_tpu_torch.profiling.predict import load_json

    return load_json(path)


def _relpath(path: str) -> str:
    rel = os.path.relpath(path, REPO)
    return path if rel.startswith("..") else rel


def _smoke():
    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config

    cfg = config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES))
    return cfg


def _rung_config(rung: str, precision: str, config_overrides=None):
    """The ladder's config of the rung (``bench.rung_config``) over SMOKE
    widths, finalized for training (the global config is left as it
    is)."""
    from types import SimpleNamespace

    from eksml_tpu_torch.tools import bench

    spec = {"name": rung, "pad_hw": None, **PRED_RUNGS[rung]}
    args = SimpleNamespace(precision=precision, remat=False,
                           param_dtype="float32",
                           config=list(config_overrides or []))
    return bench.rung_config(_smoke(), spec, args)


def axis_widths(mesh_shape: Dict[str, Any]) -> Dict[str, int]:
    """Resolved (fsdp, model) widths of a rung's mesh — the verdict-row
    field that keeps a sharded rung from being confused with its
    siblings in the bank (same rung name, same strategy string,
    different shard widths).  A mesh with a ``slice`` axis adds a
    ``slices`` column."""
    widths = {"fsdp": int((mesh_shape or {}).get("fsdp", 1)),
              "model": int((mesh_shape or {}).get("model", 1))}
    slices = int((mesh_shape or {}).get("slice", 1))
    if slices > 1:
        widths["slices"] = slices
    return widths


def row_axis_widths(rec: Dict[str, Any]) -> Optional[Dict[str, int]]:
    """Widths for a verdict row, derived from the ``mesh_shape`` the
    record banks — None for serve records (no training mesh)."""
    if rec.get("kind") == "predict" or "mesh_shape" not in rec:
        return None
    return axis_widths(rec["mesh_shape"])


def mesh_for(strategy: str, fsdp_axis: int = 2, num_slices: int = 1,
             model_axis: int = 2) -> Dict[str, int]:
    """The mesh a strategy's collectives are priced over (the
    reference's lowering mesh): one device for ``replicated``, an
    ``fsdp_axis``-wide shard group for ``fsdp``, a ``model_axis``-wide
    one for ``tensor``, both for ``2d``, times ``num_slices`` nodes."""
    from eksml_tpu_torch.config import STRATEGIES

    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r} is not one of "
                         f"{STRATEGIES}")
    if strategy == "replicated":
        return {}
    mesh = {"data": 1,
            "fsdp": int(fsdp_axis) if strategy in ("fsdp", "2d") else 1,
            "model": int(model_axis) if strategy in ("tensor", "2d") else 1}
    if num_slices > 1:
        mesh = {"slice": int(num_slices), **mesh}
    return mesh


def count_rung(rung: str, precision: str, config_overrides=None,
               device: str = "cuda", seed: int = 0):
    """One real training step of the rung at SMOKE widths on ``device``,
    counted: → (``StepCounts``, the finalized config).  The batch, the
    weights and the sampling priorities come from ``seed`` on the host,
    so the CPU and the card count the same step."""
    from eksml_tpu_torch.data.loader import (DetectionLoader,
                                             SyntheticDataset,
                                             batch_tensors)
    from eksml_tpu_torch.device import resolve_device
    from eksml_tpu_torch.profiling import predict as P
    from eksml_tpu_torch.tools.bench import seeded_model
    from eksml_tpu_torch.train import make_optimizer, make_train_step

    device = resolve_device(device)
    cfg = _rung_config(rung, precision, config_overrides)
    spec = PRED_RUNGS[rung]
    h, w = spec.get("pad_hw") or (spec["image_size"],) * 2
    b = int(cfg.TRAIN.BATCH_SIZE_PER_CHIP)
    ds = SyntheticDataset(num_images=b, height=h, width=w,
                          num_classes=cfg.DATA.NUM_CLASSES, seed=seed)
    host = next(iter(DetectionLoader(
        ds.records(), cfg, b, seed=seed,
        with_masks=cfg.MODE_MASK).batches(1)))
    batch = {k: v.to(device) for k, v in batch_tensors(host).items()}
    h, w = (int(d) for d in batch["images"].shape[1:3])
    model = seeded_model(cfg, device, seed)
    model.train()
    optimizer, sched = make_optimizer(model, cfg)
    # the multi-tensor update torch.optim takes for the card's parameters,
    # on either device: the CPU's per-tensor default holds one parameter's
    # temporaries at a time, a lower liveness peak than the card's
    for group in optimizer.param_groups:
        group["foreach"] = True
    step = make_train_step(model, optimizer, sched,
                           float(cfg.TRAIN.GRADIENT_CLIP))
    import torch

    pri = {k: v.to(device) for k, v in model.make_priorities(
        (b, h, w, batch["gt_boxes"].shape[1]),
        torch.Generator().manual_seed(seed)).items()}
    _, counts = P.count_train_step(step, batch, pri, 0, model, optimizer)
    if "error" in counts.meta:
        raise RuntimeError(f"rung {rung}: the step counter failed: "
                           f"{counts.meta['error']}")
    counts.meta["counted_on"] = str(device)
    return counts, cfg


def _count_meta(counts) -> Dict[str, Any]:
    import torch

    return {"counted_on": counts.meta["counted_on"],
            "torch": torch.__version__, "ops": len(counts.ops)}


def storage_per_device(cfg, strategy: str,
                       mesh: Dict[str, int]) -> Dict[str, int]:
    """The bytes one device stores between steps under ``strategy`` over
    ``mesh`` (``mesh_for``): each parameter's local shard
    (``ShardingPlan.layout``'s ``local_shape``; FSDP2's padded shard
    under default ``fsdp``), the SGD momentum of each trainable one,
    which lies like its parameter, and the FrozenBN statistics, which no
    plan shards.  Counted on a meta-device model of ``cfg``."""
    import math

    import torch

    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.models.mask_rcnn import dtype_of
    from eksml_tpu_torch.parallel.sharding import ShardingPlan

    with torch.device("meta"):
        model = MaskRCNN.from_config(cfg)
    itemsize = dtype_of(str(cfg.TRAIN.PARAM_DTYPE)).itemsize
    plan = ShardingPlan(strategy, None, tuple(mesh.values()) or (1,),
                        tuple(mesh) or ("data",))
    params = optimizer = 0
    for name, p in model.named_parameters():
        local = math.prod(plan.layout(name, p.shape).local_shape)
        params += local * itemsize
        if p.requires_grad:
            optimizer += local * itemsize
    buffers = sum(b.numel() for b in model.buffers()) * itemsize
    return {"params_bytes": params, "optimizer_bytes": optimizer,
            "buffers_bytes": buffers,
            "total_bytes": params + optimizer + buffers}


def predict_rung(rung: str, strategy: str, precision: str,
                 fsdp_axis: int = 2, config_overrides=None,
                 device: str = "cuda", counted=None,
                 model_axis: int = 2) -> Dict[str, Any]:
    """Count one rung (or take ``counted``: a ``count_rung`` result of
    the same geometry) and price it under ``strategy`` on the H100
    roofline (``predict_for_step``, as the trainer's gauge and the ladder
    price) — the fresh-prediction record the gate compares and banks."""
    from eksml_tpu_torch.profiling import predict as P

    spec = PRED_RUNGS[rung]
    t0 = time.time()
    counts, cfg = counted or count_rung(rung, precision, config_overrides,
                                        device)
    # cfg wins over the flag: a --config TRAIN.PRECISION override
    # changed the counted step, and keying it as the flag's precision
    # would overwrite the wrong baseline
    precision = str(cfg.TRAIN.PRECISION)
    num_slices = int(spec.get("num_slices", 1))
    exchange = "hierarchical" if num_slices > 1 else "flat"
    mesh = mesh_for(strategy, fsdp_axis, num_slices, model_axis)
    pred = P.predict_for_step(counts, None, mesh, precision, num_slices,
                              exchange, strategy)
    rec = dict(pred)
    rec.update({
        "rung": rung,
        "key": pred_key(rung, strategy, precision),
        "strategy": strategy,
        "geometry": {"batch_size": int(cfg.TRAIN.BATCH_SIZE_PER_CHIP),
                     "image_size": spec.get("image_size"),
                     "pad_hw": spec.get("pad_hw"),
                     "remat": bool(cfg.TRAIN.REMAT),
                     "param_dtype": str(cfg.TRAIN.PARAM_DTYPE)},
        "mesh_shape": mesh,
        "storage_per_device": storage_per_device(cfg, strategy, mesh),
        # absolute ms are SMOKE-width: gate on ratios, read the
        # calibration for how far they can be trusted
        "model_widths": "smoke",
        **_count_meta(counts),
        "count_seconds": round(time.time() - t0, 1),
        "banked_at": _utcnow(),
    })
    if strategy != "replicated":
        # the count's liveness peak is a replica's whole step, not one
        # device's under this plan (the replicated record gates it)
        rec.pop("hbm", None)
    if num_slices > 1:
        # the SAME count as one flat ring at the slowest link — the
        # counterfactual the hierarchical exchange is gated against
        flat = P.predict_for_step(counts, None, mesh, precision,
                                  num_slices, "flat", strategy)
        rec.update({
            "num_slices": num_slices,
            "slice_devices": int(mesh["fsdp"]) * int(mesh["model"]),
            "exchange": exchange,
            "flat_predicted_step_time_ms":
                flat["predicted_step_time_ms"],
        })
    return rec


def _serve_rung_config(rung: str, precision: str, config_overrides=None):
    """A clone of the config at the serve rung's inference geometry and
    SMOKE widths, finalized for inference (the server's own call)."""
    from eksml_tpu_torch.config import finalize_configs

    spec = SERVE_PRED_RUNGS[rung]
    cfg = _smoke()
    cfg.TRAIN.PRECISION = precision
    cfg.PREPROC.MAX_SIZE = max(spec["pad_hw"])
    cfg.PREPROC.TEST_SHORT_EDGE_SIZE = min(spec["pad_hw"])
    cfg.TEST.EVAL_BATCH_SIZE = spec["batch_size"]
    cfg.update_args(list(config_overrides or []))
    return finalize_configs(False, cfg)


def predict_serve_rung(rung: str, precision: str, config_overrides=None,
                       device: str = "cuda",
                       seed: int = 0) -> Dict[str, Any]:
    """Count one serving (bucket, batch) rung's predict forward
    (``count_predict_step`` on seeded uint8 images) and price it on the
    H100 roofline — the per-bucket predicted-latency record."""
    import numpy as np
    import torch

    from eksml_tpu_torch.device import resolve_device
    from eksml_tpu_torch.profiling import predict as P
    from eksml_tpu_torch.tools.bench import seeded_model

    spec = SERVE_PRED_RUNGS[rung]
    cfg = _serve_rung_config(rung, precision, config_overrides)
    precision = str(cfg.TRAIN.PRECISION)
    device = resolve_device(device)
    t0 = time.time()
    model = seeded_model(cfg, device, seed).eval()
    b = spec["batch_size"]
    h, w = spec["pad_hw"]
    images = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (b, h, w, 3), dtype=np.uint8)).to(device)
    image_hw = torch.tensor([[h, w]] * b, dtype=torch.float32,
                            device=device)
    _, counts = P.count_predict_step(model, images, image_hw)
    if "error" in counts.meta:
        raise RuntimeError(f"rung {rung}: the step counter failed: "
                           f"{counts.meta['error']}")
    counts.meta["counted_on"] = str(device)
    pred = P.predict_for_step(counts, precision=precision)
    rec = dict(pred)
    rec.update({
        "rung": rung,
        "key": f"{rung}_{precision}",
        "kind": "predict",
        "geometry": {"batch_size": b, "pad_hw": list(spec["pad_hw"]),
                     "device_normalize": True},
        # the serving SLO framing of the same number: predicted device
        # time for ONE dispatched (bucket, batch) forward
        "predicted_latency_ms": pred["predicted_step_time_ms"],
        "predicted_latency_per_image_ms": round(
            pred["predicted_step_time_ms"] / b, 4),
        "model_widths": "smoke",
        **_count_meta(counts),
        "count_seconds": round(time.time() - t0, 1),
        "banked_at": _utcnow(),
    })
    return rec


def hbm_columns(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The memory verdict columns a prediction record contributes to
    its gate row — None for records without an ``hbm`` peak."""
    hbm = rec.get("hbm") or {}
    if not hbm.get("peak_hbm_bytes"):
        return None
    cap = hbm.get("capacity") or {}
    return {
        "peak_hbm_bytes": hbm["peak_hbm_bytes"],
        "headroom_bytes": cap.get("headroom_bytes"),
        "utilization_pct": cap.get("utilization_pct"),
        "fits": bool(cap.get("fits", True)),
    }


def hbm_regression_error(fresh: Dict, base: Dict,
                         max_regress_pct: float
                         ) -> Optional[str]:
    """Peak-HBM regression beyond the bound → the FAIL message naming
    the component whose live-at-peak bytes grew most; None when in
    bounds or either record has no peak."""
    fh = fresh.get("hbm") or {}
    bh = base.get("hbm") or {}
    fp, bp = fh.get("peak_hbm_bytes"), bh.get("peak_hbm_bytes")
    if not fp or not bp:
        return None
    pct = 100.0 * (float(fp) / float(bp) - 1.0)
    if pct <= max_regress_pct:
        return None
    fc = fh.get("live_at_peak_by_component") or {}
    bc = bh.get("live_at_peak_by_component") or {}
    worst = max(set(fc) | set(bc) or {"other"},
                key=lambda k: fc.get(k, 0) - bc.get(k, 0))
    return (f"predicted peak HBM regressed +{pct:.1f}% "
            f"({bp} -> {fp} bytes, bound {max_regress_pct}%); worst "
            f"component {worst}: live-at-peak {bc.get(worst, 0)} -> "
            f"{fc.get(worst, 0)} bytes")


def storage_cross_rows(fresh_records: List[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
    """The reference's sharding memory cross-gate, on what each device
    stores: at the same rung the 2d plan's bytes per device
    (``storage_per_device``) must be strictly below replicated's.  One
    verdict row per rung where this run priced both."""
    by_rung: Dict[str, Dict[str, Dict]] = {}
    for rec in fresh_records:
        rung, strat = rec.get("rung"), rec.get("strategy")
        if rung and strat in ("replicated", "2d"):
            by_rung.setdefault(rung, {})[strat] = rec
    rows: List[Dict[str, Any]] = []
    for rung in sorted(by_rung):
        pair = by_rung[rung]
        if "replicated" not in pair or "2d" not in pair:
            continue
        rp = (pair["replicated"].get("storage_per_device")
              or {}).get("total_bytes")
        dp = (pair["2d"].get("storage_per_device")
              or {}).get("total_bytes")
        if not rp or not dp:
            continue
        row: Dict[str, Any] = {
            "key": f"{rung}_storage_cross_strategy",
            "check": "2d bytes stored per device strictly below "
                     "replicated",
            "replicated_storage_bytes": rp,
            "2d_storage_bytes": dp,
            "storage_ratio_pct": round(100.0 * dp / rp, 2),
            "gate": "PASS" if dp < rp else "FAIL",
        }
        if row["gate"] == "FAIL":
            row["error"] = (
                f"at rung {rung} the 2d plan stores {dp} bytes per "
                f"device, not strictly below replicated's {rp} — "
                f"sharding stopped paying for its per-device memory plan")
        rows.append(row)
    return rows


def _row_columns(fresh: Dict[str, Any], row: Dict[str, Any]) -> None:
    """The columns every row carries: comms, shard widths, the flat
    counterfactual of a multi-node rung."""
    if fresh.get("comms_ms") is not None:
        row["comms_ms"] = fresh["comms_ms"]
    widths = row_axis_widths(fresh)
    if widths is not None:
        row["axis_widths"] = widths
    if fresh.get("flat_predicted_step_time_ms") is not None:
        row["flat_predicted_step_time_ms"] = (
            fresh["flat_predicted_step_time_ms"])


def gate_one(fresh: Dict, bank_dir: str, max_regress_pct: float,
             allow_missing_baseline: bool) -> Dict[str, Any]:
    """Fresh prediction vs its banked baseline → one result row."""
    from eksml_tpu_torch.profiling.memory import top_components
    from eksml_tpu_torch.profiling.predict import compare_predictions

    path = baseline_path(bank_dir, fresh["key"],
                         fresh.get("target", TARGET))
    base = _load_json(path)
    row: Dict[str, Any] = {
        "key": fresh["key"],
        "predicted_step_time_ms": fresh["predicted_step_time_ms"],
        "sections_ms": fresh["sections_ms"],
        "baseline_path": _relpath(path),
    }
    _row_columns(fresh, row)
    widths = row.get("axis_widths")
    flat_ms = fresh.get("flat_predicted_step_time_ms")
    if flat_ms is not None and fresh["predicted_step_time_ms"] >= flat_ms:
        # the multi-node rung's reason to exist: the hierarchical
        # exchange must be strictly faster than the same step priced as
        # one flat ring at the slowest link
        row["gate"] = "FAIL"
        row["error"] = (
            f"hierarchical exchange predicted "
            f"{fresh['predicted_step_time_ms']}ms is not strictly "
            f"faster than the flat ring between nodes ({flat_ms}ms) at "
            f"num_slices={fresh.get('num_slices')} — the exchange "
            f"pricing or the plan's collectives regressed")
        return row
    mem = hbm_columns(fresh)
    if mem is not None:
        # the capacity half needs no baseline — a rung that does not fit
        # the card FAILs naming its top live-at-peak components
        row["hbm"] = mem
        if not mem["fits"]:
            cap = (fresh["hbm"].get("capacity") or {})
            row["gate"] = "FAIL"
            row["error"] = row["hbm"]["error"] = (
                f"predicted peak HBM {mem['peak_hbm_bytes']} bytes "
                f"exceeds {fresh.get('target', '?')} capacity "
                f"{cap.get('hbm_bytes')} bytes — top live-at-peak: "
                f"{top_components(fresh['hbm'])}")
            return row
    if base is not None:
        base_widths = row_axis_widths(base)
        if (widths is not None and base_widths is not None
                and widths != base_widths):
            # pred_key leaves the widths out, so a count at another
            # --fsdp-axis lands under the SAME baseline file — comparing
            # them would be a verdict about nothing
            row["gate"] = "FAIL"
            row["baseline_axis_widths"] = base_widths
            row["error"] = (
                f"axis widths mismatch: the fresh count is priced at "
                f"{widths} but the banked baseline at {base_widths} — "
                f"pass the matching --fsdp-axis, or re-bank with "
                f"--update-baseline if the new widths are intended")
            return row
    if base is None:
        row["gate"] = "PASS" if allow_missing_baseline else "FAIL"
        row["error"] = (
            f"no banked baseline at {path} — run `python -m "
            "eksml_tpu_torch.tools.perf_gate --update-baseline` once "
            "and commit the artifact"
        ) if not allow_missing_baseline else None
        row["note"] = "missing baseline"
        return row
    ok, verdict = compare_predictions(fresh, base,
                                      max_regress_pct=max_regress_pct)
    row["gate"] = "PASS" if ok else "FAIL"
    row["verdict"] = verdict
    if not ok:
        row["error"] = verdict.get("error")
    if mem is not None and (base.get("hbm") or {}).get(
            "peak_hbm_bytes"):
        # the regression half of the memory verdict: beyond the bound
        # the row FAILs naming the component whose live-at-peak bytes
        # grew most (the time error stays primary when both regress)
        base_peak = base["hbm"]["peak_hbm_bytes"]
        row["hbm"]["baseline_peak_hbm_bytes"] = base_peak
        row["hbm"]["peak_regress_pct"] = round(
            100.0 * (float(mem["peak_hbm_bytes"]) / float(base_peak)
                     - 1.0), 2)
        mem_err = hbm_regression_error(fresh, base, max_regress_pct)
        if mem_err:
            row["gate"] = "FAIL"
            row["hbm"]["error"] = mem_err
            if not row.get("error"):
                row["error"] = mem_err
    return row


def calibration(artifacts_dir: str) -> Dict[str, Any]:
    """The ladder's measured steps under ``artifacts_dir`` against their
    own predictions (``bench_rung_*.json`` of ``tools/bench.py
    --out``)."""
    from eksml_tpu_torch.profiling.predict import (calibrate,
                                                   calibration_points)

    return calibrate(calibration_points(artifacts_dir))


def _plan(args, p) -> List[tuple]:
    if args.serve:
        rungs = [r.strip() for r in args.serve_rungs.split(",")
                 if r.strip()]
        bad = [r for r in rungs if r not in SERVE_PRED_RUNGS]
        if bad:
            p.error(f"unknown serve rung(s) {bad}; known: "
                    f"{sorted(SERVE_PRED_RUNGS)}")
        # the predict forward has no sharding strategy
        return [(rung, None) for rung in rungs]
    rungs = [r.strip() for r in args.rungs.split(",") if r.strip()]
    strategies = [s.strip() for s in args.strategies.split(",")
                  if s.strip()]
    bad = [r for r in rungs if r not in PRED_RUNGS]
    if bad:
        p.error(f"unknown rung(s) {bad}; known: {sorted(PRED_RUNGS)}")
    from eksml_tpu_torch.config import STRATEGIES

    bad = [s for s in strategies if s not in STRATEGIES]
    if bad:
        p.error(f"unknown strategy(ies) {bad}; known: {STRATEGIES}")
    # a rung may restrict its strategies (the multi-node rungs mean
    # something only over a sharded layout inside the node)
    return [(rung, strategy) for rung in rungs for strategy in strategies
            if strategy in PRED_RUNGS[rung].get("strategies", strategies)]


def run_gate(args, plan) -> tuple:
    """Count, price and bank or gate every (rung, strategy) of ``plan``
    → (ok, verdict rows, fresh records).  Rungs of one geometry share
    one count."""
    counted: Dict[tuple, Any] = {}
    rows: List[Dict[str, Any]] = []
    fresh_records: List[Dict[str, Any]] = []
    ok = True
    for rung, strategy in plan:
        print(f"perf_gate: counting {rung}"
              + (f" x {strategy}" if strategy else " (serve)")
              + f" on {args.device} ...", file=sys.stderr)
        if strategy is None:
            fresh = predict_serve_rung(rung, args.precision,
                                       config_overrides=args.config,
                                       device=args.device)
        else:
            spec = PRED_RUNGS[rung]
            geometry = (spec.get("image_size"), spec.get("pad_hw"),
                        spec["batch_size"], spec.get("remat", False),
                        spec.get("param_dtype"))
            if geometry not in counted:
                counted[geometry] = count_rung(
                    rung, args.precision, args.config, args.device)
            fresh = predict_rung(rung, strategy, args.precision,
                                 fsdp_axis=args.fsdp_axis,
                                 device=args.device,
                                 counted=counted[geometry],
                                 model_axis=args.model_axis)
        key = fresh["key"]
        fresh_records.append(fresh)
        print(f"perf_gate: {key}: predicted "
              f"{fresh['predicted_step_time_ms']:.4f}ms, "
              f"{fresh['totals']['flops']:.6g} FLOPs", file=sys.stderr)
        if args.fresh_dir:
            os.makedirs(args.fresh_dir, exist_ok=True)
            atomic_write_json(baseline_path(args.fresh_dir, key,
                                            fresh["target"]), fresh)
        if args.update_baseline:
            os.makedirs(args.bank, exist_ok=True)
            path = baseline_path(args.bank, key, fresh["target"])
            atomic_write_json(path, fresh)
            row = {"key": key, "gate": "BANKED",
                   "predicted_step_time_ms":
                       fresh["predicted_step_time_ms"],
                   "sections_ms": fresh["sections_ms"],
                   "baseline_path": _relpath(path)}
            _row_columns(fresh, row)
            mem = hbm_columns(fresh)
            if mem is not None:
                row["hbm"] = mem
        else:
            row = gate_one(fresh, args.bank, args.max_regress_pct,
                           args.allow_missing_baseline)
            ok = ok and row["gate"] != "FAIL"
        rows.append(row)
    # the memory cross-gate runs in both modes: --update-baseline must
    # never bank a violating pair
    for row in storage_cross_rows(fresh_records):
        ok = ok and row["gate"] != "FAIL"
        rows.append(row)
    return ok, rows, fresh_records


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="the port's hermetic predicted-step-time gate: count "
                    "a SMOKE-width step per rung, price it on the card's "
                    "roofline, compare with the bank")
    p.add_argument("--rungs", default=DEFAULT_RUNGS,
                   help=f"comma list of {sorted(PRED_RUNGS)} "
                        f"[%(default)s]")
    p.add_argument("--strategies", default=DEFAULT_STRATEGIES,
                   help="comma list of replicated, fsdp, tensor, 2d "
                        "[%(default)s]")
    p.add_argument("--precision", default="float32",
                   choices=["bfloat16", "float32"],
                   help="the training chart's default [%(default)s]")
    p.add_argument("--fsdp-axis", type=int, default=2,
                   help="fsdp shard group [%(default)s]")
    p.add_argument("--model-axis", type=int, default=2,
                   help="model axis of the tensor and 2d plans "
                        "[%(default)s]")
    p.add_argument("--bank", default=DEFAULT_BANK,
                   help="where perf_pred_<target>_*.json baselines live "
                        "[artifacts/h100]")
    p.add_argument("--fresh-dir", default=None,
                   help="also write the fresh predictions here (for "
                        "bench_gate --predicted)")
    p.add_argument("--artifacts", default=None,
                   help="directory of the ladder's bench_rung_*.json "
                        "for the calibration [the bank]")
    p.add_argument("--max-regress-pct", type=float, default=10.0)
    p.add_argument("--update-baseline", action="store_true",
                   help="(re)bank fresh predictions as the baseline "
                        "instead of gating against it")
    p.add_argument("--allow-missing-baseline", action="store_true")
    p.add_argument("--calibrate-only", action="store_true",
                   help="count nothing; print the calibration of the "
                        "ladder's lines in --artifacts")
    p.add_argument("--serve", action="store_true",
                   help="gate the serving predict forward per (bucket, "
                        "batch) rung instead of the train step")
    p.add_argument("--serve-rungs", default=DEFAULT_SERVE_RUNGS,
                   help=f"comma list of {sorted(SERVE_PRED_RUNGS)} "
                        f"[%(default)s]")
    p.add_argument("--device", default="cuda",
                   help="where the step is counted: cuda (default; "
                        "raises without a card) or cpu [%(default)s]")
    p.add_argument("--out", default=None,
                   help="write the verdict JSON here too")
    p.add_argument("--config", nargs="*", default=[],
                   help="KEY=VALUE overrides on top of the rung geometry")
    return p, p.parse_args(argv)


def main(argv=None) -> int:
    p, args = parse_args(argv)
    verdict: Dict[str, Any] = {
        "target": TARGET,
        "precision": args.precision,
        "max_regress_pct": args.max_regress_pct,
        "model_widths": "smoke",
        "results": [],
    }
    ok = True
    if not args.calibrate_only:
        plan = _plan(args, p)
        verdict["mode"] = "serve" if args.serve else "train"
        ok, verdict["results"], fresh = run_gate(args, plan)
        if fresh:
            # the precision that was counted (a --config override wins)
            verdict["precision"] = fresh[-1]["precision"]
    verdict["calibration"] = calibration(args.artifacts or args.bank)
    verdict["gate"] = "PASS" if ok else "FAIL"
    payload = json.dumps(verdict, indent=1)
    print(payload)
    if args.out:
        atomic_write_text(args.out, payload)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
