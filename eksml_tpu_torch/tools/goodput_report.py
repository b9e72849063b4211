"""Render the cumulative cross-restart goodput ledger of a logdir (the
port of ``tools/goodput_report.py``).

Run as::

    python -m eksml_tpu_torch.tools.goodput_report <logdir> [--host 0]
        [--out goodput.json] [--artifacts DIR]

The trainer's meter (``telemetry/goodput.py``) banks snapshots to
``goodput-host<i>.jsonl``; :func:`build_ledger` merges them with the
flight-recorder events, span traces and checkpoint-commit times into
one whole-run ledger: per-segment buckets, the recovered
between-relaunch ``downtime`` and the cumulative goodput ratio.  Beside
it, the **effective MFU**: the ideal MFU of the banked predicted step
(``perf_pred_*.json`` of ``python -m eksml_tpu_torch.tools.perf_gate``,
priced on the card's data-sheet peak) times the measured goodput ratio,
i.e. how much of the gap is schedule (badput) rather than kernel speed.

The predictions are read from ``--artifacts``, by default the logdir
itself, never the repository's ``artifacts/`` (which holds the TPU
reference's).  A prediction whose ``target`` is not a card of the
port's roofline (``profiling/predict.py`` ``CHIP_SPECS``) is refused:
the line is then a note, never a number.  Missing artifacts degrade to
notes, never errors.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from eksml_tpu_torch.fsio import atomic_write_text
from eksml_tpu_torch.profiling.predict import (CHIP_SPECS, chip_spec,
                                               load_json)


def training_predictions(artifacts_dir: str) -> list:
    """The ``perf_pred_*.json`` under ``artifacts_dir`` that price a
    TRAINING step, oldest first: the serving predictions
    (``perf_pred_*serve_*``, ``kind: predict``) price the inference
    program and are left out."""
    paths = sorted(glob.glob(os.path.join(artifacts_dir,
                                          "perf_pred_*.json")),
                   key=os.path.getmtime)
    return [p for p in paths
            if not os.path.basename(p).startswith(("perf_pred_serve_",
                                                   "perf_pred_h100_serve_"))
            and (load_json(p) or {}).get("kind") != "predict"]


def effective_mfu(goodput_ratio: float, artifacts_dir: str) -> dict:
    """Compose the newest banked training prediction for a card of the
    port's roofline with the measured goodput.

    ideal MFU = predicted-step flops / predicted step time / the card's
    peak at the prediction's precision (the MFU of a run with zero
    badput on the predicted program); effective MFU = ideal × goodput
    ratio.  A note instead when there is no such prediction."""
    preds, refused = [], []
    for path in training_predictions(artifacts_dir):
        target = (load_json(path) or {}).get("target")
        (preds if target in CHIP_SPECS else refused).append(
            (path, target))
    if not preds:
        note = (f"no perf_pred_*.json for {sorted(CHIP_SPECS)} under "
                f"{artifacts_dir} — run `python -m "
                "eksml_tpu_torch.tools.perf_gate --update-baseline "
                "--bank <dir>` to bank the card's roofline predictions")
        if refused:
            note += ("; refused (not a card of the port's roofline): "
                     + ", ".join(f"{os.path.basename(p)} ({t})"
                                 for p, t in refused))
        return {"note": note}
    path = preds[-1][0]
    try:
        rec = load_json(path)
        flops = float(rec["totals"]["flops"])
        pred_ms = float(rec["predicted_step_time_ms"])
        target = rec.get("target", "")
        precision = rec.get("precision", "float32")
        spec = chip_spec(target)
        peak = float(spec["peak_flops"].get(precision)
                     or spec["peak_flops"]["float32"])
        ideal = flops / (pred_ms / 1e3) / peak if pred_ms > 0 else 0.0
    except Exception as e:  # noqa: BLE001 — partial evidence is fine
        return {"note": f"could not price {os.path.basename(path)}: "
                        f"{e!r}"}
    return {
        "prediction": os.path.basename(path),
        "target": target,
        "precision": precision,
        "model_widths": rec.get("model_widths"),
        "ideal_mfu": round(ideal, 4),
        "goodput_ratio": round(goodput_ratio, 4),
        "effective_mfu": round(ideal * goodput_ratio, 4),
        "note": ("effective = ideal (zero-badput roofline MFU of the "
                 "banked predicted step) x measured goodput ratio — "
                 "smoke-width counts overstate ideal_mfu; compare the "
                 "ratio's effect, not absolutes"),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="a logdir's whole-run goodput ledger and effective "
                    "MFU")
    p.add_argument("logdir", help="training run directory")
    p.add_argument("--host", type=int, default=0,
                   help="host whose event stream segments the ledger "
                        "(default 0 = coordinator)")
    p.add_argument("--out", default=None,
                   help="also write the ledger JSON here (atomic)")
    p.add_argument("--artifacts", default=None,
                   help="directory of perf_pred_*.json for the "
                        "effective-MFU line (default: the logdir)")
    args = p.parse_args(argv)

    from eksml_tpu_torch.telemetry.goodput import build_ledger

    ledger = build_ledger(args.logdir, host_id=args.host)
    ledger["effective_mfu"] = effective_mfu(
        ledger.get("goodput_ratio", 0.0), args.artifacts or args.logdir)
    print(json.dumps(ledger, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        atomic_write_text(args.out, json.dumps(ledger, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
