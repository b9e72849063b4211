"""Gate fresh ladder lines against the banked ones (the port of
``tools/bench_gate.py``).

Run as::

    python -m eksml_tpu_torch.tools.bench --out NEW ...
    python -m eksml_tpu_torch.tools.bench_gate \
        --fresh 'NEW/bench_rung_*.json' --bank 'BANK/bench_rung_*.json' \
        [--max-regress-pct 10]
    python -m eksml_tpu_torch.tools.bench ... | \
        python -m eksml_tpu_torch.tools.bench_gate --fresh - --bank ...

- the **bank** is the ``--bank`` glob and nothing else (never the
  reference's ``BENCH_r*.json``, which are TPU rounds): files holding
  the ladder's lines, ``bench_rung_<rung>.json`` of ``tools/bench.py
  --out`` or the ladder's raw stdout (one ``{"metric": ...}`` line per
  rung), oldest first by modification time.
- the **fresh** lines come from ``--fresh``: a glob of such files, or
  ``-`` for stdin.
- each fresh line is paired with the banked lines of its
  ``operating_point`` and ``precision`` measured on a card of the same
  ``device_kind`` (a line of another card is never its baseline), and
  :func:`gate` (the reference's) compares it with the newest of them:
  FAIL (exit 1) when its ``step_time_ms`` exceeds the baseline's by more
  than ``--max-regress-pct``, or its throughput ``value`` drops by more.
  A fresh line without a usable measurement FAILs too.
- ``--predicted``: when the fresh input carries no usable measurement
  (no card, a ladder that did not run), gate the fresh predictions of
  ``python -m eksml_tpu_torch.tools.perf_gate --fresh-dir`` against the
  prediction bank instead, through ``perf_gate.gate_one``; the verdict's
  ``evidence_source`` says which evidence gated the change.

The reference's round bookkeeping (``BENCH_r<NN>.json`` wrappers, their
``last_good`` fallback as the trigger of ``--predicted``) has no
counterpart: the port's ladder raises instead of printing an error line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

# a usable measurement needs a positive throughput and a step time —
# the two numbers the gate compares
METRIC_LINE_RE = re.compile(r'^\s*\{"metric"')


def extract_metric_line(text: str) -> Optional[Dict]:
    """Last ``{"metric": ...}`` JSON object in ``text`` (bench.py
    prints exactly one as its final line; banked files wrap whole
    stdout)."""
    last = None
    for line in text.splitlines():
        if METRIC_LINE_RE.match(line):
            try:
                last = json.loads(line)
            except json.JSONDecodeError:
                continue
    return last


def usable_measurement(line: Optional[Dict]) -> Optional[Dict]:
    """The comparable core of a bench line: the line itself when it
    carries a real measurement, else its ``last_good`` snapshot (the
    stale-but-honest fallback bench.py emits when hardware was
    unreachable), else None."""
    if not isinstance(line, dict):
        return None

    def _ok(d: Dict) -> bool:
        # an explicit error mark wins over whatever numbers rode
        # along; both compared numbers must also be real: a
        # step_time_ms of 0 would divide the gate by zero as a baseline
        # and trivially PASS as a fresh line — "the bench crashed" must
        # fail
        return (d.get("status") != "error"
                and (d.get("value", 0) or 0) > 0
                and (d.get("step_time_ms", 0) or 0) > 0)

    if _ok(line):
        return line
    lg = line.get("last_good")
    if isinstance(lg, dict) and _ok(lg):
        return lg
    return None


def metric_lines(text: str) -> List[Dict]:
    """Every ladder line in ``text``: the JSON object of a
    ``bench_rung_*.json`` (one line, indented), a wrapper's ``tail``,
    or each ``{"metric": ...}`` line of raw ladder stdout."""
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and "metric" in doc:
        return [doc]
    if isinstance(doc, dict) and isinstance(doc.get("tail"), str):
        text = doc["tail"]
    out = []
    for line in text.splitlines():
        if METRIC_LINE_RE.match(line):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def _paths(pattern: str) -> List[str]:
    return sorted(glob.glob(pattern),
                  key=lambda p: (os.path.getmtime(p), p))


def load_lines(pattern: str) -> List[Tuple[str, Dict]]:
    """[(path, line)] for every ladder line in the files ``pattern``
    matches, oldest file first."""
    out = []
    for path in _paths(pattern):
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            continue
        out += [(path, line) for line in metric_lines(text)]
    return out


def pair_key(line: Dict) -> Tuple:
    """What a banked line must share with a fresh one to be its
    baseline: the rung, the precision and the card."""
    return (line.get("operating_point"), line.get("precision"),
            line.get("device_kind"))


def load_bank(pattern: str, fresh: Optional[Dict] = None,
              exclude: Tuple[str, ...] = ()) -> List[Tuple[str, Dict]]:
    """[(path, usable measurement)] of the banked lines, oldest first —
    only those paired with ``fresh`` (:func:`pair_key`) when given."""
    skip = {os.path.abspath(p) for p in exclude}
    out = []
    for path, line in load_lines(pattern):
        if os.path.abspath(path) in skip:
            continue
        m = usable_measurement(line)
        if m is None:
            continue
        if fresh is not None and pair_key(line) != pair_key(fresh):
            continue
        out.append((path, m))
    return out


def _pred_age_hours(rec: Dict) -> Optional[float]:
    """Hours since the prediction record's ``banked_at`` stamp; None
    when the stamp is missing or unparseable."""
    import calendar
    import time

    try:
        t = calendar.timegm(time.strptime(rec.get("banked_at", ""),
                                          "%Y-%m-%dT%H:%M:%SZ"))
    except (TypeError, ValueError):
        return None
    return (time.time() - t) / 3600.0


def gate_predicted(fresh_glob: str, bank_dir: str,
                   max_regress_pct: float,
                   max_age_hours: float = 24.0) -> Tuple[bool, Dict]:
    """Predicted-step-time gating: fresh prediction records (a
    ``perf_gate --fresh-dir`` run's output) vs the banked
    ``perf_pred_h100_*.json`` baselines, through ``perf_gate.gate_one``
    — the verdict names its evidence source so a PASS can never
    masquerade as a measurement."""
    from eksml_tpu_torch.tools.perf_gate import gate_one

    verdict: Dict = {"evidence_source": "predicted",
                     "max_regress_pct": max_regress_pct,
                     "results": []}
    fresh_paths = sorted(glob.glob(fresh_glob))
    if not fresh_paths:
        verdict["error"] = (
            f"--predicted: no fresh prediction records match "
            f"{fresh_glob!r} — run `python -m "
            "eksml_tpu_torch.tools.perf_gate --fresh-dir <dir>` first "
            "(the gate must not silently skip)")
        return False, verdict
    ok = True
    for path in fresh_paths:
        try:
            with open(path) as f:
                fresh = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            verdict["results"].append({"fresh": path,
                                       "gate": "FAIL",
                                       "error": repr(e)})
            ok = False
            continue
        # leftovers from an earlier run must not gate THIS change
        age = _pred_age_hours(fresh)
        stale = ("unkeyed" if "key" not in fresh
                 else "unstamped" if age is None
                 else f"{age:.1f}h old" if age > max_age_hours else None)
        if stale:
            verdict["results"].append({
                "fresh": path, "gate": "FAIL",
                "error": (
                    f"fresh prediction {path} is {stale} (limit "
                    f"{max_age_hours}h) — re-run `python -m "
                    "eksml_tpu_torch.tools.perf_gate --fresh-dir <dir>` "
                    "for this change")})
            ok = False
            continue
        row = gate_one(fresh, bank_dir, max_regress_pct,
                       allow_missing_baseline=False)
        verdict["results"].append(row)
        ok = ok and row["gate"] != "FAIL"
    return ok, verdict


def gate(fresh: Optional[Dict], bank: List[Tuple[str, Dict]],
         max_regress_pct: float,
         allow_missing_baseline: bool = False) -> Tuple[bool, Dict]:
    """(ok, verdict).  The baseline is the NEWEST usable banked round
    — the gate answers "did this change regress the trajectory", not
    "is this the best number ever banked" (the best-ever number is
    reported for context)."""
    verdict: Dict = {"max_regress_pct": max_regress_pct}
    fresh_m = usable_measurement(fresh)
    if fresh_m is None or fresh_m is not fresh:
        # an error line (or one only usable via last_good) is not a
        # fresh measurement of THIS change
        verdict["error"] = ("fresh bench line carries no usable "
                            "measurement (value<=0, missing "
                            "step_time_ms, or error payload)")
        verdict["fresh"] = fresh
        return False, verdict
    verdict["fresh"] = {k: fresh_m.get(k)
                        for k in ("value", "step_time_ms", "unit")}
    if not bank:
        verdict["baseline"] = None
        verdict["note"] = "no usable banked baseline"
        return allow_missing_baseline, verdict
    base_path, base = bank[-1]
    best = min(bank, key=lambda pm: pm[1]["step_time_ms"])
    verdict["baseline"] = {"path": base_path,
                           "value": base.get("value"),
                           "step_time_ms": base["step_time_ms"]}
    verdict["best_banked"] = {"path": best[0],
                              "step_time_ms": best[1]["step_time_ms"]}
    limit = float(base["step_time_ms"]) * (1 + max_regress_pct / 100.0)
    step_regress_pct = (float(fresh_m["step_time_ms"])
                        / float(base["step_time_ms"]) - 1) * 100.0
    verdict["step_time_regress_pct"] = round(step_regress_pct, 2)
    ok = float(fresh_m["step_time_ms"]) <= limit
    if not ok:
        verdict["error"] = (
            f"step_time_ms regressed {step_regress_pct:.1f}% vs "
            f"{base_path} ({fresh_m['step_time_ms']} > "
            f"{base['step_time_ms']} +{max_regress_pct}%)")
        return False, verdict
    # throughput cross-check when both sides carry it (value is
    # images/sec per card — a DROP is the regression direction)
    if (base.get("value") or 0) > 0 and (fresh_m.get("value") or 0) > 0:
        tp_drop_pct = (1 - float(fresh_m["value"])
                       / float(base["value"])) * 100.0
        verdict["throughput_drop_pct"] = round(tp_drop_pct, 2)
        if tp_drop_pct > max_regress_pct:
            verdict["error"] = (
                f"throughput dropped {tp_drop_pct:.1f}% vs "
                f"{base_path} ({fresh_m['value']} < {base['value']} "
                f"-{max_regress_pct}%)")
            return False, verdict
    return True, verdict


def gate_lines(fresh_lines: List[Tuple[str, Dict]], bank_pattern: str,
               max_regress_pct: float,
               allow_missing_baseline: bool = False) -> Tuple[bool, Dict]:
    """Every fresh line against its paired bank → (ok, verdict with one
    result per line).  No fresh line at all FAILs."""
    verdict: Dict = {"evidence_source": "measured",
                     "max_regress_pct": max_regress_pct, "results": []}
    if not fresh_lines:
        verdict["error"] = "no fresh ladder line to gate"
        return False, verdict
    exclude = tuple(p for p, _ in fresh_lines if p != "-")
    ok = True
    for path, line in fresh_lines:
        bank = load_bank(bank_pattern, fresh=line, exclude=exclude)
        good, row = gate(line, bank, max_regress_pct,
                         allow_missing_baseline)
        row.update({"operating_point": line.get("operating_point"),
                    "precision": line.get("precision"),
                    "device_kind": line.get("device_kind"),
                    "fresh_path": path,
                    "gate": "PASS" if good else "FAIL"})
        verdict["results"].append(row)
        ok = ok and good
    return ok, verdict


def main(argv=None) -> int:
    from eksml_tpu_torch.tools.perf_gate import DEFAULT_BANK

    p = argparse.ArgumentParser(
        description="gate fresh ladder lines against banked ones")
    p.add_argument("--fresh", required=True,
                   help="glob of files holding fresh ladder lines, or "
                        "'-' for stdin")
    p.add_argument("--bank", required=True,
                   help="glob of files holding the banked ladder lines")
    p.add_argument("--max-regress-pct", type=float, default=10.0,
                   help="max tolerated step-time increase (and "
                        "throughput drop) in percent [%(default)s]")
    p.add_argument("--allow-missing-baseline", action="store_true",
                   help="pass a fresh line that has no banked line of "
                        "its rung, precision and card")
    p.add_argument("--predicted", action="store_true",
                   help="when the fresh input carries no usable "
                        "measurement, gate the fresh predictions "
                        "(--pred-fresh) against the prediction bank")
    p.add_argument("--pred-fresh", default=None,
                   help="glob of fresh prediction records (a perf_gate "
                        "--fresh-dir run); required with --predicted")
    p.add_argument("--pred-bank", default=DEFAULT_BANK,
                   help="prediction-baseline dir [artifacts/h100]")
    p.add_argument("--pred-max-age-hours", type=float, default=24.0,
                   help="fresh predictions older than this FAIL as "
                        "stale [%(default)s]")
    args = p.parse_args(argv)
    if args.predicted and not args.pred_fresh:
        p.error("--predicted needs --pred-fresh")

    if args.fresh == "-":
        fresh_lines = [("-", line) for line in metric_lines(
            sys.stdin.read())]
    else:
        fresh_lines = load_lines(args.fresh)
    measured = [(path, line) for path, line in fresh_lines
                if usable_measurement(line) is line]
    if args.predicted and not measured:
        print("bench_gate: the fresh input carries no measurement — "
              "gating on PREDICTED step time (perf_gate bank), not "
              "measured evidence", file=sys.stderr)
        ok, verdict = gate_predicted(args.pred_fresh, args.pred_bank,
                                     args.max_regress_pct,
                                     max_age_hours=args
                                     .pred_max_age_hours)
    else:
        ok, verdict = gate_lines(fresh_lines, args.bank,
                                 args.max_regress_pct,
                                 args.allow_missing_baseline)
    verdict["gate"] = "PASS" if ok else "FAIL"
    print(json.dumps(verdict, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
