"""Render a markdown post-mortem from a run's telemetry artifacts (the
port of ``tools/run_report.py``).

Run as::

    python -m eksml_tpu_torch.tools.run_report <logdir> [--out report.md]
        [--artifacts DIR] [--attribution PATH] [--max-events 100]

The artifacts one training logdir accumulates — ``metrics.jsonl``
(run_start-segmented scalar rows), ``events-host<i>.jsonl``
(flight-recorder incident timeline), ``profile/attribution.json``
(device time by component) — answer "what happened to this run?",
but only after hand-grepping three formats across N host files.  This
tool folds them into one reviewable report:

- **Run segments**: one section per ``run_start`` header (each
  relaunch in a shared logdir is a segment) with argv, config digest,
  git sha, steps covered, loss trajectory and throughput.
- **Cross-host view**: the ``hosts/*`` aggregation columns
  (min/max/mean step time, straggler index histogram) when present.
- **Incident timeline**: every flight-recorder event across all hosts,
  time-ordered — the SIGTERM → forced save → resumable exit chain, a
  NaN streak → rollback → restore chain, quarantines, pool rebuilds,
  watchdog dumps.
- **Elastic resume**: every ``checkpoint_resharded`` event — a
  restore that crossed topologies (grow/shrink relaunch) — with its
  saved→current diff; degrades to a pointer at the
  ``RESILIENCE.ELASTIC_RESUME`` knob when the run never resharded.
- **Non-finite observations**: rows whose scalars were sanitized to
  ``null`` (the ``*_raw_repr`` satellite), i.e. exactly where the loss
  went bad.
- **Goodput**: the cumulative cross-restart wall-clock ledger
  (``telemetry/goodput.py``) — per-segment goodput/badput buckets,
  between-relaunch downtime, and the effective MFU of the banked
  roofline prediction (``goodput_report.effective_mfu``).
- **Autoscaling** and **Deployments**: the elastic operator's decision
  trail (``autoscale-host<i>.jsonl``) and the serving fleet's reloads,
  shadow scores, promotions and rollbacks (flight events).
- **Slow steps**: when the run banked span traces
  (``trace-host<i>.json``, TELEMETRY.TRACING), the cross-host merge
  names the dominant span of each outlier step — "step 412: host 3,
  1.9 s in data_wait" — via ``trace_summary.merge_host_traces``.
- **Static SPMD and concurrency cross-links**: when the logdir holds
  watchdog hang reports, the port's eksml-lint
  (``eksml_tpu_torch/analysis``) audits its tree, and each
  ``collective-order`` / ``lock-order`` / ``blocking-under-lock``
  finding is matched to the newest report: a **yes** when a function on
  the finding's root→sink chain is a stalled stack frame of the report
  (or, for ``collective-order``, names its stalled phase) — the hang
  observed live and the divergence predicted statically, joined in one
  table.
- **Modeled cost**: the attribution component table, when the run
  banked a profile.
- **Predicted vs measured**: the H100 predictions
  (``perf_pred_h100_*.json`` of ``perf_gate``) and the calibration of
  the ladder's lines (``bench_rung_*.json`` of ``tools/bench.py
  --out``: each measured step over its own prediction); then the
  predicted collectives, the predicted liveness peak, and the serving
  rounds (``serve_r<N>.json`` of ``serve_loadtest --bank``).

These read ``--artifacts``, by default the logdir itself, never the
repository's ``artifacts/`` (the TPU reference's numbers); predictions
for a target outside the port's roofline (``predict.CHIP_SPECS``) are
not read.  Missing artifacts degrade to a note, never an error — a
post-mortem tool must work on partial evidence.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

from eksml_tpu_torch.fsio import atomic_write_text
from eksml_tpu_torch.profiling.predict import (CHIP_SPECS, calibrate,
                                               calibration_points)
from eksml_tpu_torch.telemetry.goodput import BADPUT_BUCKETS, build_ledger
from eksml_tpu_torch.tools import goodput_report, trace_summary

def _read_jsonl(path: str) -> List[Dict]:
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn write from a killed process
    return rows


def load_metrics(logdir: str) -> List[List[Dict]]:
    """metrics.jsonl → list of segments, split at run_start headers.
    Rows before the first header (a pre-PR-4 logdir) form segment 0
    with a synthetic header."""
    rows = _read_jsonl(os.path.join(logdir, "metrics.jsonl"))
    segments: List[List[Dict]] = []
    for row in rows:
        if row.get("event") == "run_start" or not segments:
            if row.get("event") != "run_start":
                segments.append([{"event": "run_start",
                                  "synthetic": True}])
                segments[-1].append(row)
                continue
            segments.append([row])
        else:
            segments[-1].append(row)
    return segments


def load_events(logdir: str) -> List[Dict]:
    events = []
    for path in sorted(glob.glob(
            os.path.join(logdir, "events-host*.jsonl"))):
        events.extend(_read_jsonl(path))
    events.sort(key=lambda e: e.get("time", 0.0))
    return events


def _ts(t: Optional[float]) -> str:
    if not t:
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t))


def _fmt_num(v, digits=4) -> str:
    if v is None:
        return "null"
    if isinstance(v, float):
        return f"{v:.{digits}g}"
    return str(v)


def _segment_section(i: int, seg: List[Dict]) -> List[str]:
    header, rows = seg[0], [r for r in seg[1:] if "step" in r]
    lines = [f"### Segment {i + 1} — started {_ts(header.get('time'))}"]
    meta = []
    if header.get("synthetic"):
        meta.append("(rows predate the run_start header contract)")
    for key in ("git_sha", "config_digest", "host_count", "pid"):
        if key in header:
            meta.append(f"{key}=`{header[key]}`")
    if header.get("argv"):
        meta.append("argv=`" + " ".join(header["argv"]) + "`")
    if meta:
        lines.append("")
        lines.append("- " + "\n- ".join(meta))
    loss_rows = [r for r in rows if "total_loss" in r]
    if not loss_rows:
        lines.append("")
        lines.append("No training steps logged in this segment.")
        return lines
    steps = [r["step"] for r in loss_rows]
    finite = [r["total_loss"] for r in loss_rows
              if isinstance(r["total_loss"], (int, float))]
    ips = [r["images_per_sec"] for r in loss_rows
           if isinstance(r.get("images_per_sec"), (int, float))]
    lines += [
        "",
        f"- steps logged: {len(loss_rows)} "
        f"(step {min(steps)} → {max(steps)})",
        f"- total_loss: first {_fmt_num(loss_rows[0]['total_loss'])}, "
        f"last {_fmt_num(loss_rows[-1]['total_loss'])}"
        + (f", min {_fmt_num(min(finite))}" if finite else ""),
    ]
    if ips:
        lines.append(f"- images/sec: mean {_fmt_num(sum(ips)/len(ips))},"
                     f" last {_fmt_num(ips[-1])}")
    ckpt = [r for r in rows if "checkpoint_save_ms" in r
            and isinstance(r["checkpoint_save_ms"], (int, float))]
    if ckpt:
        lines.append(
            f"- checkpoint saves logged: {len(ckpt)} (last "
            f"{_fmt_num(ckpt[-1]['checkpoint_save_ms'], 5)} ms)")
    bad = [r for r in loss_rows if any(k.endswith("_raw_repr")
                                       for k in r)]
    if bad:
        items = ", ".join(
            f"step {r['step']}: "
            + "; ".join(f"{k[:-len('_raw_repr')]}={r[k]}"
                        for k in sorted(r) if k.endswith("_raw_repr"))
            for r in bad[:10])
        lines.append(f"- **non-finite scalar rows: {len(bad)}** "
                     f"({items}{', …' if len(bad) > 10 else ''})")
    agg = [r for r in loss_rows if "hosts/step_time_ms_max" in r]
    if agg:
        last = agg[-1]
        lines.append(
            "- cross-host (last interval): step_time_ms "
            f"min {_fmt_num(last.get('hosts/step_time_ms_min'))} / "
            f"mean {_fmt_num(last.get('hosts/step_time_ms_mean'))} / "
            f"max {_fmt_num(last.get('hosts/step_time_ms_max'))} over "
            f"{int(last.get('hosts/count', 1))} host(s)")
        lag: Dict[int, int] = {}
        for r in agg:
            lag[int(r.get("hosts/lagging", 0))] = lag.get(
                int(r.get("hosts/lagging", 0)), 0) + 1
        ranked = sorted(lag.items(), key=lambda kv: -kv[1])
        lines.append(
            "- straggler attribution: "
            + ", ".join(f"host {h} lagged {n}/{len(agg)} intervals"
                        for h, n in ranked[:3]))
    return lines


def _events_section(events: List[Dict], max_events: int) -> List[str]:
    lines = ["## Incident timeline (flight recorder)"]
    if not events:
        lines.append("")
        lines.append("No events-host*.jsonl found — either the run "
                     "predates the flight recorder or nothing "
                     "noteworthy happened.")
        return lines
    shown = events[-max_events:]
    lines += ["",
              f"{len(events)} event(s) recorded"
              + (f"; showing the last {len(shown)}"
                 if len(shown) < len(events) else "") + ":",
              "",
              "| time | host | kind | step | detail |",
              "|---|---|---|---|---|"]
    for e in shown:
        detail = ", ".join(
            f"{k}={e[k]}" for k in sorted(e)
            if k not in ("time", "host", "kind", "step"))
        lines.append(
            f"| {_ts(e.get('time'))} | {e.get('host', '-')} "
            f"| {e.get('kind', '?')} | {e.get('step', '-')} "
            f"| {detail or '-'} |")
    counts: Dict[str, int] = {}
    for e in events:
        counts[e.get("kind", "?")] = counts.get(e.get("kind", "?"), 0) + 1
    lines += ["",
              "By kind: " + ", ".join(
                  f"{k}×{n}" for k, n in sorted(counts.items(),
                                                key=lambda kv: -kv[1]))]
    return lines


def _elastic_section(events: List[Dict]) -> List[str]:
    """Topology-crossing restores (elastic resume):
    every ``checkpoint_resharded`` event with its saved→current diff,
    degrading to a pointer when the run never crossed a topology."""
    lines = ["## Elastic resume (topology changes)"]
    resharded = [e for e in events
                 if e.get("kind") == "checkpoint_resharded"]
    if not resharded:
        lines += ["", "No `checkpoint_resharded` events — every "
                      "restore (if any) matched the topology it was "
                      "saved at.  Topology-portable restore is "
                      "governed by `RESILIENCE.ELASTIC_RESUME` "
                      "(eksml_tpu_torch/utils/checkpoint.py; per-step "
                      "topology manifests under "
                      "`checkpoints/.integrity/`)."]
        return lines
    lines += ["",
              f"{len(resharded)} resharded restore(s) — the run "
              "crossed topologies and resumed in place:",
              "",
              "| time | host | step | saved -> current |",
              "|---|---|---|---|"]
    for e in resharded:
        detail = e.get("diff") or f"{e.get('saved', '?')} -> " \
                                  f"{e.get('current', '?')}"
        lines.append(
            f"| {_ts(e.get('time'))} | {e.get('host', '-')} "
            f"| {e.get('step', '-')} | {detail} |")
    # full descriptors for the LATEST crossing only — labeled as such
    # (a grow-after-shrink run has several, all in the table above)
    lines += ["",
              f"Latest crossing: saved on {resharded[-1].get('saved', '?')}; "
              f"restored onto {resharded[-1].get('current', '?')}."]
    return lines


def _slow_steps_section(logdir: str) -> List[str]:
    """Outlier steps named by their dominant span, from the merged
    per-host span traces (telemetry tracing)."""
    lines = ["## Slow steps (span tracing)"]
    try:
        merged = trace_summary.merge_host_traces(logdir)
    except FileNotFoundError:
        lines += ["", "No trace-host*.json found — enable "
                      "`TELEMETRY.TRACING.ENABLED` (or trigger a "
                      "`/debugz/profile` capture) to record span "
                      "timelines."]
        return lines
    except Exception as e:  # noqa: BLE001 — partial evidence is fine
        lines += ["", f"Could not merge span traces: {e!r}"]
        return lines
    if not merged["slow_steps"]:
        lines += ["", "Span traces present but no completed "
                      f"`{trace_summary.STEP_SPAN}` spans — capture "
                      "covered no full step."]
        return lines
    lines += ["",
              f"{merged['steps_covered']} step(s) traced across "
              f"{len(merged['hosts'])} host(s); mean step "
              f"{merged['mean_step_ms']} ms. Slowest:",
              "",
              "| step | slowest host | step ms | ×mean | "
              "dominant span | span ms |",
              "|---|---|---|---|---|---|"]
    for s in merged["slow_steps"]:
        lines.append(
            f"| {s['step']} | {s['host']} | {s['ms']} "
            f"| {s.get('vs_mean', '-')} "
            f"| {s.get('dominant_span', '-')} "
            f"| {s.get('dominant_ms', '-')} |")
    return lines


def _goodput_section(logdir: str, artifacts_dir: str) -> List[str]:
    """The cumulative cross-restart goodput ledger: per-segment bucket
    tables + the recovered between-relaunch downtime + the effective
    MFU, via the SAME ledger ``goodput_report`` renders — degrades to a
    pointer on a logdir without a ledger."""
    lines = ["## Goodput (whole-run wall-clock ledger)"]
    try:
        ledger = build_ledger(logdir)
    except Exception as e:  # noqa: BLE001 — partial evidence is fine
        lines += ["", f"Could not build the goodput ledger: {e!r}"]
        return lines
    if not ledger["segments"]:
        lines += ["", ledger.get("note", "no segments"),
                  "  (`python -m eksml_tpu_torch.tools.goodput_report "
                  "<logdir>` renders the ledger on demand; the live "
                  "meter publishes `eksml_goodput_ratio` on /metrics and "
                  "banks `goodput-host<i>.jsonl` while the run is up — "
                  "knob `TELEMETRY.GOODPUT.ENABLED`.)"]
        return lines
    lines += [
        "",
        f"{len(ledger['segments'])} segment(s) over "
        f"{_fmt_num(ledger['total_wall_s'], 6)} s wall; goodput "
        f"ratio **{ledger['goodput_ratio']}** "
        f"({_fmt_num(ledger['train_s'], 6)} s train_step; "
        f"{_fmt_num(ledger['downtime']['total_s'], 6)} s "
        "between-relaunch downtime).",
        "",
        "| segment | started | wall s | steps | mode | goodput s | "
        "top badput |",
        "|---|---|---|---|---|---|---|"]
    for seg in ledger["segments"]:
        bad = sorted(((b, seg["buckets"][b]) for b in BADPUT_BUCKETS),
                     key=lambda kv: -kv[1])
        top = ", ".join(f"{b}={v}" for b, v in bad[:3] if v > 0) or "-"
        reshard = " (resharded)" if seg.get("resharded") else ""
        lines.append(
            f"| {seg['index']}{reshard} | {_ts(seg['start'])} "
            f"| {seg['wall_s']} | {seg['steps']} | {seg['mode']} "
            f"| {seg['buckets']['train_step']} | {top} |")
    merged = ledger["buckets"]
    lines += ["", "| bucket | seconds | % of wall |", "|---|---|---|"]
    wall = ledger["total_wall_s"] or 1.0
    for b, v in sorted(merged.items(), key=lambda kv: -kv[1]):
        if v <= 0:
            continue
        lines.append(f"| {b} | {v} | {round(100 * v / wall, 2)} |")
    try:
        mfu = goodput_report.effective_mfu(ledger["goodput_ratio"],
                                           artifacts_dir)
    except Exception as e:  # noqa: BLE001 — partial evidence is fine
        mfu = {"note": f"effective-MFU unavailable: {e!r}"}
    if "effective_mfu" in mfu:
        lines += ["",
                  f"Effective MFU: **{mfu['effective_mfu']}** = "
                  f"ideal {mfu['ideal_mfu']} "
                  f"(`{mfu['prediction']}`, {mfu['target']}) × "
                  f"goodput {mfu['goodput_ratio']}."]
    else:
        lines += ["", f"Effective MFU: {mfu['note']}"]
    return lines


def _autoscale_section(logdir: str) -> List[str]:
    """The autoscaling operator's decision trail: every ``decide()`` the
    operator banked to ``autoscale-host<i>.jsonl``, with the transitions
    (and their trainer exit codes — 77 proves the forced-checkpoint
    path) tabulated and joined against the goodput ledger's
    between-relaunch downtime.  Degrades to a pointer when no operator
    ran against this logdir."""
    lines = ["## Autoscaling (operator decision trail)"]
    rows: List[Dict] = []
    for path in sorted(glob.glob(
            os.path.join(logdir, "autoscale-host*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    try:
                        rows.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # torn write from a killed operator
        except OSError:
            continue
    if not rows:
        lines += ["", "No autoscale-host*.jsonl found — no operator "
                      "ran against this logdir.  "
                      "(`python -m eksml_tpu_torch.tools.eksml_operator "
                      "--logdir <logdir> ...` banks every scale decision "
                      "here; knobs under `RESILIENCE.AUTOSCALE`.)"]
        return lines
    rows.sort(key=lambda r: r.get("time", 0.0))
    decisions = [r for r in rows if r.get("kind") == "decision"]
    actions = {a: sum(1 for d in decisions if d.get("action") == a)
               for a in ("hold", "grow", "shrink")}
    relaunches = [r for r in rows if r.get("kind") == "relaunch"]
    forced = sum(1 for r in relaunches if "exit_code" in r
                 and r["exit_code"] == 77)
    lines += [
        "",
        f"{len(decisions)} decision(s): {actions['hold']} hold, "
        f"{actions['grow']} grow, {actions['shrink']} shrink; "
        f"{len(relaunches)} relaunch(es), {forced} via the "
        "forced-checkpoint path (trainer exit 77)."]
    # the timeline keeps every transition but compresses the holds
    # (steady state is one line of counts, not hundreds of rows)
    shown = [r for r in rows if not (
        r.get("kind") == "decision" and r.get("action") == "hold")]
    if shown:
        lines += ["", "| time | kind | action | target | chips | "
                      "exit | detail |", "|---|---|---|---|---|---|"
                                         "---|"]
        for r in shown:
            detail = r.get("reason", "")
            if r.get("kind") == "relaunch" and "relaunch_gap_s" in r:
                detail = f"relaunch gap {r['relaunch_gap_s']} s"
            lines.append(
                f"| {_ts(r.get('time'))} | {r.get('kind', '-')} "
                f"| {r.get('action', '-')} | {r.get('target', '-')} "
                f"| {r.get('target_chips', '-')} "
                f"| {r.get('exit_code', '-')} | {detail} |")
    # join against the goodput ledger: what the transitions cost
    try:
        ledger = build_ledger(logdir)
        if ledger["segments"]:
            down = ledger["downtime"]["total_s"]
            lines += [
                "",
                f"The goodput ledger attributes "
                f"{_fmt_num(down, 6)} s of between-relaunch downtime "
                f"across {len(ledger['segments'])} segment(s) — the "
                "operator's transitions are the bounded, "
                "checkpointed alternative to dying at the old "
                "topology (details in the Goodput section above)."]
    except Exception as e:  # noqa: BLE001 — partial evidence is fine
        lines += ["", f"(goodput join unavailable: {e!r})"]
    return lines


_DEPLOY_KINDS = ("serve_reload", "serve_reload_rejected",
                 "canary_score", "canary_promote", "canary_rollback")


def _deployments_section(events: List[Dict]) -> List[str]:
    """The continuous-deployment trail: every hot-reload,
    rejected candidate, shadow score and promotion/rollback the
    serving fleet and its promotion controller banked to the flight
    recorder, in one timeline.  Degrades to a pointer when no serving
    fleet ran against this logdir."""
    lines = ["## Deployments (serving hot-reload / canary)"]
    rows = [e for e in events if e.get("kind") in _DEPLOY_KINDS]
    if not rows:
        lines += ["", "No serving deployment events — no hot-reload "
                      "or canary activity against this logdir.  (The "
                      "serve pods bank `serve_reload*` events to "
                      "events-host<serve-id>.jsonl; `python -m "
                      "eksml_tpu_torch.tools.eksml_operator --promote "
                      "...` banks `canary_*` verdicts and actuations.)"]
        return lines
    reloads = [e for e in rows if e.get("kind") == "serve_reload"]
    rejected = [e for e in rows if e.get("kind") == "serve_reload_rejected"]
    scores = [e for e in rows if e.get("kind") == "canary_score"]
    verdicts = {v: sum(1 for e in scores if e.get("verdict") == v)
                for v in ("promote", "rollback", "hold")}
    promotions = [e for e in rows if e.get("kind") == "canary_promote"]
    rollbacks = [e for e in rows if e.get("kind") == "canary_rollback"]
    lines += [
        "",
        f"{len(reloads)} hot-reload(s), {len(rejected)} rejected "
        f"candidate(s); {len(scores)} shadow score(s) "
        f"({verdicts['promote']} promote, {verdicts['rollback']} "
        f"rollback, {verdicts['hold']} hold verdicts) -> "
        f"{len(promotions)} promotion(s), {len(rollbacks)} "
        "rollback(s) actuated."]
    # the timeline keeps every actuation/rejection but compresses the
    # hold verdicts (a steady canary is one count, not hundreds of
    # rows)
    shown = [e for e in rows if not (
        e.get("kind") == "canary_score" and e.get("verdict") == "hold")]
    if shown:
        lines += ["", "| time | host | kind | step | detail |",
                  "|---|---|---|---|---|"]
        for e in shown:
            kind = e.get("kind", "?")
            step = e.get("step", "-")
            if kind == "serve_reload":
                detail = (f"{e.get('previous_step', '?')} -> "
                          f"{e.get('step', '?')} in "
                          f"{_fmt_num(e.get('duration_ms'))} ms "
                          f"({e.get('verification', '?')})")
            elif kind == "serve_reload_rejected":
                detail = (f"reason={e.get('reason', '?')}: "
                          f"{e.get('detail', '')}"[:120])
            elif kind == "canary_score":
                detail = (f"{e.get('verdict', '?')}: "
                          f"p99_ratio={_fmt_num(e.get('p99_ratio'))} "
                          f"err={_fmt_num(e.get('error_rate'))} "
                          f"drift={_fmt_num(e.get('drift'))}")
                step = (f"{e.get('incumbent_step', '?')}/"
                        f"{e.get('canary_step', '?')}")
            elif kind == "canary_promote":
                detail = (f"{e.get('previous_step', '?')} -> "
                          f"{e.get('step', '?')} after streak "
                          f"{e.get('streak', '?')} "
                          f"(reload_ok={e.get('reload_ok', '?')})")
            elif kind == "canary_rollback":
                detail = (f"{e.get('from_step', '?')} -> "
                          f"{e.get('to_step', '?')} "
                          f"(reload_ok={e.get('reload_ok', '?')})")
                step = e.get("to_step", "-")
            else:
                detail = "-"
            lines.append(
                f"| {_ts(e.get('time'))} | {e.get('host', '-')} "
                f"| {kind} | {step} | {detail} |")
    if rejected:
        reasons: Dict[str, int] = {}
        for e in rejected:
            reasons[e.get("reason", "?")] = reasons.get(
                e.get("reason", "?"), 0) + 1
        lines += ["",
                  "Rejections by reason: " + ", ".join(
                      f"{k}×{n}" for k, n in sorted(
                          reasons.items(), key=lambda kv: -kv[1]))
                  + " — a rejected candidate leaves the old params "
                    "serving (eksml_tpu_torch/serve/reload.py)."]
    return lines


def _attribution_section(logdir: str,
                         attribution: Optional[str]) -> List[str]:
    path = attribution or os.path.join(logdir, "profile",
                                       "attribution.json")
    lines = ["## Modeled cost by component (profile attribution)"]
    if not os.path.exists(path):
        lines += ["", f"No attribution artifact at `{path}` — run "
                      "`python -m eksml_tpu_torch.train --profile N` (or "
                      "`/debugz/profile`) to bank one."]
        return lines
    try:
        with open(path) as f:
            payload = json.load(f)
        table = payload["component_table"]["component_pct"]
    except (json.JSONDecodeError, KeyError, TypeError) as e:
        lines += ["", f"Could not parse `{path}`: {e!r}"]
        return lines
    lines += ["", "| component | modeled % |", "|---|---|"]
    for comp, pct in table.items():
        lines.append(f"| {comp} | {pct} |")
    return lines


def _hang_reports(logdir: str) -> List[str]:
    """Hang reports newest-last by mtime: the names are
    hang_report_<pid>_<fires>.txt, so a lexicographic sort is
    arbitrary across restarts (pid order) and wraps within one
    process at fires=10."""
    return sorted(glob.glob(os.path.join(logdir, "hang_report_*.txt")),
                  key=os.path.getmtime)


def _stalled_phase(report_path: str) -> Optional[str]:
    try:
        with open(report_path) as f:
            for ln in f:
                if ln.startswith("stalled phase:"):
                    return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


#: the rules the two hang cross-links read
CROSS_LINK_RULES = ("collective-order", "lock-order", "blocking-under-lock")


def _scoped_lint(rules: List[str], lint_root: Optional[str] = None):
    """The port's eksml-lint findings (incl. baselined) over
    ``<lint_root>/eksml_tpu_torch`` (default: the tree this module is
    in) scoped to *rules*, or an error string — the shared machinery of
    both cross-link sections (:func:`render_report` lints once for
    both, and only when the logdir holds hang reports)."""
    try:
        from eksml_tpu_torch.analysis import run_lint

        result = run_lint(rules=rules, repo_root=lint_root)
        return list(result.findings) + list(result.baselined), None
    except Exception as e:  # noqa: BLE001 — partial evidence is fine
        return [], f"Static analysis unavailable: {e!r}"


def _lint_once(lint_root: Optional[str] = None):
    """``lint(rules) -> (findings, error)`` over :data:`CROSS_LINK_RULES`,
    linting the tree at its first call only."""
    done: list = []

    def lint(rules: List[str]):
        if not done:
            done.append(_scoped_lint(list(CROSS_LINK_RULES), lint_root))
        found, err = done[0]
        return [f for f in found if f.rule in rules], err

    return lint


def _chain_str(fnd) -> str:
    return " → ".join(f"{c['path']}:{c['line']} {c['name']}"
                      for c in (fnd.chain or [])) or "-"


def _chain_hit(fnd, frames: List[Tuple[str, str, int]],
               phase: Optional[str] = None) -> bool:
    """Whether a stalled stack frame sits in a function on ``fnd``'s
    chain (by name or by file:line), or the chain names ``phase``."""
    funcs = {f for f, _, _ in frames}
    files_lines = {(b, n) for _, b, n in frames}
    for c in fnd.chain or []:
        name = c.get("name", "")
        if phase and phase in name:
            return True
        if any(w.rsplit(".", 1)[-1].rstrip("()") in funcs
               for w in name.split()) or (
                os.path.basename(c.get("path", "")),
                c.get("line")) in files_lines:
            return True
    return False


def _hang_static_section(logdir: str, lint=None) -> List[str]:
    """Cross-link a watchdog hang report to a matching static
    ``collective-order`` finding of the port's eksml-lint.  The finding
    and the hang are the same bug: a rank-divergent path into (or
    around) a ``torch.distributed`` collective.  When a function on a
    finding's root→collective chain is one of the report's stalled
    stack frames, or names its stalled phase, the report says so —
    post-mortem and prevention joined in one table."""
    lines = ["## Static SPMD cross-link (watchdog ↔ eksml-lint)"]
    reports = _hang_reports(logdir)
    if not reports:
        lines += ["", "No watchdog hang reports in this logdir — "
                      "nothing to cross-link.  (`python -m "
                      "eksml_tpu_torch.tools.eksml_lint --rules "
                      "collective-order --json` audits the tree on "
                      "demand.)"]
        return lines
    phase = _stalled_phase(reports[-1])
    frames = _stalled_stack_frames(reports[-1])
    lines += ["", f"{len(reports)} hang report(s); newest "
                  f"`{os.path.basename(reports[-1])}` stalled in "
                  f"phase `{phase or '?'}`."]
    findings, err = (lint or _lint_once())(["collective-order"])
    if err:
        lines += ["", err]
        return lines
    if not findings:
        lines += ["", "No static `collective-order` findings in the "
                      "tree — this hang is not the statically-"
                      "checkable divergence class (look at the "
                      "stalled phase's stack in the report; a "
                      "data-dependent skip or an external peer death "
                      "are the usual suspects)."]
        return lines
    lines += ["", "| finding | chain | matches stalled phase or stack |",
              "|---|---|---|"]
    for fnd in findings:
        hit = _chain_hit(fnd, frames, phase)
        lines.append(f"| {fnd.path}:{fnd.line} "
                     f"| {_chain_str(fnd)} "
                     f"| {'**yes**' if hit else 'no'} |")
    return lines


def _stalled_stack_frames(report_path: str) -> List[Tuple[str, str, int]]:
    """(function, file-basename, line) frames from a hang report's
    all-thread stack section (``format_thread_stacks`` output:
    ``File "<path>", line N, in <func>`` pairs under ``--- thread``
    headers)."""
    frames: List[Tuple[str, str, int]] = []
    frame_re = re.compile(
        r'File "(?P<path>[^"]+)", line (?P<line>\d+), '
        r'in (?P<func>\S+)')
    try:
        with open(report_path) as f:
            for ln in f:
                m = frame_re.search(ln)
                if m:
                    frames.append((m.group("func"),
                                   os.path.basename(m.group("path")),
                                   int(m.group("line"))))
    except OSError:
        pass
    return frames


def _concurrency_section(logdir: str, lint=None) -> List[str]:
    """Cross-link a watchdog hang report's stalled THREAD STACKS to a
    matching ``lock-order``/``blocking-under-lock`` finding of the
    port's eksml-lint — the thread-topology companion of the SPMD
    cross-link above.  A hang whose stacks sit inside a function named
    by a concurrency finding's chain is the statically-predicted
    deadlock observed live.  Degrades to a pointer with no reports, and
    to an explicit "not this class" note with a clean tree."""
    lines = ["## Concurrency cross-link (watchdog ↔ eksml-lint v3)"]
    reports = _hang_reports(logdir)
    if not reports:
        lines += ["", "No watchdog hang reports in this logdir — "
                      "nothing to cross-link.  (`python -m "
                      "eksml_tpu_torch.tools.eksml_lint --rules "
                      "lock-order,blocking-under-lock --json` audits "
                      "the tree's thread topology on demand.)"]
        return lines
    frames = _stalled_stack_frames(reports[-1])
    lines += ["", f"{len(reports)} hang report(s); newest "
                  f"`{os.path.basename(reports[-1])}` carries "
                  f"{len(frames)} stalled stack frame(s)."]
    if frames:
        lines += ["", "Innermost stalled frames: " + ", ".join(
            f"`{func}` ({base}:{line})"
            for func, base, line in frames[-5:])]
    findings, err = (lint or _lint_once())(["lock-order",
                                             "blocking-under-lock"])
    if err:
        lines += ["", err]
        return lines
    if not findings:
        lines += ["", "No static `lock-order`/`blocking-under-lock` "
                      "findings in the tree — this hang is not the "
                      "statically-checkable thread-topology class "
                      "(check the stalled stacks against the data-"
                      "pipeline section; an external peer or a "
                      "wedged collective are the usual suspects)."]
        return lines
    lines += ["", "| finding | chain | matches stalled stack |",
              "|---|---|---|"]
    for fnd in findings:
        hit = _chain_hit(fnd, frames)
        rule = getattr(fnd, "rule", "?")
        lines.append(f"| {rule}: {fnd.path}:{fnd.line} "
                     f"| {_chain_str(fnd)} "
                     f"| {'**yes**' if hit else 'no'} |")
    return lines


def _predictions(artifacts_dir: str, serve: Optional[bool] = False
                 ) -> List[str]:
    """The banked predictions under ``artifacts_dir`` for the cards of
    the port's roofline (``perf_pred_<target>_*.json``): training ones
    (``serve=False``), serving ones (``True``) or both (``None``)."""
    paths = sorted(p for target in sorted(CHIP_SPECS)
                   for p in glob.glob(os.path.join(
                       artifacts_dir, f"perf_pred_{target}_*.json")))
    if serve is None:
        return paths
    return [p for p in paths
            if ("_serve_" in os.path.basename(p)) == serve]


def _serving_section(artifacts_dir: str) -> List[str]:
    """Serving latency/throughput from the banked load-test rounds
    (``serve_r<N>.json``, ``serve_loadtest --bank``) plus the
    span-derived slowest-request attribution the load generator
    recorded — degrades to a pointer when none is banked."""
    lines = ["## Serving (load-tested latency / throughput)"]
    numbered = []
    for p in glob.glob(os.path.join(artifacts_dir, "serve_r*.json")):
        m = re.match(r"serve_r(\d+)\.json$", os.path.basename(p))
        if m:  # stray serve_r*.json names degrade to ignored, never
            numbered.append((int(m.group(1)), p))  # crash the report
    paths = [p for _, p in sorted(numbered)]
    if not paths:
        lines += ["", "No `serve_r<N>.json` artifacts in "
                      f"`{artifacts_dir}` — start the server "
                      "(`python -m eksml_tpu_torch.serve`) and bank a "
                      "round with `python -m "
                      "eksml_tpu_torch.tools.serve_loadtest --bank`."]
        lines.extend(_serve_predicted_lines(artifacts_dir))
        return lines
    lines += ["",
              f"{len(paths)} banked round(s):", "",
              "| round | mode | req | conc | p50 ms | p99 ms | "
              "img/s | img/s/chip | occupancy | compiles after "
              "warmup |",
              "|---|---|---|---|---|---|---|---|---|---|"]
    latest = None
    for path in paths:
        try:
            with open(path) as f:
                rec = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            lines.append(f"| {os.path.basename(path)} | "
                         f"unreadable: {e!r} | | | | | | | | |")
            continue
        latest = rec
        lat = rec.get("latency_ms", {})
        rpc = (rec.get("engine") or {}).get("request_path_compiles")
        lines.append(
            f"| {os.path.basename(path)} | {rec.get('mode', '-')} "
            f"| {rec.get('completed', '-')} "
            f"| {rec.get('concurrency', '-')} "
            f"| {lat.get('p50', '-')} | {lat.get('p99', '-')} "
            f"| {rec.get('images_per_sec', '-')} "
            f"| {rec.get('images_per_sec_per_chip', '-')} "
            f"| {rec.get('batch_occupancy_mean', '-')} "
            f"| {'**' + str(rpc) + '**' if rpc else rpc} |")
    if latest is None:
        return lines
    phases = latest.get("phase_ms", {})
    if phases:
        lines += ["", "Latest round's phase attribution "
                      "(span-derived, per request):", "",
                  "| phase | mean ms | p99 ms |", "|---|---|---|"]
        for ph in ("queue_wait", "pad", "device_infer",
                   "postprocess"):
            row = phases.get(ph) or {}
            lines.append(f"| {ph} | {row.get('mean', '-')} "
                         f"| {row.get('p99', '-')} |")
    slowest = latest.get("slowest") or ()
    if slowest:
        lines += ["", "Slowest requests (dominant span named — the "
                      "tail is attributable, not a bare number):", "",
                  "| req | total ms | dominant span | queue_wait | "
                  "device_infer | bucket | fill/rung |",
                  "|---|---|---|---|---|---|---|"]
        for s in slowest[:5]:
            ph = s.get("phases", {})
            bucket = s.get("bucket")
            lines.append(
                f"| {s.get('idx', '-')} "
                f"| {round(s.get('total_ms', 0), 1)} "
                f"| **{s.get('dominant_phase', '-')}** "
                f"| {ph.get('queue_wait', '-')} "
                f"| {ph.get('device_infer', '-')} "
                f"| {'x'.join(str(b) for b in bucket) if bucket else '-'} "
                f"| {s.get('batch_fill', '-')}/"
                f"{s.get('batch_rung', '-')} |")
    lines.extend(_serve_predicted_lines(artifacts_dir))
    return lines


def _serve_predicted_lines(artifacts_dir: str) -> List[str]:
    """The per-bucket predicted-latency bank (``perf_pred_h100_serve_*``,
    ``perf_gate --serve``) — rendered under Serving, NOT in the
    train-step table (an inference step has no bwd/comms/optimizer)."""
    preds = _predictions(artifacts_dir, serve=True)
    if not preds:
        return []
    lines = ["", "Predicted device latency per (bucket, batch) rung "
                 "(`perf_gate --serve`, smoke widths — ratios, not "
                 "absolutes):", "",
             "| key | predicted ms | per image ms |", "|---|---|---|"]
    for path in preds:
        try:
            with open(path) as f:
                rec = json.load(f)
            lines.append(
                f"| {rec.get('key', os.path.basename(path))} "
                f"| {rec.get('predicted_latency_ms', '-')} "
                f"| {rec.get('predicted_latency_per_image_ms', '-')}"
                " |")
        except (json.JSONDecodeError, OSError) as e:
            lines.append(f"| {os.path.basename(path)} "
                         f"| unreadable: {e!r} | |")
    return lines


def _predicted_section(artifacts_dir: str) -> List[str]:
    """The banked H100 predictions and the ladder's measured steps over
    their own predictions (the calibration), degrading to a pointer
    when the directory holds neither."""
    lines = ["## Predicted vs measured step time (perf gate)"]
    preds = _predictions(artifacts_dir)
    try:
        cal = calibrate(calibration_points(artifacts_dir))
    except Exception as e:  # noqa: BLE001 — partial evidence is fine
        cal = {"points": [], "error": repr(e)}
    if not preds and not cal["points"]:
        lines += ["", "No `perf_pred_h100_*.json` prediction and no "
                      f"ladder line (`bench_rung_*.json`) in "
                      f"`{artifacts_dir}` — run `python -m "
                      "eksml_tpu_torch.tools.perf_gate --update-baseline "
                      "--bank <dir>` to bank the hermetic roofline "
                      "predictions, and `python -m "
                      "eksml_tpu_torch.tools.bench --out <dir>` on the "
                      "card for measured steps beside their predictions."]
        if cal.get("error"):
            lines += ["", f"Calibration unavailable: {cal['error']}"]
        return lines
    if preds:
        lines += ["",
                  f"{len(preds)} banked prediction(s) (smoke-width "
                  "counts — compare ratios, not absolutes):", "",
                  "| key | predicted ms | fwd | bwd | comms | "
                  "optimizer |",
                  "|---|---|---|---|---|---|"]
        for path in preds:
            try:
                with open(path) as f:
                    rec = json.load(f)
                s = rec.get("sections_ms", {})
                lines.append(
                    f"| {rec.get('key', os.path.basename(path))} "
                    f"| {_fmt_num(rec.get('predicted_step_time_ms'))} "
                    f"| {_fmt_num(s.get('fwd'))} "
                    f"| {_fmt_num(s.get('bwd'))} "
                    f"| {_fmt_num(s.get('comms'))} "
                    f"| {_fmt_num(s.get('optimizer'))} |")
            except (json.JSONDecodeError, OSError) as e:
                lines.append(f"| {os.path.basename(path)} | "
                             f"unreadable: {e!r} | | | | |")
    else:
        lines += ["", "No banked `perf_pred_h100_*.json` in "
                      f"`{artifacts_dir}` — `python -m "
                      "eksml_tpu_torch.tools.perf_gate --update-baseline "
                      "--bank <dir>` banks them."]
    if not cal["points"]:
        lines += ["", "No measured-vs-predicted calibration pairs "
                      "yet — `python -m eksml_tpu_torch.tools.bench "
                      "--out <dir>` on the card writes each measured "
                      "step beside its prediction."]
        return lines
    lines += ["",
              f"Calibration over {cal['n_points']} ladder line(s) "
              f"measured on the card (each against the prediction of "
              f"its own step): scale {cal['scale']}x, model error "
              f"{cal['model_error_pct']}% (max per-line deviation "
              "from the common fit):", "",
              "| rung | line | measured ms | predicted ms | scale | "
              "deviation |",
              "|---|---|---|---|---|---|"]
    for pt in cal["points"]:
        lines.append(
            f"| {pt['rung']} | {pt['measured_source']} "
            f"| {pt['measured_ms']} | {pt['predicted_ms']} "
            f"| {pt['scale']} | {pt['deviation_pct']}% |")
    return lines


def _comms_section(artifacts_dir: str) -> List[str]:
    """Per-link totals and the top exposed collectives from the
    per-collective ledgers banked inside the training predictions —
    degrading to a pointer when none carries a ledger."""
    lines = ["## Communication (predicted per-collective ledger)"]
    recs = []
    for path in _predictions(artifacts_dir):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        if rec.get("comms_ms") and rec.get("collectives"):
            recs.append((rec.get("key", os.path.basename(path)), rec))
    if not recs:
        lines += ["", "No banked prediction carries a per-collective "
                      f"ledger in `{artifacts_dir}` — run `python -m "
                      "eksml_tpu_torch.tools.perf_gate --update-baseline "
                      "--bank <dir>` to bank the plan's collectives."]
        return lines
    lines += ["",
              "Per-link predicted collective time per banked rung (the "
              "sharding plan's collectives; ici = NVLink inside a "
              "node, dcn = the network between nodes; every "
              "collective priced exposed):", "",
              "| key | ici ms | dcn ms | exposed ms | exposed dcn "
              "ms |", "|---|---|---|---|---|"]
    for key, rec in recs:
        c = rec["comms_ms"]
        lines.append(
            f"| {key} | {_fmt_num(c.get('ici_ms'))} "
            f"| {_fmt_num(c.get('dcn_ms'))} "
            f"| {_fmt_num(c.get('exposed_ms'))} "
            f"| {_fmt_num(c.get('exposed_dcn_ms'))} |")
    top = []
    for key, rec in recs:
        for row in rec["collectives"]:
            if row.get("exposed_ms", 0) > 0:
                top.append((key, row))
    top.sort(key=lambda kr: -kr[1]["exposed_ms"])
    if top:
        lines += ["", "Top exposed collectives (worst first):", "",
                  "| key | collective | opcode | component | link | "
                  "group | bytes | predicted ms | exposed ms |",
                  "|---|---|---|---|---|---|---|---|---|"]
        for key, row in top[:8]:
            lines.append(
                f"| {key} | {row.get('name', '-')} "
                f"| {row.get('opcode', '-')} "
                f"| {row.get('component', '-')} "
                f"| {row.get('link', '-')} "
                f"| {row.get('num_groups', '-')}x"
                f"{row.get('group_size', '-')} "
                f"| {row.get('bytes', '-')} "
                f"| {_fmt_num(row.get('predicted_ms'))} "
                f"| {_fmt_num(row.get('exposed_ms'))} |")
    return lines


def _memory_section(artifacts_dir: str) -> List[str]:
    """Liveness-predicted peak memory per banked rung with capacity
    headroom and the top live-at-peak components — degrading to a
    pointer when no banked prediction carries an ``hbm`` section.
    Includes the serve rungs."""
    lines = ["## Memory (predicted peak HBM, liveness model)"]
    recs = []
    for path in _predictions(artifacts_dir, serve=None):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        if (rec.get("hbm") or {}).get("peak_hbm_bytes"):
            recs.append((rec.get("key", os.path.basename(path)), rec))
    if not recs:
        lines += ["", "No banked prediction carries an `hbm` section "
                      f"in `{artifacts_dir}` — run `python -m "
                      "eksml_tpu_torch.tools.perf_gate --update-baseline "
                      "--bank <dir>` to bank liveness-based peak-memory "
                      "predictions."]
        return lines
    lines += ["",
              "Liveness-predicted peak memory per banked rung (every "
              "storage the counted step allocates, from its producer "
              "to its release; the caching allocator's blocks are not "
              "modelled):", "",
              "| key | peak MB | capacity MB | headroom MB | util % | "
              "top live-at-peak |", "|---|---|---|---|---|---|"]
    for key, rec in recs:
        h = rec["hbm"]
        cap = h.get("capacity") or {}
        comps = h.get("live_at_peak_by_component") or {}
        top = ", ".join(f"{k} {v / 1e6:.1f}MB"
                        for k, v in list(comps.items())[:3])
        lines.append(
            f"| {key} | {h['peak_hbm_bytes'] / 1e6:.1f} "
            f"| {cap.get('hbm_bytes', 0) / 1e6:.0f} "
            f"| {cap.get('headroom_bytes', 0) / 1e6:.1f} "
            f"| {_fmt_num(cap.get('utilization_pct'))} "
            f"| {top or '-'} |")
    return lines


def render_report(logdir: str, attribution: Optional[str] = None,
                  max_events: int = 100,
                  artifacts_dir: Optional[str] = None,
                  lint_root: Optional[str] = None) -> str:
    """The report of ``logdir``; predictions, ladder lines and serving
    rounds are read from ``artifacts_dir`` (default: the logdir); the
    hang cross-links lint ``<lint_root>/eksml_tpu_torch`` (default: the
    tree this module is in)."""
    artifacts_dir = artifacts_dir or logdir
    lint = _lint_once(lint_root)
    segments = load_metrics(logdir)
    events = load_events(logdir)
    lines = [f"# Run report — `{logdir}`", "",
             f"Generated {_ts(time.time())} by "
             "eksml_tpu_torch/tools/run_report.py.",
             "", "## Run segments"]
    if not segments:
        lines += ["", "No metrics.jsonl found — nothing was logged "
                      "(or the logdir path is wrong)."]
    for i, seg in enumerate(segments):
        lines.append("")
        lines.extend(_segment_section(i, seg))
    for section in (
            _events_section(events, max_events),
            _elastic_section(events),
            _goodput_section(logdir, artifacts_dir),
            _autoscale_section(logdir),
            _deployments_section(events),
            _slow_steps_section(logdir),
            _hang_static_section(logdir, lint),
            _concurrency_section(logdir, lint),
            _attribution_section(logdir, attribution),
            _predicted_section(artifacts_dir),
            _comms_section(artifacts_dir),
            _memory_section(artifacts_dir),
            _serving_section(artifacts_dir)):
        lines.append("")
        lines.extend(section)
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="a markdown post-mortem of a training logdir")
    p.add_argument("logdir", help="training run directory")
    p.add_argument("--out", default=None,
                   help="write the report here (default: stdout)")
    p.add_argument("--attribution", default=None,
                   help="attribution.json path (default: "
                        "<logdir>/profile/attribution.json)")
    p.add_argument("--max-events", type=int, default=100,
                   help="cap on timeline rows (newest kept)")
    p.add_argument("--artifacts", default=None,
                   help="directory of perf_pred_h100_*.json, the "
                        "ladder's bench_rung_*.json and serve_r<N>.json "
                        "(default: the logdir)")
    args = p.parse_args(argv)

    report = render_report(args.logdir, attribution=args.attribution,
                           max_events=args.max_events,
                           artifacts_dir=args.artifacts)
    if args.out:
        atomic_write_text(args.out, report)
        print(f"wrote {args.out}")
    else:
        sys.stdout.write(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
