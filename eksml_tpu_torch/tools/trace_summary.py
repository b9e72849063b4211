"""Summarize a ``torch.profiler`` capture into device time by op family
and by model component, and merge the per-host span traces of a run
(the port of ``tools/trace_summary.py``).

Run as::

    python -m eksml_tpu_torch.tools.trace_summary <logdir>/profile
        [--attribution <logdir>/profile/attribution.json] [--top 15]
        [--out summary.json]
    python -m eksml_tpu_torch.tools.trace_summary <logdir> --merge
        [--out merged_trace.json]

- **Capture summary**: the newest Chrome trace under the directory (the
  trainer's ``profile/trace-step<N>-host<i>.json``, or any
  ``*.trace.json(.gz)``).  The device lanes are the card's events
  (``kernel``, ``gpu_memcpy``, ``gpu_memset``); host ops are left out,
  so the breakdown is device time, not launch time.  Each event goes to
  a family by the reference's name regexes (:data:`FAMILIES`) and to a
  component through ``profiling/attribution.py``: the capture itself
  carries the model's scopes, so :class:`TraceAttribution` joins each
  kernel to the ranges that launched it.  ``--attribution`` resolves the
  event names through a banked ``attribution.json`` instead (its
  ``map``: event name → {component: ms}, an event split over components
  in the map's proportions); on the capture it was banked from it gives
  the same ``component_pct``.  The reference's ``--hlo`` has no
  counterpart: the port has no compiled module to read.
- **Cross-host merge** (``--merge``): the trainer's span traces
  (``trace-host<i>.json``, ``telemetry/tracing.py``), re-aligned on the
  ``train_step`` boundaries and merged into one Chrome trace, with the
  slowest steps named by the dominant span on the slowest host.  These
  functions are the reference's, copied.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, Optional

from eksml_tpu_torch.fsio import atomic_write_text
from eksml_tpu_torch.profiling.attribution import (_DEVICE_CATS, OTHER,
                                                   TraceAttribution)

# op-name regex → family, first match wins (the reference's table; the
# port's kernels keep their names: roi_align_fwd_*, roi_align_bwd_*)
FAMILIES = (
    ("roi_align_bwd", r"roi.?align.*(bwd|backward|grad|transpose)|"
                      r"(bwd|backward|grad).*roi.?align"),
    ("roi_align_fwd", r"roi.?align"),
    ("nms", r"non.?max|nms"),
    ("conv", r"conv"),
    ("matmul", r"dot|gemm|matmul|einsum"),
    ("allreduce", r"all.?reduce|psum|reduce.?scatter|all.?gather|"
                  r"collective"),
    ("copy", r"copy|transpose|reshape|bitcast"),
    ("reduce", r"reduce|cumsum|sort|top.?k"),
    ("scatter_gather", r"scatter|gather|dynamic.?slice|dynamic.?update"),
)

#: the captures a directory may hold: the trainer's and the
#: TensorBoard handler's names
TRACE_PATTERNS = ("trace-step*-host*.json", "*.trace.json",
                  "*.trace.json.gz")


def _load_trace_events(trace_dir: str):
    """(events, path) of the newest capture under ``trace_dir`` (or of
    ``trace_dir`` itself, a file)."""
    if os.path.isfile(trace_dir):
        paths = [trace_dir]
    else:
        paths = [p for pat in TRACE_PATTERNS for p in glob.glob(
            os.path.join(trace_dir, "**", pat), recursive=True)]
    if not paths:
        raise FileNotFoundError(
            f"no torch.profiler capture under {trace_dir!r} — run the "
            "trainer with --profile N (or /debugz/profile) first")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    return (doc.get("traceEvents", []) if isinstance(doc, dict)
            else doc), path


def load_component_map(attribution_path: Optional[str] = None) -> dict:
    """Device event name → {component: ms} from a banked
    ``attribution.json`` (its ``map``); {} without one.  A map of the
    reference's shape (name → component) reads as one component each."""
    if not attribution_path:
        return {}
    with open(attribution_path) as f:
        payload = json.load(f)
    base = payload.get("map", payload)
    return {name: ({comp: 1.0} if isinstance(comp, str) else dict(comp))
            for name, comp in base.items()}


def _split(name: str, dur: float, cmap: dict) -> Dict[str, float]:
    """An event's µs over components by the map's proportions."""
    shares = cmap.get(name) or cmap.get(name.rsplit("/", 1)[-1])
    total = sum(shares.values()) if shares else 0.0
    if not total:
        return {OTHER: dur}
    return {c: dur * v / total for c, v in shares.items()}


def summarize(trace_dir: str, top_n: int = 15,
              component_map: Optional[dict] = None) -> dict:
    events, path = _load_trace_events(trace_dir)
    if component_map:
        device = [(str(ev.get("name", "")), float(ev["dur"]))
                  for ev in events
                  if isinstance(ev, dict) and ev.get("ph") == "X"
                  and ev.get("cat") in _DEVICE_CATS and "dur" in ev]
        split = [_split(n, d, component_map) for n, d in device]
    else:
        attr = TraceAttribution({"traceEvents": events})
        device = [(n, d) for n, _, d in attr.device]
        split = [{c: d} for _, c, d in attr.device]

    fam_us: dict = {}
    comp_us: dict = {}
    op_us: dict = {}
    op_comp: dict = {}
    total = 0.0
    for (name, dur), comps in zip(device, split):
        total += dur
        op_us[name] = op_us.get(name, 0.0) + dur
        by = op_comp.setdefault(name, {})
        for comp, us in comps.items():
            comp_us[comp] = comp_us.get(comp, 0.0) + us
            by[comp] = by.get(comp, 0.0) + us
        for fam, pat in FAMILIES:
            if re.search(pat, name, re.I):
                fam_us[fam] = fam_us.get(fam, 0.0) + dur
                break
        else:
            fam_us["other"] = fam_us.get("other", 0.0) + dur

    if total == 0:
        raise ValueError(
            f"no device events (categories {sorted(_DEVICE_CATS)}) in "
            f"{path!r} — a CPU capture, or a truncated one")
    fam_pct = {k: round(100 * v / total, 2)
               for k, v in sorted(fam_us.items(), key=lambda kv: -kv[1])}
    top_ops = [{"name": k, "us": round(v, 1),
                "pct": round(100 * v / total, 2),
                "component": max(op_comp[k], key=op_comp[k].get)}
               for k, v in sorted(op_us.items(),
                                  key=lambda kv: -kv[1])[:top_n]]
    comp_pct = {k: round(100 * v / total, 2)
                for k, v in sorted(comp_us.items(), key=lambda kv: -kv[1])}
    return {"trace": path, "total_device_us": round(total, 1),
            "family_pct": fam_pct, "top_ops": top_ops,
            "component_source": ("attribution" if component_map
                                 else "capture"),
            "component_pct": comp_pct,
            "component_other_pct": comp_pct.get(OTHER, 0.0)}


# ---------------------------------------------------------------------
# cross-host span-trace merge (trace-host<i>.json from the telemetry
# tracer) — the reference's functions, copied
# ---------------------------------------------------------------------

STEP_SPAN = "train_step"  # the per-step anchor span the fit loop emits


def load_host_traces(logdir: str) -> tuple:
    """``({host_id: [events]}, {host_id: reason})`` from every
    ``trace-host<i>.json`` under ``logdir``.

    Skip-and-warn, never abort: a host killed mid-flush leaves a
    truncated/torn trace file, and a host that died before its first
    flush leaves none at all — exactly the runs whose cross-host
    timeline matters most.  Unreadable files are skipped with a
    stderr warning; hosts that the run's ``events-host<i>.jsonl``
    files prove existed but that left no trace are reported missing.
    Only a logdir with NO readable trace at all raises."""
    out: dict = {}
    skipped: dict = {}
    for path in sorted(glob.glob(
            os.path.join(logdir, "trace-host*.json"))):
        m = re.search(r"trace-host(\d+)\.json$", path)
        if not m:
            continue
        host = int(m.group(1))
        try:
            with open(path) as f:
                doc = json.load(f)
            events = doc.get("traceEvents", []) \
                if isinstance(doc, dict) else None
        except (json.JSONDecodeError, OSError) as e:
            # torn write from a killed process — keep the other hosts
            skipped[host] = f"unreadable ({type(e).__name__}: {e})"
            continue
        if not isinstance(events, list):
            skipped[host] = "malformed (no traceEvents list)"
            continue
        out[host] = events
    # hosts the run demonstrably had (their event files exist) but
    # whose span trace never landed — name them instead of silently
    # rendering a timeline that pretends they weren't there
    for path in glob.glob(os.path.join(logdir, "events-host*.jsonl")):
        m = re.search(r"events-host(\d+)\.jsonl$", path)
        if m and int(m.group(1)) not in out \
                and int(m.group(1)) not in skipped:
            skipped[int(m.group(1))] = "missing trace-host file"
    for host in sorted(skipped):
        print(f"warning: skipping host {host}: {skipped[host]} — "
              "merging the remaining hosts", file=sys.stderr)
    if not out:
        raise FileNotFoundError(
            f"no readable trace-host<i>.json under {logdir!r} — run "
            "with TELEMETRY.TRACING.ENABLED=True (or trigger a "
            "/debugz/profile capture) first"
            + (f"; skipped: {skipped}" if skipped else ""))
    return out, skipped


def _step_anchors(events) -> dict:
    """{step: earliest ts} of the per-step anchor spans."""
    anchors: dict = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") != STEP_SPAN:
            continue
        step = (ev.get("args") or {}).get("step")
        if step is None:
            continue
        ts = float(ev["ts"])
        if step not in anchors or ts < anchors[step]:
            anchors[step] = ts
    return anchors


def merge_host_traces(logdir: str, slow_top: int = 5) -> dict:
    """Merge per-host span traces into one step-aligned timeline.

    Alignment: per host, the median over common steps of (host0's
    anchor ts − this host's anchor ts) becomes the host's clock
    offset.  Step boundaries are collective in SPMD training, so the
    median offset IS the clock skew; wall-clock (NTP) disagreement
    drops out entirely.
    """
    traces, skipped = load_host_traces(logdir)
    ref_host = min(traces)
    ref_anchor = _step_anchors(traces[ref_host])

    merged = []
    offsets = {}
    covered: dict = {}    # step -> {host} (hosts with the anchor span)
    step_durs: dict = {}  # step -> {host: Σ step-attributed span µs}
    span_max: dict = {}   # (step, host) -> (name, dur µs) longest one
    for host, events in sorted(traces.items()):
        anchors = _step_anchors(events)
        common = sorted(set(anchors) & set(ref_anchor))
        if host == ref_host or not common:
            offset = 0.0
        else:
            deltas = sorted(ref_anchor[s] - anchors[s] for s in common)
            offset = deltas[len(deltas) // 2]
        offsets[host] = offset
        for ev in events:
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = round(float(ev["ts"]) + offset, 3)
            ev["pid"] = host
            merged.append(ev)
            if ev.get("ph") != "X":
                continue
            step = (ev.get("args") or {}).get("step")
            if step is None:
                continue
            step = int(step)
            dur = float(ev.get("dur", 0.0))
            if ev.get("name") == STEP_SPAN:
                covered.setdefault(step, set()).add(host)
            # per-step host wall = the SUM of the loop's sequential
            # step-attributed spans, not the train_step dispatch
            # alone: on an accelerator the dispatch returns
            # immediately and the blocking lands in data_wait /
            # host_metrics — ranking by dispatch would structurally
            # hide input starvation, the main thing to catch
            cur = step_durs.setdefault(step, {})
            cur[host] = cur.get(host, 0.0) + dur
            best = span_max.get((step, host))
            if best is None or dur > best[1]:
                span_max[(step, host)] = (ev["name"], dur)
    merged.sort(key=lambda e: e.get("ts", 0.0))

    # per-step wall time = the slowest host's total (the synchronous-
    # SPMD bound); only anchor-covered steps count (a lone
    # host_metrics span from a partial capture is not a step)
    steps = []
    for step in sorted(covered):
        by_host = {h: d for h, d in step_durs[step].items()
                   if h in covered[step]}
        if not by_host:
            continue
        slow_host = max(by_host, key=by_host.get)
        steps.append({"step": step,
                      "ms": round(by_host[slow_host] / 1000.0, 3),
                      "host": slow_host,
                      "hosts": len(by_host)})
    slow_steps = []
    if steps:
        mean_ms = sum(s["ms"] for s in steps) / len(steps)
        for s in sorted(steps, key=lambda s: -s["ms"])[:slow_top]:
            entry = dict(s)
            entry["vs_mean"] = round(s["ms"] / mean_ms, 2) \
                if mean_ms > 0 else 0.0
            dom = span_max.get((s["step"], s["host"]))
            if dom is not None:
                entry["dominant_span"] = dom[0]
                entry["dominant_ms"] = round(dom[1] / 1000.0, 3)
            slow_steps.append(entry)

    return {
        "hosts": sorted(traces),
        "skipped_hosts": {str(h): r
                          for h, r in sorted(skipped.items())},
        "host_offsets_us": {str(h): round(o, 1)
                            for h, o in offsets.items()},
        "steps_covered": len(steps),
        "mean_step_ms": (round(sum(s["ms"] for s in steps)
                               / len(steps), 3) if steps else 0.0),
        "slow_steps": slow_steps,
        "traceEvents": merged,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="device time of a torch.profiler capture by family "
                    "and component; --merge: a run's host span traces "
                    "on one timeline")
    p.add_argument("trace_dir")
    p.add_argument("--out", default=None)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--attribution", default=None,
                   help="a banked profile/attribution.json: resolve the "
                        "event names through its map")
    p.add_argument("--hlo", default=None,
                   help="not available in the port (no compiled module "
                        "to read); the capture carries its scopes")
    p.add_argument("--merge", action="store_true",
                   help="treat the positional arg as a training logdir "
                        "and merge its trace-host<i>.json span files "
                        "into one step-aligned cross-host timeline")
    args = p.parse_args(argv)
    if args.hlo:
        print(json.dumps({"error": (
            "--hlo: the port has no HLO to read — a torch.profiler "
            "capture carries its own scopes (summarize it as is), or "
            "pass --attribution <logdir>/profile/attribution.json")}))
        return 2
    try:
        if args.merge:
            summary = merge_host_traces(args.trace_dir)
        else:
            summary = summarize(args.trace_dir, args.top,
                                component_map=load_component_map(
                                    args.attribution))
    except (FileNotFoundError, ValueError, OSError) as e:
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        return 1
    # with --merge stdout gets the verdict; the (large) merged timeline
    # only lands where --out asks for it
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "traceEvents"}, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        atomic_write_text(args.out, json.dumps(summary, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
