"""Closed- and open-loop load generator for the serving tracks (the port
of ``tools/serve_loadtest.py``).

Drives ``POST /v1/predict`` on a running server (``python -m
eksml_tpu_torch.serve``) with seeded synthetic images of mixed sizes and
folds the answers into one latency/throughput artifact:

- **closed loop** (default): ``--concurrency`` workers each send
  requests back-to-back until ``--requests`` complete; measures the
  server's throughput ceiling and the latency at that ceiling.
- **open loop** (``--mode open --rate R``): requests fire on a fixed
  arrival schedule whatever the completions do; measures latency under
  a given offered load (closed-loop latency hides queueing collapse).

Every record carries the server's span-derived ``timings_ms`` phases
(queue_wait / pad / device_infer / postprocess), so the artifact
attributes tail latency to a phase, and the post-run ``/healthz`` scrape
holds the engine's compile counters: the proof that the request path
met no shape the warmup had not run.

**Record / replay / shadow** (the canary-scoring harness): ``--record``
banks the request distribution (seed + per-request shapes, kilobytes) so
the same traffic replays later; ``--replay BANK --shadow --canary-url
URL`` sends every banked request to both the incumbent and the canary
and scores the canary on three axes: latency p99 ratio, error rate, and
detection-output drift (on the pre-threshold ``raw_top`` head outputs,
so drift is 0 for identical weights and nonzero for different ones even
when neither side clears the score threshold).  The promotion controller
(``python -m eksml_tpu_torch.tools.eksml_operator --promote``) gates
promote against rollback on the same ``replay_shadow`` call.

Usage::

    python -m eksml_tpu_torch.tools.serve_loadtest \\
        --url http://127.0.0.1:8081 --requests 200 --concurrency 8
    python -m eksml_tpu_torch.tools.serve_loadtest --port-file serve.port \\
        --mode open --rate 50 --requests 500 --out serve_open.json
    python -m eksml_tpu_torch.tools.serve_loadtest --record bank.json \\
        --requests 100
    python -m eksml_tpu_torch.tools.serve_loadtest \\
        --url http://stable:8081 --replay bank.json --shadow \\
        --canary-url http://canary:8081
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os
import queue
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

import numpy as np

from eksml_tpu_torch.fsio import atomic_write_json

#: the repository root: ``--bank`` writes under its ``artifacts/``
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PHASES = ("queue_wait", "pad", "device_infer", "postprocess")

DEFAULT_SIZES = "480x640,640x480,330x500,600x400,512x512"


def _utcnow() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def gen_image(seed: int, idx: int, sizes: List[Tuple[int, int]]
              ) -> np.ndarray:
    """Deterministic synthetic uint8 RGB image for request ``idx``."""
    rng = np.random.RandomState(seed + idx)
    h, w = sizes[idx % len(sizes)]
    return rng.randint(0, 255, (h, w, 3)).astype(np.uint8)


def post_predict(url: str, image: np.ndarray, timeout: float = 120.0,
                 score_thresh: Optional[float] = None,
                 raw_topk: int = 0) -> Dict:
    """One request; returns the decoded response with ``_latency_ms``
    (client-observed) added.  Raises ``urllib.error.HTTPError`` on a
    non-2xx answer.  ``raw_topk`` asks the server for its
    pre-threshold top-k raw head outputs (the drift signal)."""
    payload: Dict = {
        "image_b64": base64.b64encode(image.tobytes()).decode("ascii"),
        "shape": list(image.shape),
        "dtype": "uint8",
    }
    if score_thresh is not None:
        payload["score_thresh"] = score_thresh
    if raw_topk:
        payload["raw_topk"] = int(raw_topk)
    body = json.dumps(payload).encode("utf-8")
    req = urllib.request.Request(
        url.rstrip("/") + "/v1/predict", data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.loads(resp.read().decode("utf-8"))
    out["_latency_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def fetch_health(url: str, timeout: float = 10.0) -> Dict:
    """``/healthz`` payload regardless of status code (503 while
    warming/draining still carries the state fields)."""
    try:
        with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                    timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return json.loads(e.read().decode("utf-8"))


def wait_ready(url: str, budget: float = 600.0) -> Dict:
    """Poll ``/healthz`` until it reports ``ok`` (warmup done)."""
    deadline = time.monotonic() + budget
    last: Dict = {}
    while time.monotonic() < deadline:
        try:
            last = fetch_health(url)
            if last.get("status") == "ok":
                return last
        except (urllib.error.URLError, OSError):
            pass
        time.sleep(0.25)
    raise TimeoutError(
        f"server at {url} not ready within {budget}s "
        f"(last /healthz: {last})")


def metric_value(metrics_text: str, name: str,
                 labels: str = "") -> Optional[float]:
    """First sample value of ``name{labels}`` in an OpenMetrics body."""
    pat = re.compile(r"^" + re.escape(name)
                     + (re.escape(labels) if labels else r"(?:\{[^}]*\})?")
                     + r" (\S+)$", re.M)
    m = pat.search(metrics_text)
    return float(m.group(1)) if m else None


def scrape_metrics(url: str, timeout: float = 10.0) -> str:
    with urllib.request.urlopen(url.rstrip("/") + "/metrics",
                                timeout=timeout) as resp:
        return resp.read().decode("utf-8")


def _pct(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


def run_load(url: str, requests: int, concurrency: int,
             mode: str = "closed", rate: float = 0.0, seed: int = 0,
             sizes: str = DEFAULT_SIZES,
             timeout: float = 120.0,
             keep_records: bool = False) -> Dict:
    """Drive the load and fold the records into the artifact dict.
    ``keep_records=True`` adds the raw per-request records (t_wall +
    params_step included) — the hot-reload chaos rung joins them
    against the ``serve_reload`` flight event to prove the swap
    boundary; banked artifacts stay summary-only."""
    size_list = [tuple(int(d) for d in s.split("x"))
                 for s in sizes.split(",") if s]
    records: List[Dict] = []
    errors: List[str] = []
    slips_ms: List[float] = []
    rec_lock = threading.Lock()
    work: "queue.Queue" = queue.Queue()
    for i in range(requests):
        work.put(i)
    # open loop needs headroom beyond the closed-loop worker count:
    # with only `concurrency` workers, arrivals silently throttle to
    # the completion rate the moment latency exceeds the inter-arrival
    # gap — coordinated omission, the exact bias open loop exists to
    # avoid.  Workers auto-size (concurrency stays a floor) and any
    # residual schedule slip is MEASURED and banked, never hidden.
    n_workers = (max(1, concurrency) if mode != "open"
                 else min(requests, max(concurrency, 64)))
    t_start = time.perf_counter()

    def one(idx: int) -> None:
        if mode == "open" and rate > 0:
            # fixed arrival schedule: request idx fires at idx/rate
            # seconds after start, whatever the completions are doing
            delay = t_start + idx / rate - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            else:
                with rec_lock:
                    slips_ms.append(-delay * 1e3)
        img = gen_image(seed, idx, size_list)
        try:
            resp = post_predict(url, img, timeout=timeout)
        except Exception as e:  # noqa: BLE001 — recorded, not fatal
            with rec_lock:
                errors.append(f"req {idx}: {e!r}")
            return
        with rec_lock:
            records.append({
                "idx": idx,
                "t_wall": time.time(),
                "total_ms": resp["_latency_ms"],
                "phases": {k: resp.get("timings_ms", {}).get(k)
                           for k in PHASES},
                "bucket": resp.get("bucket"),
                "batch_fill": resp.get("batch_fill"),
                "batch_rung": resp.get("batch_rung"),
                "detections": len(resp.get("detections", ())),
                # checkpoint that served this request — the hot-reload
                # chaos rung joins these against the serve_reload
                # flight event to prove the flip boundary
                "params_step": resp.get("params_step"),
            })

    def worker() -> None:
        while True:
            try:
                idx = work.get_nowait()
            except queue.Empty:
                return
            one(idx)

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"loadgen-{i}")
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t_start

    lat = [r["total_ms"] for r in records]
    phase_ms = {}
    for ph in PHASES:
        vals = [r["phases"][ph] for r in records
                if isinstance(r["phases"].get(ph), (int, float))]
        phase_ms[ph] = {"mean": round(float(np.mean(vals)), 3)
                        if vals else None,
                        "p99": round(_pct(vals, 99), 3)
                        if vals else None}
    fills = [r["batch_fill"] / r["batch_rung"] for r in records
             if r.get("batch_rung")]
    slowest = sorted(records, key=lambda r: -r["total_ms"])[:5]
    for s in slowest:
        ph = {k: v for k, v in s["phases"].items()
              if isinstance(v, (int, float))}
        s["dominant_phase"] = (max(ph, key=ph.get) if ph else None)
    open_loop = None
    if mode == "open":
        behind = [s for s in slips_ms if s > 5.0]
        open_loop = {
            "workers": n_workers,
            "arrivals_behind": len(behind),
            "slip_ms": {
                "mean": round(float(np.mean(slips_ms)), 3)
                if slips_ms else 0.0,
                "p99": round(_pct(slips_ms, 99), 3)
                if slips_ms else 0.0,
                "max": round(max(slips_ms), 3) if slips_ms else 0.0,
            },
            # nonzero arrivals_behind = the offered rate was NOT
            # fully sustained (worker pool or client box saturated);
            # the latency numbers then understate the true open-loop
            # tail — read them as a lower bound
            "offered_rate_sustained": not behind,
        }
    return {
        "kind": "serve_loadtest",
        "mode": mode,
        "rate_rps": rate if mode == "open" else None,
        "open_loop": open_loop,
        "requests": requests,
        "completed": len(records),
        "errors": len(errors),
        "error_samples": errors[:5],
        "concurrency": concurrency,
        "sizes": sizes,
        "seed": seed,
        "wall_s": round(wall_s, 3),
        "images_per_sec": round(len(records) / wall_s, 3)
        if wall_s > 0 else 0.0,
        "latency_ms": {
            "p50": round(_pct(lat, 50), 3),
            "p90": round(_pct(lat, 90), 3),
            "p99": round(_pct(lat, 99), 3),
            "mean": round(float(np.mean(lat)), 3) if lat else 0.0,
            "max": round(max(lat), 3) if lat else 0.0,
        },
        "phase_ms": phase_ms,
        "batch_occupancy_mean": round(float(np.mean(fills)), 3)
        if fills else None,
        "slowest": slowest,
        **({"records": records} if keep_records else {}),
    }


def build_bank(seed: int, sizes: str, requests: int) -> Dict:
    """The recorded request distribution in regenerable form: seed +
    per-request shapes, not pixel payloads — the bank stays kilobytes
    and ``gen_image(seed, idx, [(h, w)])`` reproduces every image
    bit-exactly at replay time."""
    size_list = [tuple(int(d) for d in s.split("x"))
                 for s in sizes.split(",") if s]
    return {
        "kind": "serve_request_bank",
        "seed": int(seed),
        "sizes": sizes,
        "requests": [
            {"idx": i,
             "h": size_list[i % len(size_list)][0],
             "w": size_list[i % len(size_list)][1]}
            for i in range(requests)],
        "recorded_at": _utcnow(),
    }


def bank_image(bank: Dict, row: Dict) -> np.ndarray:
    """Regenerate one banked request's image bit-exactly."""
    return gen_image(int(bank["seed"]), int(row["idx"]),
                     [(int(row["h"]), int(row["w"]))])


def detection_drift(a: Dict, b: Dict) -> float:
    """Output disagreement between two responses for ONE request,
    in [0, 1]; exactly 0.0 when the params are identical.

    Primary signal: the pre-threshold ``raw_top`` head outputs — per
    rank, a class disagreement counts 1.0 and a class match counts
    the score delta.  This stays nonzero for different params even
    when both checkpoints emit zero above-threshold detections (the
    degenerate case where a detections-based metric would
    silently report "no drift" between arbitrary params).  Fallback
    (no ``raw_top`` in the responses): greedy same-class IoU >= 0.5
    matching over the thresholded detections, drift = 1 - 2m/(na+nb).
    """
    ra, rb = a.get("raw_top"), b.get("raw_top")
    if ra and rb:
        k = min(len(ra["scores"]), len(rb["scores"]))
        if k == 0:
            return 0.0
        per_rank = [
            1.0 if ra["classes"][i] != rb["classes"][i]
            else min(1.0, abs(float(ra["scores"][i])
                              - float(rb["scores"][i])))
            for i in range(k)]
        return float(np.mean(per_rank))
    da, db = a.get("detections", []), b.get("detections", [])
    if not da and not db:
        return 0.0

    def iou(b1, b2) -> float:
        x0 = max(b1[0], b2[0]); y0 = max(b1[1], b2[1])  # noqa: E702
        x1 = min(b1[2], b2[2]); y1 = min(b1[3], b2[3])  # noqa: E702
        inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
        a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
        a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
        return inter / max(a1 + a2 - inter, 1e-9)

    unmatched = list(range(len(db)))
    matches = 0
    for d in da:
        best, best_iou = None, 0.5
        for j in unmatched:
            if d["class_id"] != db[j]["class_id"]:
                continue
            v = iou(d["box"], db[j]["box"])
            if v >= best_iou:
                best, best_iou = j, v
        if best is not None:
            unmatched.remove(best)
            matches += 1
    return 1.0 - 2.0 * matches / (len(da) + len(db))


def replay_shadow(bank: Dict, url: str, canary_url: str,
                  timeout: float = 120.0, raw_topk: int = 16,
                  score_thresh: Optional[float] = None,
                  concurrency: int = 4) -> Dict:
    """Mirror the banked traffic at incumbent AND canary; score the
    canary on latency p99 ratio, error rate, and output drift.

    Each worker sends one request to both servers back-to-back (the
    pair sees the same queue conditions, so the p99 ratio compares
    like with like), then diffs the outputs.  The score dict is what
    ``promotion_verdict`` (``eksml_operator.py``) gates on.

    A track may swap weights during the replay (the canary's own
    watcher polls every ``SERVE.RELOAD_POLL_SEC``).  As in the
    reference, such a replay is scored as ONE replay: every pair counts,
    whichever step answered it, and the steps seen are listed in
    ``incumbent.params_steps`` / ``canary.params_steps`` (two entries on
    a track = a swap happened mid-replay).  The controller acts on the
    steps it read from ``/healthz`` before the replay."""
    rows = bank["requests"]
    rec_lock = threading.Lock()
    inc_lat: List[float] = []
    can_lat: List[float] = []
    drifts: List[float] = []
    inc_errors: List[str] = []
    can_errors: List[str] = []
    inc_steps: set = set()
    can_steps: set = set()
    work: "queue.Queue" = queue.Queue()
    for row in rows:
        work.put(row)

    def one(row: Dict) -> None:
        img = bank_image(bank, row)
        try:
            a = post_predict(url, img, timeout=timeout,
                             score_thresh=score_thresh,
                             raw_topk=raw_topk)
        except Exception as e:  # noqa: BLE001 — scored, not fatal
            with rec_lock:
                inc_errors.append(f"req {row['idx']}: {e!r}")
            return
        try:
            b = post_predict(canary_url, img, timeout=timeout,
                             score_thresh=score_thresh,
                             raw_topk=raw_topk)
        except Exception as e:  # noqa: BLE001 — scored, not fatal
            with rec_lock:
                inc_lat.append(a["_latency_ms"])
                can_errors.append(f"req {row['idx']}: {e!r}")
            return
        d = detection_drift(a, b)
        with rec_lock:
            inc_lat.append(a["_latency_ms"])
            can_lat.append(b["_latency_ms"])
            drifts.append(d)
            inc_steps.add(a.get("params_step"))
            can_steps.add(b.get("params_step"))

    def worker() -> None:
        while True:
            try:
                row = work.get_nowait()
            except queue.Empty:
                return
            one(row)

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"shadow-{i}")
               for i in range(max(1, concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    inc_p99, can_p99 = _pct(inc_lat, 99), _pct(can_lat, 99)
    scored = len(drifts)
    return {
        "kind": "serve_shadow_score",
        "bank_seed": bank.get("seed"),
        "requests": len(rows),
        "scored": scored,
        "incumbent": {
            "url": url,
            "errors": len(inc_errors),
            "error_samples": inc_errors[:3],
            "params_steps": sorted(
                s for s in inc_steps if s is not None),
            "latency_ms": {"p50": round(_pct(inc_lat, 50), 3),
                           "p99": round(inc_p99, 3)},
        },
        "canary": {
            "url": canary_url,
            "errors": len(can_errors),
            "error_samples": can_errors[:3],
            "params_steps": sorted(
                s for s in can_steps if s is not None),
            "latency_ms": {"p50": round(_pct(can_lat, 50), 3),
                           "p99": round(can_p99, 3)},
        },
        # the three gate axes (promotion_verdict reads exactly these)
        "p99_ratio": round(can_p99 / inc_p99, 4) if inc_p99 > 0
        else None,
        "canary_error_rate": round(
            len(can_errors) / max(len(rows), 1), 4),
        "drift": {
            "mean": round(float(np.mean(drifts)), 6) if drifts else None,
            "p99": round(_pct(drifts, 99), 6) if drifts else None,
            "max": round(max(drifts), 6) if drifts else None,
        },
        "scored_at": _utcnow(),
    }


def next_bank_path(artifacts_dir: str, prefix: str = "serve") -> str:
    """First free ``<prefix>_r<N>.json`` slot."""
    taken = set()
    for p in glob.glob(os.path.join(artifacts_dir,
                                    f"{prefix}_r*.json")):
        m = re.match(prefix + r"_r(\d+)\.json$", os.path.basename(p))
        if m:
            taken.add(int(m.group(1)))
    n = 1
    while n in taken:
        n += 1
    return os.path.join(artifacts_dir, f"{prefix}_r{n}.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--url", default=None,
                   help="server base URL, e.g. http://127.0.0.1:8081")
    p.add_argument("--port-file", default=None,
                   help="read the port from this file (the --port-file "
                        "the server wrote) and target 127.0.0.1")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--mode", choices=["closed", "open"],
                   default="closed")
    p.add_argument("--rate", type=float, default=0.0,
                   help="open-loop arrival rate (requests/sec)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sizes", default=DEFAULT_SIZES,
                   help="comma list of HxW request image sizes "
                        "[%(default)s]")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--wait-ready", type=float, default=600.0,
                   help="seconds to wait for /healthz ok before load")
    p.add_argument("--out", default=None,
                   help="write the artifact here (atomic)")
    p.add_argument("--bank", action="store_true",
                   help="write to the next free "
                        "artifacts/serve_r<N>.json slot")
    p.add_argument("--note", default=None,
                   help="free-text provenance recorded in the "
                        "artifact (geometry, hardware, caveats)")
    p.add_argument("--record", default=None, metavar="PATH",
                   help="bank the request distribution (seed + "
                        "shapes) here and exit — no server needed")
    p.add_argument("--replay", default=None, metavar="BANK",
                   help="replay a recorded bank instead of generating "
                        "fresh traffic")
    p.add_argument("--shadow", action="store_true",
                   help="with --replay: mirror each request at "
                        "--canary-url too and score the canary "
                        "(latency p99 ratio, error rate, drift)")
    p.add_argument("--canary-url", default=None,
                   help="canary base URL for --shadow scoring")
    p.add_argument("--raw-topk", type=int, default=16,
                   help="pre-threshold top-k raw outputs per request "
                        "for the drift signal [%(default)s]")
    args = p.parse_args(argv)

    if args.record:
        bank = build_bank(args.seed, args.sizes, args.requests)
        os.makedirs(os.path.dirname(args.record) or ".", exist_ok=True)
        atomic_write_json(args.record, bank)
        print(f"recorded {len(bank['requests'])} request(s) -> "
              f"{args.record}")
        return 0

    if args.url:
        url = args.url
    elif args.port_file:
        deadline = time.monotonic() + args.wait_ready
        while not os.path.exists(args.port_file):
            if time.monotonic() > deadline:
                p.error(f"port file {args.port_file} never appeared")
            time.sleep(0.2)
        url = f"http://127.0.0.1:{open(args.port_file).read().strip()}"
    else:
        p.error("need --url or --port-file")
    if args.mode == "open" and args.rate <= 0:
        p.error("--mode open needs --rate > 0")

    if args.shadow:
        if not (args.replay and args.canary_url):
            p.error("--shadow needs --replay BANK and --canary-url")
        with open(args.replay) as f:
            bank = json.load(f)
        wait_ready(url, budget=args.wait_ready)
        wait_ready(args.canary_url, budget=args.wait_ready)
        score = replay_shadow(bank, url, args.canary_url,
                              timeout=args.timeout,
                              raw_topk=args.raw_topk,
                              concurrency=args.concurrency)
        if args.note:
            score["note"] = args.note
        print(json.dumps(score, indent=1))
        out = args.out
        if out is None and args.bank:
            out = next_bank_path(os.path.join(REPO, "artifacts"),
                                 prefix="shadow")
        if out:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            atomic_write_json(out, score)
            print(f"banked {out}", file=sys.stderr)
        return 0 if score["canary_error_rate"] == 0 else 1

    if args.replay:
        # a bank IS (seed, sizes, count) — replaying without --shadow
        # is run_load over the exact recorded distribution
        with open(args.replay) as f:
            bank = json.load(f)
        args.seed = int(bank["seed"])
        args.sizes = bank["sizes"]
        args.requests = len(bank["requests"])

    health = wait_ready(url, budget=args.wait_ready)
    artifact = run_load(url, args.requests, args.concurrency,
                        mode=args.mode, rate=args.rate, seed=args.seed,
                        sizes=args.sizes, timeout=args.timeout)
    # post-run engine state: the zero-cold-compile proof and the
    # per-chip normalization ride the SAME scrape the HPA uses
    try:
        post = fetch_health(url)
        metrics = scrape_metrics(url)
    except (urllib.error.URLError, OSError) as e:
        post, metrics = {"error": repr(e)}, ""
    devices = int(post.get("devices") or health.get("devices") or 1)
    artifact.update({
        "url": url,
        "devices": devices,
        "images_per_sec_per_chip": round(
            artifact["images_per_sec"] / max(devices, 1), 3),
        "engine": {
            "compiles": post.get("compiles"),
            "request_path_compiles": post.get("request_path_compiles"),
            "warm_executables": post.get("warm_executables"),
            "buckets": post.get("buckets"),
            "batch_rungs": post.get("batch_rungs"),
        },
        "zero_request_path_compiles":
            post.get("request_path_compiles") == 0,
        "metrics": {
            "requests_ok": metric_value(
                metrics, "eksml_serve_requests_total",
                '{outcome="ok"}'),
            "batches": metric_value(metrics,
                                    "eksml_serve_batches_total"),
            "aot_compiles": metric_value(
                metrics, "eksml_serve_aot_compiles_total"),
            "request_path_compiles": metric_value(
                metrics, "eksml_serve_request_path_compiles_total"),
        },
        "banked_at": _utcnow(),
    })
    if args.note:
        artifact["note"] = args.note
    payload = json.dumps(artifact, indent=1)
    print(payload)
    out = args.out
    if out is None and args.bank:
        out = next_bank_path(os.path.join(REPO, "artifacts"))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        atomic_write_json(out, artifact)
        print(f"banked {out}", file=sys.stderr)
    return 0 if artifact["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
