"""Operating-point sweep (the port's copy of ``tools/bench_sweep.py``):
the ladder's knobs run together and banked as one artifact.  Each row is
one rung of ``python -m eksml_tpu_torch.tools.bench`` in a subprocess of
its own, so a row that crashes or hangs takes no other down::

    python -m eksml_tpu_torch.tools.bench_sweep \\
        [--out artifacts/h100/bench_sweep.json] [--steps 20]
        [--timeout 1200] [--quick] [--device cuda]

The rows (:data:`CONFIGS`): ``bf16`` at ``1344_b4`` (the headline: the
optimized chart's precision), ``bf16_remat``, ``f32``, ``bf16_bucket``
(the optimized chart's landscape bucket, the ``832x1344_b4`` rung) and
``bf16_f32ingest`` (``PREPROC.DEVICE_NORMALIZE=False``: the loader
normalizes in float32 on the host, the step ingests float32).  The
reference's ROIAlign-backend rows (``xla_bf16``,
``pallas_bf16_bwdxla``, ``pallas_bf16_bwdpallas``) have no counterpart:
the port has one ROIAlign route per device (the CUDA kernels on the
card, their plain versions on the CPU).

Every row has a timeout, on the card too: a row that outlives it is
killed with its whole session (the ladder and anything it started), so
no child outlives the sweep.  ``--quick``: the port's
``SMOKE_OVERRIDES`` at batch 1 on the CPU (``--device cpu``), a
plumbing smoke; the bucket row scales its canvas down with them.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

#: (name, the ladder's argv, config KEY=VALUEs); the first is the
#: headline operating point
CONFIGS = [
    ("bf16", ["--rungs", "1344_b4", "--precision", "bfloat16"], []),
    ("bf16_remat", ["--rungs", "1344_b4", "--precision", "bfloat16",
                    "--remat", "1"], []),
    ("f32", ["--rungs", "1344_b4", "--precision", "float32"], []),
    # the optimized chart's landscape bucket (PREPROC.BUCKETS): the
    # canvas landscape COCO images train at
    ("bf16_bucket", ["--rungs", "832x1344_b4", "--precision", "bfloat16"],
     []),
    # float32 host-normalized ingest (PREPROC.DEVICE_NORMALIZE off)
    ("bf16_f32ingest", ["--rungs", "1344_b4", "--precision", "bfloat16"],
     ["PREPROC.DEVICE_NORMALIZE=False"]),
]

#: per-row wall-clock budget (s) unless ``--timeout``: f32's step 1 alone
#: takes ~115 s of cuDNN's autotune on an H100
DEFAULT_TIMEOUT = 1200.0
QUICK_TIMEOUT = 1500.0


def quick_config(name: str) -> list:
    """The ``--config`` items a ``--quick`` row adds: SMOKE widths at
    batch 1, and for the bucket row a 128x192 canvas (dims % 64 == 0)."""
    from eksml_tpu_torch.config import SMOKE_OVERRIDES

    items = [*SMOKE_OVERRIDES, "TRAIN.BATCH_SIZE_PER_CHIP=1"]
    if name == "bf16_bucket":
        items += ["PREPROC.MAX_SIZE=192", "PREPROC.BUCKETS=((128,192),)"]
    return items


def run_row(cmd, timeout: float, cwd: str):
    """``(stdout, stderr)`` of ``cmd`` run in a session of its own;
    raises ``subprocess.TimeoutExpired`` after ``timeout`` s.  However
    the row ends, whatever is left of its session is killed."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=cwd,
                            start_new_session=True)
    try:
        return proc.communicate(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="the ladder's operating points as one artifact")
    p.add_argument("--out", default="artifacts/h100/bench_sweep.json")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--timeout", type=float, default=None,
                   help=f"per-row wall-clock budget (s); default "
                        f"{DEFAULT_TIMEOUT:.0f}, {QUICK_TIMEOUT:.0f} with "
                        "--quick")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default=None,
                   help="the ladder's --device (default: cuda; cpu with "
                        "--quick)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from eksml_tpu_torch.fsio import atomic_write_json

    timeout = args.timeout or (QUICK_TIMEOUT if args.quick
                               else DEFAULT_TIMEOUT)
    device = args.device or ("cpu" if args.quick else "cuda")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    results = []
    for name, extra, config in CONFIGS:
        cmd = [sys.executable, "-m", "eksml_tpu_torch.tools.bench",
               "--steps", str(args.steps), "--device", device, *extra]
        if args.quick:
            cmd += ["--warmup", "2"]
            config = config + quick_config(name)
        if config:
            cmd += ["--config", *config]
        t0 = time.time()
        entry = {"config": name}
        try:
            stdout, stderr = run_row(cmd, timeout, repo)
            line = stdout.strip().splitlines()[-1] if stdout.strip() else ""
            entry.update(json.loads(line))
        except subprocess.TimeoutExpired:
            entry["error"] = f"timeout after {timeout:.0f}s"
        except (json.JSONDecodeError, IndexError):
            entry["error"] = "no JSON line"
            entry["stderr_tail"] = stderr.splitlines()[-3:]
        entry["wall_s"] = round(time.time() - t0, 1)
        results.append(entry)
        print(f"{name}: {entry.get('value', entry.get('error'))}",
              file=sys.stderr, flush=True)

    payload = {"sweep": results}
    print(json.dumps(payload), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    atomic_write_json(args.out, payload)
    return payload


if __name__ == "__main__":
    main()
    sys.exit(0)
