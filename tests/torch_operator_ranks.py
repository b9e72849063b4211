"""A stand-in rank of ``python -m eksml_tpu_torch.train`` for the
operator's CPU tests (``tests/test_torch_operator.py``).  Imports the
port's telemetry only (never JAX, never a model).

    python tests/torch_operator_ranks.py --logdir D [trainer arguments]

Started by ``LocalTrainerActuator`` with the JobSet env, it appends one
row ``{"launch_env": ..., "argv": ...}`` to ``<logdir>/stub-ranks.jsonl``;
local rank 0 serves a ``/metrics`` carrying the trainer's goodput,
preemption and ``hosts/*`` families and publishes its port in
``<logdir>/telemetry-host0.port``, as the trainer does.  Then it waits:
SIGTERM makes it exit 77 (the trainer's resumable code), or
``$STUB_EXIT_RANK<r>`` where that is set for its rank; ``$STUB_END_RANK<r>
= S`` makes that rank end on its own with 0 after S seconds.
"""

import argparse
import json
import os
import signal
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu_torch.telemetry.exporter import TelemetryExporter  # noqa: E402
from eksml_tpu_torch.telemetry.registry import MetricRegistry  # noqa: E402

ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "LOCAL_WORLD_SIZE",
       "LOCAL_RANK", "PROCESS_ID")


def trainer_registry() -> MetricRegistry:
    """The families the operator reads, at fixed values."""
    reg = MetricRegistry()
    reg.gauge("eksml_goodput_ratio", "productive share").set(0.75)
    for bucket, v in (("downtime", 4.5), ("checkpoint_save", 1.25)):
        reg.counter("eksml_badput_seconds", "badput",
                    labels={"bucket": bucket}).inc(v)
    reg.counter("eksml_resilience_preemptions", "preemptions").inc(2)
    reg.gauge("eksml_hosts_step_time_ms_max", "aggregate").set(41.0)
    reg.gauge("eksml_hosts_lagging", "aggregate").set(1.0)
    return reg


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", required=True)
    args, rest = p.parse_known_args()
    rank = int(os.environ.get("LOCAL_RANK", "0"))
    end_after = float(os.environ.get(f"STUB_END_RANK{rank}", "0"))
    stop = {"term": False}

    def on_term(signum, frame):  # noqa: ARG001 — signal API
        stop["term"] = True

    signal.signal(signal.SIGTERM, on_term)
    with open(os.path.join(args.logdir, "stub-ranks.jsonl"), "a") as f:
        f.write(json.dumps({"launch_env": {k: os.environ.get(k)
                                           for k in ENV},
                            "argv": rest, "pid": os.getpid()}) + "\n")
    exporter = None
    if rank == 0:
        exporter = TelemetryExporter(
            port=0, addr="127.0.0.1", registry=trainer_registry(),
            port_file=os.path.join(args.logdir,
                                   "telemetry-host0.port")).start()
    t0 = time.monotonic()
    try:
        while not stop["term"]:
            if end_after and time.monotonic() - t0 > end_after:
                return 0
            time.sleep(0.05)
    finally:
        if exporter is not None:
            exporter.stop()
    return int(os.environ.get(f"STUB_EXIT_RANK{rank}", "77"))


if __name__ == "__main__":
    sys.exit(main())
