"""``python -m eksml_tpu_torch.serve`` — run the online inference server.

Lifecycle::

    finalize_configs(is_training=False)
      → InferenceEngine(random params from --seed)   # on --device
      → ServingServer.start()                # /healthz answers 503
      → engine.warmup()                      # every bucket × rung
      → mark_ready()                         # /healthz flips to 200
      → wait for SIGTERM/SIGINT
      → drain: stop admission, flush in-flight batches, exit 0

Usage::

    python -m eksml_tpu_torch.serve --random-params --port 0 \\
        --port-file serve.port --config SERVE.MAX_BATCH_DELAY_MS=5

Serving from a checkpoint (``--checkpoint-dir``) and hot-reload wait
for the trainer slice; until then ``--random-params`` is the only source
of params, and the server refuses to start without it.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

log = logging.getLogger("eksml_tpu_torch.serve")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m eksml_tpu_torch.serve",
        description=__doc__.splitlines()[0])
    p.add_argument("--random-params", action="store_true",
                   help="seeded random params (smoke/load tests; no "
                        "checkpoint needed)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of --random-params")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without one)")
    p.add_argument("--port", type=int, default=None,
                   help="HTTP port (default: config SERVE.PORT; "
                        "0 = ephemeral + --port-file discovery)")
    p.add_argument("--addr", default="0.0.0.0")
    p.add_argument("--port-file", default=None,
                   help="publish the bound port here (write-then-rename)")
    p.add_argument("--trace-file", default=None,
                   help="flush the request span ring here as Chrome-trace "
                        "JSON at drain; requires "
                        "TELEMETRY.TRACING.ENABLED=True")
    p.add_argument("--config", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if not args.random_params:
        from eksml_tpu_torch.serve.engine import CHECKPOINT_ITEM

        p.error("need --random-params: serving from a checkpoint waits "
                f"for the trainer slice ({CHECKPOINT_ITEM})")

    import torch

    from eksml_tpu_torch.config import config, finalize_configs
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.serve.batcher import MicroBatcher
    from eksml_tpu_torch.serve.engine import InferenceEngine
    from eksml_tpu_torch.serve.server import ServingServer

    config.freeze(False)
    config.update_args(args.config)
    cfg = finalize_configs(is_training=False)

    tracer = None
    if bool(cfg.TELEMETRY.TRACING.ENABLED):
        from eksml_tpu_torch.telemetry.tracing import Tracer, install_tracer

        tracer = Tracer(capacity=int(cfg.TELEMETRY.TRACING.RING_EVENTS),
                        path=args.trace_file)
        install_tracer(tracer)

    params = init_params(cfg, torch.Generator().manual_seed(args.seed))
    engine = InferenceEngine(cfg, params=params, device=args.device)
    batcher = MicroBatcher(engine, cfg)
    port = args.port if args.port is not None else int(cfg.SERVE.PORT)
    server = ServingServer(
        batcher, port=port, addr=args.addr, port_file=args.port_file,
        result_masks_default=bool(cfg.SERVE.RESULT_MASKS))

    # SIGTERM/SIGINT → drain; the handler only sets an Event
    stop = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001 — signal API
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    server.start()
    n = engine.warmup()
    server.mark_ready()
    log.info("ready: %d warm shape(s) over %d bucket(s) x %s batch "
             "rung(s) on port %d", n, len(engine.buckets), engine.rungs,
             server.port)
    stop.wait()
    log.info("signal received: draining")
    server.drain()
    engine.close()
    if tracer is not None and args.trace_file:
        tracer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
