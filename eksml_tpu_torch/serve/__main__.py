"""``python -m eksml_tpu_torch.serve`` — run the online inference server.

Lifecycle::

    finalize_configs(is_training=False)
      → InferenceEngine(checkpoint | random params)  # on --device
      → ServingServer.start()                # /healthz answers 503
      → engine.warmup()                      # every bucket × rung
      → mark_ready()                         # /healthz flips to 200
      → hot-reload watcher (with --checkpoint-dir)
      → wait for SIGTERM/SIGINT
      → drain: stop admission, flush in-flight batches, exit 0

Usage::

    # serve what the trainer wrote (newest step unless --step), picking
    # up new checkpoints every SERVE.RELOAD_POLL_SEC and on
    # POST /admin/reload
    python -m eksml_tpu_torch.serve --checkpoint-dir /runs/maskrcnn \\
        --config SERVE.RELOAD_POLL_SEC=30

    # smoke/load-test mode: seeded random params, ephemeral port
    python -m eksml_tpu_torch.serve --random-params --port 0 \\
        --port-file serve.port --config SERVE.MAX_BATCH_DELAY_MS=5

    # the serve chart's two tracks on one logdir: the stable track moves
    # only through the promotion controller's /admin/reload, the canary
    # chases training; each appends to its own events-host<id>.jsonl
    python -m eksml_tpu_torch.serve --checkpoint-dir /runs/maskrcnn \\
        --serve-id stable --config SERVE.RELOAD_POLL_SEC=0
    python -m eksml_tpu_torch.serve --checkpoint-dir /runs/maskrcnn \\
        --serve-id canary --config SERVE.RELOAD_POLL_SEC=30

The promotion controller that scores the canary against the stable
track is ``python -m eksml_tpu_torch.tools.eksml_operator --promote``.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading

log = logging.getLogger("eksml_tpu_torch.serve")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m eksml_tpu_torch.serve",
        description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint-dir", default=None,
                   help="training logdir to restore params from (latest "
                        "step unless --step) and to watch for new steps")
    p.add_argument("--step", type=int, default=None,
                   help="explicit checkpoint step")
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
    p.add_argument("--serve-id", default="serve",
                   help="instance id: names the flight-event file "
                        "(events-host<id>.jsonl) and the recorder's host, so "
                        "the stable and canary tracks sharing a logdir keep "
                        "their reload timelines apart")
    p.add_argument("--config", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if not args.random_params and not args.checkpoint_dir:
        p.error("need --checkpoint-dir or --random-params")

    import torch

    from eksml_tpu_torch import telemetry
    from eksml_tpu_torch.config import config, finalize_configs
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.ops.roi_align import KERNELS
    from eksml_tpu_torch.serve.batcher import MicroBatcher
    from eksml_tpu_torch.serve.engine import InferenceEngine
    from eksml_tpu_torch.serve.reload import ReloadManager
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

    if args.random_params:
        params = init_params(cfg, torch.Generator().manual_seed(args.seed))
        engine = InferenceEngine(cfg, params=params, device=args.device)
    else:
        engine = InferenceEngine(cfg, checkpoint_dir=args.checkpoint_dir,
                                 checkpoint_step=args.step,
                                 device=args.device)
    batcher = MicroBatcher(engine, cfg)
    port = args.port if args.port is not None else int(cfg.SERVE.PORT)
    server = ServingServer(
        batcher, port=port, addr=args.addr, port_file=args.port_file,
        result_masks_default=bool(cfg.SERVE.RESULT_MASKS))

    reload_mgr = None
    if args.checkpoint_dir:
        # reload events land next to the trainer's in the logdir, in this
        # track's own file
        telemetry.install(telemetry.FlightRecorder(
            path=telemetry.events_path_for(args.checkpoint_dir,
                                           args.serve_id),
            host_id=args.serve_id))
        reload_mgr = ReloadManager(
            engine, args.checkpoint_dir, lock=server.lifecycle_lock,
            poll_sec=float(cfg.SERVE.RELOAD_POLL_SEC),
            is_draining=server.draining.is_set,
            check_digest=bool(cfg.SERVE.RELOAD_DIGEST))
        server.reload_manager = reload_mgr

    # SIGTERM/SIGINT → drain; the handler only sets an Event
    stop = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001 — signal API
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    server.start()
    n = engine.warmup()
    server.mark_ready()
    if reload_mgr is not None:
        # after warmup: a swap relies on the warm shapes
        reload_mgr.start()
    log.info("ready: %d warm shape(s) over %d bucket(s) x %s batch "
             "rung(s) on port %d (params step %s)", n, len(engine.buckets),
             engine.rungs, server.port, engine.params_step)
    # a timed wait: a signal the kernel hands to another thread of the
    # process (CUDA's, the HTTP server's) runs its Python handler only when
    # the main thread next runs bytecode, and an untimed wait never would
    while not stop.wait(timeout=1.0):
        pass
    log.info("signal received: draining")
    server.drain()
    if reload_mgr is not None:
        reload_mgr.stop()
    engine.close()
    if tracer is not None and args.trace_file:
        tracer.flush()
    log.info("ROIAlign kernel launches in this process: %s",
             json.dumps(KERNELS.launch_counts()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
