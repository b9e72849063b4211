"""Input-pipeline throughput of the port's loader (its copy of
``tools/bench_loader.py``): the host must build decode + resize +
rasterize faster than the cards consume batches.  At batch 4 per card
a host of four cards takes 16 images per step (the default batch), one
of eight cards 32.

Builds ``--batches`` training batches of ``--batch-size`` images at the
``--image-size`` operating point from ``SyntheticDataset`` records of a
``--source-hw`` source through ``DetectionLoader`` on ``--workers``
threads, the first two batches apart (the pool's start), and prints ONE
JSON line::

    {"metric": "loader_throughput", "value": N,
     "unit": "images/sec/host", ...}

Run: ``python -m eksml_tpu_torch.tools.bench_loader [--batches 20]
[--workers 8]``.  Host only: it touches no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the port's loader bench")
    p.add_argument("--image-size", type=int, default=1344,
                   help="PREPROC.MAX_SIZE operating point")
    p.add_argument("--batch-size", type=int, default=16,
                   help="per-host batch (4 cards x batch 4)")
    p.add_argument("--batches", type=int, default=20)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--source-hw", type=int, nargs=2, default=(480, 640),
                   help="raw image size before resize (COCO median-ish)")
    p.add_argument("--no-masks", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Print and return the JSON line.  The global config is left as it
    was (the bench configures a clone)."""
    args = parse_args(argv)

    from eksml_tpu_torch.config import config as global_cfg
    from eksml_tpu_torch.data.loader import DetectionLoader, SyntheticDataset

    cfg = global_cfg.clone()
    cfg.freeze(False)
    cfg.PREPROC.MAX_SIZE = args.image_size
    cfg.PREPROC.TRAIN_SHORT_EDGE_SIZE = (args.image_size - 344,
                                         args.image_size - 320)
    cfg.freeze()

    h, w = args.source_hw
    ds = SyntheticDataset(num_images=64, height=h, width=w,
                          num_classes=cfg.DATA.NUM_CLASSES)
    loader = DetectionLoader(ds.records(), cfg, args.batch_size,
                             with_masks=not args.no_masks,
                             num_workers=args.workers)

    it = loader.batches(args.batches + 2)
    # warm: the first batches pay the thread pool's start
    next(it)
    next(it)
    t0 = time.time()
    n = 0
    for batch in it:
        n += batch["images"].shape[0]
        assert batch["images"].shape[1] == args.image_size
    dt = time.time() - t0
    per_sec = n / dt
    print(f"loader: {n} images in {dt:.1f}s "
          f"({args.workers} workers, masks={not args.no_masks})",
          file=sys.stderr)
    # the cores this process may run on (a container's share, not the
    # host's count)
    cores = len(os.sched_getaffinity(0)) or 1
    out = {
        "metric": "loader_throughput",
        "value": round(per_sec, 2),
        "unit": "images/sec/host",
        "images_per_sec_per_core": round(per_sec / cores, 2),
        "cpu_cores": cores,
        "image_size": args.image_size,
        "batch_size": args.batch_size,
        "workers": args.workers,
        "with_masks": not args.no_masks,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
