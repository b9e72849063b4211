"""Offline COCO evaluation of a training checkpoint of the port (the
counterpart of ``tools/eval_ckpt.py``): point it at a training
``--logdir`` and a COCO-layout dataset; it restores the newest
checkpoint that verifies (or ``--step``) into the model the config
builds and runs ``evalcoco.run_evaluation`` on the split, then prints
one JSON line with the AP dict::

    python -m eksml_tpu_torch.tools.eval_ckpt --logdir RUN --data BASE \\
        [--split val2017] [--step N] [--max-images N] [--out FILE] \\
        [--device cuda] [--config KEY=VALUE ...]

``--config`` must give the training run's architecture (the same
overrides it trained with).  It reads the checkpoint only: nothing is
written into the run's logdir.  Runs on ``cuda`` unless ``--device cpu``
and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="COCO AP of a training checkpoint of the port")
    p.add_argument("--logdir", required=True)
    p.add_argument("--data", required=True, help="COCO-layout basedir")
    p.add_argument("--split", default="val2017")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: the newest that "
                        "verifies)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--config", nargs="*", default=[],
                   help="KEY=VALUE overrides — must match the training "
                        "run's model architecture")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from eksml_tpu_torch.config import config as global_cfg
    from eksml_tpu_torch.config import finalize_configs
    from eksml_tpu_torch.data.coco import CocoDataset
    from eksml_tpu_torch.device import resolve_device
    from eksml_tpu_torch.evalcoco import run_evaluation
    from eksml_tpu_torch.models import MaskRCNN
    from eksml_tpu_torch.train import cast_for_storage
    from eksml_tpu_torch.utils.checkpoint import CheckpointManager

    device = resolve_device(args.device)
    cfg = global_cfg.clone()
    cfg.freeze(False)
    cfg.DATA.BASEDIR = args.data
    cfg.TRAIN.LOGDIR = args.logdir
    # the checkpoint supplies every parameter; cleared before the
    # overrides so an explicit BACKBONE.WEIGHTS still wins
    cfg.BACKBONE.WEIGHTS = ""
    cfg.update_args(list(args.config))
    cfg = finalize_configs(True, cfg)
    logdir, data_dir = cfg.TRAIN.LOGDIR, cfg.DATA.BASEDIR

    model = MaskRCNN.from_config(cfg).to(device)
    cast_for_storage(model, cfg.TRAIN.PARAM_DTYPE)

    def load_into(state):
        model.load_state_dict(state["model"])

    ckpt = CheckpointManager(logdir)
    if args.step is None:
        found = ckpt.restore_with_fallback(load_into)
        if found is None:
            print("eval_ckpt: no verified checkpoint under "
                  f"{ckpt.directory}", file=sys.stderr)
            return 1
        at_step = found[1]
    else:
        try:
            load_into(ckpt.restore(args.step))
        except Exception as e:  # noqa: BLE001 — pruned or missing step
            print(f"eval_ckpt: restore of step {args.step} failed ({e!r}); "
                  f"available: {ckpt.all_steps()}", file=sys.stderr)
            # one process, no process group: the eval's gather never runs
            return 1  # eksml-lint: disable=collective-order
        at_step = args.step
    model.eval()

    records = CocoDataset(data_dir, args.split).records(skip_empty=False)
    t0 = time.time()
    with torch.no_grad():
        results = run_evaluation(model, cfg, records,
                                 max_images=args.max_images, device=device)
    payload = {"logdir": logdir, "step": int(at_step), "split": args.split,
               "num_images": (min(args.max_images, len(records))
                              if args.max_images else len(records)),
               "eval_seconds": round(time.time() - t0, 1),
               **{k: float(v) for k, v in results.items()}}
    print(json.dumps(payload), flush=True)
    if args.out:
        from eksml_tpu_torch.fsio import atomic_write_json

        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        atomic_write_json(args.out, payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
