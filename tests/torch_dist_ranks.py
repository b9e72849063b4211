"""Rank side of the port's multi-process CPU tests
(``tests/test_torch_distributed.py``): one process of a gloo group,
started with the JobSet env so that ``initialize_from_env`` itself forms
the group.  Imports torch, numpy and the port only (never JAX).

    python tests/torch_dist_ranks.py <scenario> <workdir>

``step``: one training step under ``replicated`` and one under
``fsdp`` from the weights, global batch and global priorities in
``<workdir>/inputs.pt`` (this rank takes its rows), then the preemption
agreement and the replica sync check.  ``resume``: checkpoints saved at
world 2 under ``fsdp`` and restored under ``replicated``, a world-1
checkpoint restored at world 2, and the refusal with
``RESILIENCE.ELASTIC_RESUME`` off.  ``eval``: the sharded
``run_evaluation`` with the ground-truth stub (square and bucketed), with
the model, and with a predict that raises on rank 1 only.
``fsdp_eval``: ``Trainer._run_eval`` under ``fsdp`` with
``PREPROC.BUCKETS`` over shards of unequal batch counts.  Each rank
writes ``<workdir>/<scenario>-rank<r>.pt``.  ``exporter`` (no inputs):
one step of ``Trainer.fit`` per rank in one shared logdir with the
telemetry exporter on the fixed port ``$EKSML_TEST_HTTP_PORT`` and a
liveness bound; prints ``EXPORTER 1`` where this rank's exporter bound
(its port file), ``EXPORTER 0`` elsewhere.

``shape_records`` and ``gt_stub`` are also the single-process tests'
inputs (``tests/test_torch_evalcoco.py``).
"""

import os
import shutil
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from eksml_tpu_torch.evalcoco import runner  # noqa: E402
from eksml_tpu_torch.parallel import distributed  # noqa: E402
from eksml_tpu_torch.parallel.collectives import \
    assert_replicas_in_sync  # noqa: E402
from eksml_tpu_torch.parallel.sharding import ShardingPlan  # noqa: E402
from eksml_tpu_torch.resilience import PreemptionHandler  # noqa: E402
from eksml_tpu_torch.train import (Trainer, make_optimizer,  # noqa: E402
                                   make_train_step)
from eksml_tpu_torch.utils.checkpoint import full_state_dict  # noqa: E402


def rank_cfg(overrides, *extra):
    cfg = t_config.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(overrides) + ["TELEMETRY.PORT=0"] + list(extra))
    cfg.freeze()
    return cfg


def own_rows(tree, rank, b):
    return {k: v[rank * b:(rank + 1) * b] for k, v in tree.items()}


def scenario_step(inputs, rank):
    out = {}
    b = inputs["per_rank"]
    batch = own_rows(inputs["batch"], rank, b)
    pri = own_rows(inputs["priorities"], rank, b)
    for strategy in ("replicated", "fsdp"):
        cfg = rank_cfg(inputs["overrides"],
                       f"TRAIN.SHARDING.STRATEGY={strategy}")
        model = MaskRCNN.from_config(cfg)
        model.load_state_dict(inputs["params"])
        model.train()
        plan = ShardingPlan.from_config(cfg)
        wrapped = plan.wrap(model)
        opt, sched = make_optimizer(model, cfg)
        # the raw (averaged) gradients, before the step clips them
        losses = wrapped(batch, pri)
        losses["total_loss"].backward()
        grads = {n: (p.grad.full_tensor() if hasattr(p.grad, "full_tensor")
                     else p.grad).clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        step = make_train_step(wrapped, opt, sched,
                               float(cfg.TRAIN.GRADIENT_CLIP),
                               norm_group=plan.norm_group)
        metrics = step(batch, pri, 0)
        out[strategy] = {
            "local_losses": {k: float(v) for k, v in losses.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads,
            "params": {k: v.clone() for k, v in
                       full_state_dict(model).items()},
            "describe": plan.describe(),
            "mesh": (plan.mesh_shape, plan.mesh_axes),
        }

    # preemption agreement: only rank 1 is signalled
    handler = PreemptionHandler()
    if rank == 1:
        handler.request()
    out["preempt"] = [handler.should_checkpoint(s, 2) for s in (3, 4)]

    # the replica sync check: in sync, then one rank's parameter and then
    # one rank's generator perturbed
    cfg = rank_cfg(inputs["overrides"])
    model = MaskRCNN.from_config(cfg)
    model.load_state_dict(inputs["params"])
    gen = torch.Generator().manual_seed(5)
    sync = {"in_sync": assert_replicas_in_sync(model.state_dict(),
                                               gen.get_state())}
    for what in ("param", "generator"):
        if rank == 1 and what == "param":
            with torch.no_grad():
                model.fpn.lateral_2.bias[0] += 1e-3
        if rank == 1 and what == "generator":
            model.load_state_dict(inputs["params"])
            gen.manual_seed(6)
        try:
            assert_replicas_in_sync(model.state_dict(), gen.get_state())
            sync[what] = "passed"
        except AssertionError as e:
            sync[what] = str(e)
    out["sync"] = sync
    return out


def fit_one(cfg, logdir, params, batch, **kw):
    trainer = Trainer(cfg, logdir, device="cpu")
    trainer.init_state(params)
    rows = trainer.fit(iter([batch]), 1, **kw)
    trainer.ckpt.wait()
    return trainer, rows


def state_of(trainer):
    s = trainer.checkpoint_state()
    return {"model": {k: v.clone() for k, v in s["model"].items()},
            "momentum": {i: v["momentum_buffer"].clone()
                         for i, v in s["optimizer"]["state"].items()},
            "generator": s["generator"].clone(), "step": s["step"]}


def restore(cfg, logdir):
    trainer = Trainer(cfg, logdir, device="cpu")
    try:
        step = trainer.restore_or_init()
        return step, state_of(trainer)
    finally:
        trainer.close()


def scenario_resume(inputs, rank, workdir):
    out = {}
    b = inputs["per_rank"]
    batch = own_rows(inputs["np_batch"], rank, b)
    fsdp = rank_cfg(inputs["overrides"], "TRAIN.SHARDING.STRATEGY=fsdp")
    repl = rank_cfg(inputs["overrides"], "TRAIN.SYNC_CHECK_PERIOD=1")
    w2 = os.path.join(workdir, "w2_fsdp")
    trainer, rows = fit_one(fsdp, w2, inputs["params"], batch)
    out["rows"] = rows
    out["live"] = state_of(trainer)
    out["topology"] = trainer.ckpt.topology
    trainer.close()
    distributed.barrier()
    # the same step restored under replicated (after a sync-checked step
    # of its own on a copy, which must stay in sync)
    out["w2_under_replicated"] = restore(repl, w2)
    if distributed.is_coordinator():
        shutil.copytree(w2, os.path.join(workdir, "w2_copy"))
    distributed.barrier()
    t = Trainer(repl, os.path.join(workdir, "w2_copy"), device="cpu")
    out["synced_rows"] = t.fit(iter([batch]), 2)
    t.close()
    # the world-1 step, restored at world 2 under each strategy
    w1 = os.path.join(workdir, "w1")
    out["w1_under_fsdp"] = restore(fsdp, w1)
    out["w1_under_replicated"] = restore(repl, w1)
    # refused with ELASTIC_RESUME off
    strict = rank_cfg(inputs["overrides"], "TRAIN.SHARDING.STRATEGY=fsdp",
                      "RESILIENCE.ELASTIC_RESUME=False")
    try:
        restore(strict, w1)
        out["strict"] = "restored"
    except RuntimeError as e:
        out["strict"] = str(e)
    return out


# ---------------------------------------------------------------------
# eval across ranks
# ---------------------------------------------------------------------

# distinct resized sizes at the 128 test resolution, so a stub can tell
# the images apart by their content size: (50, 100) -> (64, 128), ...
SIZES = [(50, 100), (100, 50), (60, 80), (80, 60), (64, 100), (48, 100)]
# canvases divisible by the largest anchor stride (64): the anchors of a
# level count H // stride rows, and P6 rounds up
EVAL_BUCKETS = "PREPROC.BUCKETS=((64,128),(128,64),(128,128))"
EVAL_OVERRIDES = ("PREPROC.TEST_SHORT_EDGE_SIZE=128",
                  "RPN.TEST_PRE_NMS_TOPK=64", "RPN.TEST_POST_NMS_TOPK=32",
                  "DATA.NUM_WORKERS=2")
STUB_DETS = 8
_t = (np.arange(28) + 0.5) / 28
#: the records' trapezoid (full top edge, half-width bottom edge) as a
#: 28² mask probability
TRAPEZOID = 0.6 * ((_t[None, :] >= _t[:, None] / 4)
                   & (_t[None, :] <= 1 - _t[:, None] / 4))


def shape_records(seed=0, n=len(SIZES)):
    """Records with 4-vertex polygon segmentations and their pixels
    (``_image``), one per size of SIZES."""
    rng = np.random.RandomState(seed)
    recs = []
    for i, (h, w) in enumerate(SIZES[:n]):
        boxes, segs = [], []
        for _ in range(rng.randint(1, 4)):
            bw, bh = rng.randint(12, w // 2), rng.randint(12, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            boxes.append([x, y, x + bw, y + bh])
            segs.append([[x, y, x + bw, y, x + 0.75 * bw, y + bh,
                          x + 0.25 * bw, y + bh]])
        k = len(boxes)
        recs.append({
            "image_id": 100 + i, "path": None, "height": h, "width": w,
            "boxes": np.asarray(boxes, np.float32),
            "classes": rng.randint(1, 5, k).astype(np.int32),
            "iscrowd": np.zeros(k, np.int32), "segmentation": segs,
            "area": np.asarray([0.75 * (b[2] - b[0]) * (b[3] - b[1])
                                for b in boxes]),
            "_image": rng.randint(0, 255, (h, w, 3)).astype(np.uint8)})
    return recs


def gt_stub(records, seen=None):
    """A predict function (either package's signature) that returns the
    ground truth with seeded jitter, in resized coordinates, for the
    image whose content size is the row's ``hw``."""
    by_hw = {}
    for rec in records:
        s = min(128 / min(rec["height"], rec["width"]),
                128 / max(rec["height"], rec["width"]))
        by_hw[(int(round(rec["height"] * s)),
               int(round(rec["width"] * s)))] = (rec, s)

    def stub(_model, images, hw):
        hw = np.asarray(hw)
        b, d = hw.shape[0], STUB_DETS
        if seen is not None:
            seen.append(tuple(np.asarray(images).shape[1:3]))
        out = {"boxes": np.zeros((b, d, 4), np.float32),
               "scores": np.zeros((b, d), np.float32),
               "classes": np.zeros((b, d), np.int32),
               "valid": np.zeros((b, d), np.float32),
               "masks": np.zeros((b, d, 28, 28), np.float32)}
        for i in range(b):
            hit = by_hw.get((int(hw[i, 0]), int(hw[i, 1])))
            if hit is None:
                continue  # padding row
            rec, s = hit
            rng = np.random.RandomState(rec["image_id"])
            n = len(rec["boxes"])
            out["boxes"][i, :n] = rec["boxes"] * s + rng.randn(n, 4) * 2
            out["scores"][i, :n] = rng.rand(n)
            out["classes"][i, :n] = rec["classes"]
            out["valid"][i, :n] = 1.0
            out["masks"][i, :n] = TRAPEZOID + rng.rand(n, 28, 28) * 0.3
        return out

    return stub


def recording_predict(log):
    """``runner.predict`` that keeps each row's outputs by its content
    size (the key the tests compare ranks and one process on)."""
    def predict(model, images, hw):
        out = runner.predict(model, images, hw)
        for i, key in enumerate(hw.round().int().tolist()):
            if key != [1, 1]:   # a padding row
                log[tuple(key)] = {k: v[i].clone() for k, v in out.items()}
        return out
    return predict


def scenario_eval(inputs, rank):
    out = {}
    records = inputs["records"]
    for name, extra in (("stub", ()), ("stub_bucketed", (EVAL_BUCKETS,))):
        cfg = rank_cfg(inputs["overrides"], *extra)
        out[name] = runner.run_evaluation(None, cfg, records, batch_size=2,
                                          predict_fn=gt_stub(records),
                                          device="cpu")
    cfg = rank_cfg(inputs["overrides"])
    model = MaskRCNN.from_config(cfg)
    model.load_state_dict(inputs["params"])
    out["model_outputs"] = {}
    out["model"] = runner.run_evaluation(
        model, cfg, records, batch_size=2, device="cpu",
        predict_fn=recording_predict(out["model_outputs"]))

    def fails_on_rank_1(m, images, hw):
        if rank == 1:
            raise ValueError("predict failed on purpose")
        return gt_stub(records)(m, images, hw)

    try:
        runner.run_evaluation(None, cfg, records, batch_size=2,
                              predict_fn=fails_on_rank_1, device="cpu")
        out["error"] = None
    except Exception as e:  # noqa: BLE001 — recorded for the test
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def scenario_fsdp_eval(inputs, rank, workdir):
    """``Trainer._run_eval`` under ``fsdp`` and ``PREPROC.BUCKETS``: 5
    records over 2 ranks at ``TEST.EVAL_BATCH_SIZE=1``, so rank 0 runs 3
    predict batches and rank 1 runs 2."""
    from eksml_tpu_torch.evalcoco import make_eval_fn

    cfg = rank_cfg(inputs["overrides"], "TRAIN.SHARDING.STRATEGY=fsdp",
                   EVAL_BUCKETS, "TEST.EVAL_BATCH_SIZE=1")
    outputs, seen, results = {}, [], {}
    inner = make_eval_fn(cfg, device="cpu", records=inputs["records"],
                         predict_fn=recording_predict(outputs))

    def eval_fn(model, step):
        seen.append({"sharded": hasattr(model, "unshard"),
                     "is_trainer_model": model is trainer.model})
        results.update(inner(model, step))
        return results

    trainer = Trainer(cfg, os.path.join(workdir, "fsdp_eval"), device="cpu",
                      eval_fn=eval_fn)
    trainer.init_state(inputs["params"])
    trainer._run_eval(1)
    still_sharded = all(hasattr(p, "to_local")
                        for p in trainer.model.parameters())
    trainer.close()
    return {"results": results, "outputs": outputs, "seen": seen,
            "still_sharded": still_sharded}


def scenario_exporter(rank, workdir):
    import logging

    from eksml_tpu_torch.data.loader import DetectionLoader, SyntheticDataset

    logging.basicConfig(level=logging.INFO, stream=sys.stdout, force=True)
    cfg = rank_cfg(t_config.SMOKE_OVERRIDES, "TRAIN.BATCH_SIZE_PER_CHIP=1",
                   "TRAIN.NUM_CHIPS=2", "TRAIN.LOG_PERIOD=1",
                   f"TELEMETRY.PORT={os.environ['EKSML_TEST_HTTP_PORT']}",
                   "TELEMETRY.HEALTHZ_STALE_SEC=600")
    ds = SyntheticDataset(num_images=4, height=128, width=128,
                          num_classes=cfg.DATA.NUM_CLASSES)
    loader = DetectionLoader(ds.records(), cfg, 1, num_hosts=2,
                             host_id=rank, gt_mask_size=28)
    logdir = os.path.join(workdir, "exporter")
    trainer = Trainer(cfg, logdir, device="cpu")
    trainer.init_state()
    trainer.fit(loader.batches(1), 1)
    trainer.close()
    bound = os.path.exists(os.path.join(logdir,
                                        f"telemetry-host{rank}.port"))
    print(f"EXPORTER {int(bound)}", flush=True)


def main():
    scenario, workdir = sys.argv[1], sys.argv[2]
    assert distributed.initialize_from_env(device="cpu")
    rank = distributed.process_index()
    if scenario == "exporter":
        try:
            scenario_exporter(rank, workdir)
        finally:
            distributed.shutdown()
        return
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    try:
        if scenario == "step":
            out = scenario_step(inputs, rank)
        elif scenario == "eval":
            out = scenario_eval(inputs, rank)
        elif scenario == "fsdp_eval":
            out = scenario_fsdp_eval(inputs, rank, workdir)
        else:
            out = scenario_resume(inputs, rank, workdir)
        out["world"] = distributed.process_count()
        torch.save(out, os.path.join(workdir, f"{scenario}-rank{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
