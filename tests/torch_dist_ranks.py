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
``RESILIENCE.ELASTIC_RESUME`` off.  Each rank writes
``<workdir>/<scenario>-rank<r>.pt``.
"""

import os
import shutil
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
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
    cfg.update_args(list(overrides) + list(extra))
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


def main():
    scenario, workdir = sys.argv[1], sys.argv[2]
    assert distributed.initialize_from_env(device="cpu")
    rank = distributed.process_index()
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    try:
        if scenario == "step":
            out = scenario_step(inputs, rank)
        else:
            out = scenario_resume(inputs, rank, workdir)
        out["world"] = distributed.process_count()
        torch.save(out, os.path.join(workdir, f"{scenario}-rank{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
