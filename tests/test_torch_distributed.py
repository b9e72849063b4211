"""The port's multi-GPU slice on the CPU: two gloo ranks, each started by
the JobSet env (``tests/torch_dist_ranks.py``, which imports no JAX), at
SMOKE widths on 128² images.

- One step under ``replicated`` (DDP) and one under ``fsdp`` (FSDP2),
  each rank on its own image of ``test_torch_train``'s batch, equal the
  port's one-process step on the concatenated batch: losses to 1e-5
  relative, every gradient tensor and every updated parameter tensor to
  1e-5 of its largest magnitude (measured: 2.8e-6 at most; the two sum
  the images' gradients in other orders, and a zero-initialised bias
  after one step is its update, so cancellation shows there).  They also equal the JAX step at ``test_torch_train``'s
  tolerances (losses 1e-4 relative, gradients 1e-4 of the largest, the
  update 1e-3 of the largest).  The two images have unequal foreground.
- SIGTERM on one rank is agreed by both; the replica sync check raises
  on both ranks when one rank's parameter or generator differs.
- A step saved at world 2 under ``fsdp`` restores bitwise at world 1
  and under ``replicated``; a world-1 step restores bitwise at world 2
  under either; with ``RESILIENCE.ELASTIC_RESUME`` off it is refused.

Each scenario group is one launch of two processes (module fixtures).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

jax.config.update("jax_platforms", "cpu")

import optax  # noqa: E402

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu import train as j_train  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.data import loader as j_loader  # noqa: E402
from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN  # noqa: E402
from eksml_tpu.ops import anchors as j_anchors  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.convert import (flax_leaves, from_flax,  # noqa: E402
                                     init_params)
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from eksml_tpu_torch.models import rpn as t_rpn  # noqa: E402
from eksml_tpu_torch.parallel.sharding import ShardingPlan  # noqa: E402
from test_torch_train import _close, jax_priorities  # noqa: E402

IMG = 128
LOSS_KEYS = ("rpn_cls_loss", "rpn_box_loss", "frcnn_cls_loss",
             "frcnn_box_loss", "mrcnn_loss", "total_loss")
OVERRIDES = list(SMOKE_OVERRIDES) + [
    "PREPROC.DEVICE_NORMALIZE=False", "TRAIN.GRADIENT_CLIP=5.0",
    "TRAIN.BASE_LR=0.1", "TRAIN.WARMUP_STEPS=0", "TELEMETRY.PORT=0"]
ONE = ["TRAIN.BATCH_SIZE_PER_CHIP=2", "TRAIN.NUM_CHIPS=1"]
TWO = ["TRAIN.BATCH_SIZE_PER_CHIP=1", "TRAIN.NUM_CHIPS=2"]
RANKS = os.path.join(REPO, "tests", "torch_dist_ranks.py")
STRATEGIES = ("replicated", "fsdp")


def cfg_of(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(OVERRIDES + list(extra))
    cfg.freeze()
    return cfg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(scenario, workdir, local_form, timeout=240):
    """Two ranks of ``torch_dist_ranks.py``, formed by the JobSet env:
    two hosts (``NUM_PROCESSES``/``PROCESS_ID``) or, with
    ``local_form``, one host of two (``LOCAL_WORLD_SIZE``/
    ``LOCAL_RANK``).  Returns each rank's output."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("PROCESS_ID", "SLICE_INDEX", "JOB_COMPLETION_INDEX",
                         "LOCAL_RANK", "LOCAL_WORLD_SIZE", "NUM_PROCESSES")}
    base.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", OMP_NUM_THREADS="2",
                PYTHONPATH=REPO)
    procs = []
    for r in range(2):
        env = dict(base)
        if local_form:
            env.update(NUM_PROCESSES="1", JOB_COMPLETION_INDEX="0",
                       LOCAL_WORLD_SIZE="2", LOCAL_RANK=str(r))
        else:
            env.update(NUM_PROCESSES="2", PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, RANKS, scenario, str(workdir)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
    return [torch.load(os.path.join(workdir, f"{scenario}-rank{r}.pt"),
                       weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def ref():
    """The batch of ``test_torch_train``, one seeded Flax init, the JAX
    priorities of the global batch, the JAX step on it, and the port's
    one-process step on it."""
    jcfg = j_config.config.clone()
    jcfg.freeze(False)
    jcfg.update_args(OVERRIDES + ONE)
    jcfg.freeze()
    batch = j_loader.make_synthetic_batch(jcfg, batch_size=2, image_size=IMG,
                                          seed=7, gt_mask_size=28)
    batch = {k: v for k, v in batch.items()
             if k not in ("image_scale", "image_id")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flax_model = FlaxMaskRCNN.from_config(jcfg)
    key = jax.random.PRNGKey(42)
    # the port's seeded init as a Flax tree (no JAX init to compile)
    tcfg = cfg_of(t_config, *ONE)
    params = {}
    for name, t in flax_leaves(init_params(
            tcfg, torch.Generator().manual_seed(42))):
        *path, leaf = name.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(np.ascontiguousarray(t.numpy()))

    def loss_fn(p, b, r):
        losses = flax_model.apply({"params": p}, b, r)
        return losses["total_loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jb, key)
    tx, _ = j_train.make_optimizer(jcfg)
    new = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, params)
    a = sum(j_anchors.num_anchors_per_level(
        (IMG, IMG), tuple(jcfg.FPN.ANCHOR_STRIDES), 3))
    n = jcfg.RPN.TRAIN_POST_NMS_TOPK + jcfg.DATA.MAX_GT_BOXES
    pri = {k: torch.from_numpy(np.array(v))
           for k, v in jax_priorities(key, 2, a, n).items()}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    p0 = from_flax(jax.device_get(params))

    # the port, one process, the concatenated batch
    model = MaskRCNN.from_config(tcfg)
    model.load_state_dict(p0)
    model.train()
    out = model(tbatch, pri)
    out["total_loss"].backward()
    port_grads = {nm: p.grad.clone() for nm, p in model.named_parameters()
                  if p.grad is not None}
    opt, sched = t_train.make_optimizer(model, tcfg)
    metrics = t_train.make_train_step(model, opt, sched, 5.0)(tbatch, pri, 0)
    return {"batch": tbatch, "np_batch": batch, "priorities": pri,
            "params": p0, "cfg": tcfg,
            "jax_losses": {k: float(v) for k, v in losses.items()},
            "jax_grads": from_flax(jax.device_get(grads)),
            "jax_params": from_flax(jax.device_get(new)),
            "port_metrics": {k: float(v) for k, v in metrics.items()},
            "port_grads": port_grads,
            "port_params": {k: v.clone() for k, v in
                            model.state_dict().items()}}


@pytest.fixture(scope="module")
def step_ranks(ref, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("step")
    torch.save({"per_rank": 1, "batch": ref["batch"],
                "priorities": ref["priorities"], "params": ref["params"],
                "overrides": OVERRIDES + TWO},
               os.path.join(workdir, "inputs.pt"))
    return launch("step", workdir, local_form=False)


@pytest.fixture(scope="module")
def resume_ranks(ref, tmp_path_factory):
    """A world-1 checkpoint of one step (written here), then the ranks'
    scenario, then this process restores the ranks' world-2 step."""
    workdir = tmp_path_factory.mktemp("resume")
    cfg = cfg_of(t_config, *ONE)
    trainer = t_train.Trainer(cfg, os.path.join(workdir, "w1"), device="cpu")
    trainer.init_state(ref["params"])
    trainer.fit(iter([ref["np_batch"]]), 1)
    trainer.close()
    saved_w1 = trainer.ckpt.restore()
    torch.save({"per_rank": 1, "np_batch": ref["np_batch"],
                "params": ref["params"], "overrides": OVERRIDES + TWO},
               os.path.join(workdir, "inputs.pt"))
    ranks = launch("resume", workdir, local_form=True)
    out = {"ranks": ranks, "w1": saved_w1, "workdir": workdir}
    for name, extra in (("w2_at_world1", ()),
                        ("w2_at_world1_fsdp", ("TRAIN.SHARDING.STRATEGY=fsdp",))):
        t = t_train.Trainer(cfg_of(t_config, *ONE, *extra),
                            os.path.join(workdir, "w2_fsdp"), device="cpu")
        step = t.restore_or_init()
        out[name] = (step, t.checkpoint_state())
        t.close()
    strict = t_train.Trainer(
        cfg_of(t_config, *ONE, "RESILIENCE.ELASTIC_RESUME=False"),
        os.path.join(workdir, "w2_fsdp"), device="cpu")
    with pytest.raises(RuntimeError) as err:
        strict.restore_or_init()
    strict.close()
    out["strict_world1"] = str(err.value)
    return out


# ---------------------------------------------------------------------
# one step at world 2 against one process and against JAX
# ---------------------------------------------------------------------


def test_the_two_images_have_unequal_foreground(ref):
    """Rank 0's image and rank 1's differ in GT objects and in the
    anchors the RPN matches as foreground."""
    b = ref["batch"]
    model = MaskRCNN.from_config(ref["cfg"])
    anchors = torch.cat(model._anchors((IMG, IMG), "cpu"))
    labels, _ = t_rpn.match_anchors(anchors, b["gt_boxes"], b["gt_valid"],
                                    0.7, 0.3, gt_crowd=b["gt_crowd"])
    fg = (labels == 1).sum(dim=1).tolist()
    gt = b["gt_valid"].sum(dim=1).tolist()
    assert fg[0] != fg[1] and gt[0] != gt[1], (fg, gt)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_two_ranks_equal_one_process(ref, step_ranks, strategy):
    for rank, out in enumerate(step_ranks):
        got = out[strategy]
        assert out["world"] == 2
        for k in LOSS_KEYS + ("grad_norm",):
            assert got["metrics"][k] == pytest.approx(
                ref["port_metrics"][k], rel=1e-5), (rank, k)
        assert set(got["grads"]) == set(ref["port_grads"])
        for name, want in ref["port_grads"].items():
            _close(got["grads"][name].numpy(), want.numpy(), 1e-5)
        assert set(got["params"]) == set(ref["port_params"])
        for name, want in ref["port_params"].items():
            _close(got["params"][name].numpy(), want.numpy(), 1e-5)
    # each rank saw only its own image: its local losses differ
    assert (step_ranks[0][strategy]["local_losses"]["total_loss"]
            != step_ranks[1][strategy]["local_losses"]["total_loss"])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_two_ranks_equal_jax(ref, step_ranks, strategy):
    got = step_ranks[0][strategy]
    for k in LOSS_KEYS:
        assert got["metrics"][k] == pytest.approx(ref["jax_losses"][k],
                                                  rel=1e-4), k
    params = dict(MaskRCNN.from_config(ref["cfg"]).named_parameters())
    for name, want in ref["jax_grads"].items():
        if name in params and params[name].requires_grad:
            _close(got["grads"][name].numpy(), want.numpy(), 1e-4)
    moved = 0
    for name, p0 in ref["params"].items():
        want = (ref["jax_params"][name] - p0).numpy()
        _close((got["params"][name] - p0).numpy(), want, 1e-3)
        moved += bool(np.abs(want).max() > 0)
    assert moved > 40


def test_plans_describe_their_mesh(step_ranks):
    out = step_ranks[0]
    assert out["replicated"]["describe"] == "replicated"
    assert out["replicated"]["mesh"] == ((2, 1), ("data", "model"))
    assert out["fsdp"]["describe"] == "fsdp(axis=2, rules=1)"
    assert out["fsdp"]["mesh"] == ((1, 2, 1), ("data", "fsdp", "model"))


# ---------------------------------------------------------------------
# agreement
# ---------------------------------------------------------------------


def test_preemption_is_agreed_across_ranks(step_ranks):
    """Only rank 1 was signalled; at the sync step (4, period 2) both
    ranks checkpoint, at the step between (3) neither does."""
    assert [out["preempt"] for out in step_ranks] == [[False, True]] * 2


def test_replica_sync_check_raises_on_every_rank(step_ranks):
    for out in step_ranks:
        sync = out["sync"]
        assert sync["in_sync"] is True
        assert "replicas diverged (params)" in sync["param"]
        assert "replicas diverged (sampling generator stream)" in \
            sync["generator"]


# ---------------------------------------------------------------------
# elastic resume across world size and strategy
# ---------------------------------------------------------------------


def _assert_same_state(got, want):
    """Bitwise: every model tensor, every momentum buffer, the generator
    and the step."""
    assert got["step"] == want["step"]
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    mg = {i: s["momentum_buffer"] for i, s in got["optimizer"]["state"].items()} \
        if "optimizer" in got else got["momentum"]
    mw = {i: s["momentum_buffer"] for i, s in want["optimizer"]["state"].items()} \
        if "optimizer" in want else want["momentum"]
    assert set(mg) == set(mw) and len(mw) > 40
    for i, v in mw.items():
        assert torch.equal(mg[i], v), i
    assert torch.equal(got["generator"], want["generator"])


def test_fsdp_world2_step_restores_at_world1(resume_ranks):
    live = resume_ranks["ranks"][0]["live"]
    for name in ("w2_at_world1", "w2_at_world1_fsdp"):
        step, state = resume_ranks[name]
        assert step == 1
        _assert_same_state(state, live)


def test_fsdp_world2_step_restores_under_replicated(resume_ranks):
    live = resume_ranks["ranks"][0]["live"]
    for out in resume_ranks["ranks"]:
        _assert_same_state(out["live"], live)       # gathered alike
        step, state = out["w2_under_replicated"]
        assert step == 1
        _assert_same_state(state, live)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_world1_step_restores_at_world2(resume_ranks, strategy):
    for out in resume_ranks["ranks"]:
        step, state = out[f"w1_under_{strategy}"]
        assert step == 1
        _assert_same_state(state, resume_ranks["w1"])


def test_restore_across_topologies_is_refused_without_elastic_resume(
        resume_ranks):
    for msg in [out["strict"] for out in resume_ranks["ranks"]] + [
            resume_ranks["strict_world1"]]:
        assert "RESILIENCE.ELASTIC_RESUME is off" in msg, msg
        assert "process_count: 1 -> 2" in msg or "process_count: 2 -> 1" \
            in msg, msg


def test_coordinator_writes_and_ranks_stay_in_sync(resume_ranks):
    """One checkpoint commit and one metrics file (rank 0's), a flight
    recorder per rank, the sync-checked step in sync, and the same
    logged losses on both ranks."""
    root = os.path.join(resume_ranks["workdir"], "w2_fsdp")
    assert sorted(n for n in os.listdir(os.path.join(root, "checkpoints"))
                  if n.isdigit()) == ["1"]
    assert os.path.exists(os.path.join(root, "metrics.jsonl"))
    assert {"events-host0.jsonl", "events-host1.jsonl"} <= set(
        os.listdir(root))
    topo = resume_ranks["ranks"][0]["topology"]
    assert topo["strategy"] == "fsdp" and topo["process_count"] == 2
    assert topo["mesh_shape"] == [1, 2, 1] and topo["fsdp_axis_size"] == 2
    rows = [out["rows"][-1] for out in resume_ranks["ranks"]]
    assert rows[0]["total_loss"] == rows[1]["total_loss"]
    assert rows[0]["hosts/count"] == 2.0
    synced = [out["synced_rows"][-1] for out in resume_ranks["ranks"]]
    assert synced[0]["step"] == 2 and synced[0]["total_loss"] == \
        synced[1]["total_loss"]


# ---------------------------------------------------------------------
# what this slice does not port
# ---------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["tensor", "2d"])
def test_tensor_parallel_strategies_raise(strategy):
    cfg = cfg_of(t_config, *ONE, f"TRAIN.SHARDING.STRATEGY={strategy}",
                 "TRAIN.SHARDING.MODEL_AXIS_SIZE=1")
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        ShardingPlan.from_config(cfg)
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        t_train.Trainer(cfg, "", device="cpu")


def test_custom_sharding_rules_raise():
    cfg = cfg_of(t_config, *ONE, "TRAIN.SHARDING.STRATEGY=fsdp",
                 "TRAIN.SHARDING.RULES=(('.*','replicated'),)")
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        ShardingPlan.from_config(cfg)
