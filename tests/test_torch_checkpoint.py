"""The port's checkpoints and resume (``eksml_tpu_torch/utils/checkpoint.py``,
``Trainer.restore_or_init``/``fit``) on the CPU, held to the JAX package.

One explicit run of 4 batches: the JAX ``Trainer.fit`` to step 2 (a
checkpoint at 2), then a second ``fit(state=None)`` on the same Trainer,
which restores step 2 and takes steps 3-4 (one compile of the JAX step
for the file).  The port runs the same way from ``convert.from_flax`` of
the same init with the reference's priorities
(``jax_priorities(fold_in(PRNGKey(TRAIN.SEED), step))``), and once more
with its own generator.  SMOKE widths, 128 px, batch 2.

Tolerances: losses to 1e-4 relative and learning rates to 1e-6
(``tests/test_torch_train.py``); a resumed port run equals the
uninterrupted one bitwise (``torch.equal``).
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

jax.config.update("jax_platforms", "cpu")

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu import train as j_train  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.data import loader as j_loader  # noqa: E402
from eksml_tpu.models import backbone_loader as j_backbone  # noqa: E402
from eksml_tpu.ops import anchors as j_anchors  # noqa: E402
from eksml_tpu.utils import checkpoint as j_checkpoint  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.parallel import sharding as t_sharding  # noqa: E402
from eksml_tpu_torch.convert import from_flax  # noqa: E402
from eksml_tpu_torch.models.backbone_loader import load_r50_npz  # noqa: E402
from eksml_tpu_torch.resilience import integrity  # noqa: E402
from eksml_tpu_torch.utils import checkpoint as t_checkpoint  # noqa: E402

IMG = 128
BATCH = 2
LOSS_KEYS = ("rpn_cls_loss", "rpn_box_loss", "frcnn_cls_loss",
             "frcnn_box_loss", "mrcnn_loss", "total_loss")
RUN = ("PREPROC.DEVICE_NORMALIZE=False", f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}",
       "TRAIN.GRADIENT_CLIP=5.0", "TRAIN.BASE_LR=0.1",
       "TRAIN.WARMUP_STEPS=0", "TRAIN.STEPS_PER_EPOCH=2",
       "TRAIN.CHECKPOINT_PERIOD=1", "TRAIN.LOG_PERIOD=1",
       # an ephemeral exporter port: the xdist workers never share 9090
       "TELEMETRY.PORT=0")


def tiny_cfg(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + list(RUN) + list(extra))
    if config_mod is j_config:
        cfg.TPU.MESH_SHAPE = (1, 1)
        cfg.TELEMETRY.ENABLED = False
    cfg.freeze()
    return cfg


def jax_priorities(rng, b, a, n):
    """The priorities the Flax model draws from ``rng`` (as
    ``tests/test_torch_train.py``)."""
    rngs = jax.random.split(rng, (b, 2))

    def pair(r, size):
        f, g = jax.random.split(r)
        return (jax.random.uniform(f, (size,)),
                jax.random.uniform(g, (size,)))

    rpn_fg, rpn_bg = jax.vmap(lambda r: pair(r, a))(rngs[:, 0])
    fr_fg, fr_bg = jax.vmap(lambda r: pair(r, n))(rngs[:, 1])
    return {"rpn_fg": rpn_fg, "rpn_bg": rpn_bg, "frcnn_fg": fr_fg,
            "frcnn_bg": fr_bg}


def reference_priorities(cfg):
    """``Trainer._priorities`` of the reference: fold the step into
    ``PRNGKey(TRAIN.SEED)``."""
    key = jax.random.PRNGKey(cfg.TRAIN.SEED)
    a = sum(j_anchors.num_anchors_per_level(
        (IMG, IMG), tuple(cfg.FPN.ANCHOR_STRIDES), 3))
    n = cfg.RPN.TRAIN_POST_NMS_TOPK + cfg.DATA.MAX_GT_BOXES

    def priorities(batch, step):
        pri = jax_priorities(jax.random.fold_in(key, step), BATCH, a, n)
        return {k: torch.from_numpy(np.array(v)) for k, v in pri.items()}

    return priorities


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r for r in rows if "total_loss" in r}


@pytest.fixture(scope="module")
def batches():
    jcfg = tiny_cfg(j_config)
    ds = j_loader.SyntheticDataset(num_images=8, height=IMG, width=IMG,
                                   num_classes=jcfg.DATA.NUM_CLASSES, seed=3)
    loader = j_loader.DetectionLoader(ds.records(), jcfg, BATCH, seed=3,
                                      gt_mask_size=28, prefetch=1)
    return list(loader.batches(4))


@pytest.fixture(scope="module")
def jax_run(batches, tmp_path_factory):
    """The reference: fit to 2 from its init, then resume to 4."""
    jcfg = tiny_cfg(j_config)
    logdir = str(tmp_path_factory.mktemp("jax_run"))
    trainer = j_train.Trainer(jcfg, logdir)
    state0 = trainer.init_state({k: v for k, v in batches[0].items()
                                 if k not in ("image_scale", "image_id")})
    init = jax.device_get(state0.params)
    trainer.fit(iter(batches[:2]), 2, state=state0)
    trainer.fit(iter(batches[2:]), 4, state=None)
    steps = trainer.ckpt.all_steps()
    trainer.ckpt.close()
    return {"init": init, "rows": _rows(logdir), "steps": steps}


def _port_pair(tcfg, init, batches, logdir, patch):
    """Run A: 2 steps (checkpoint 2), then on, live, to 4.  Run B: a new
    Trainer on a copy of A's logdir at step 2 resumes to 4."""
    a_dir, b_dir = os.path.join(logdir, "a"), os.path.join(logdir, "b")
    ta = t_train.Trainer(tcfg, a_dir, device="cpu")
    ta.init_state(from_flax(init))
    if patch:
        ta._priorities = patch
    rows = ta.fit(iter(batches[:2]), 2)
    ta.ckpt.wait()
    shutil.copytree(a_dir, b_dir)
    tb = t_train.Trainer(tcfg, b_dir, device="cpu")
    if patch:
        tb._priorities = patch
    rows_b = tb.fit(iter(batches[2:]), 4)
    rows_a = rows + ta.fit(iter(batches[2:]), 4, start_step=2)
    ta.close()
    tb.close()
    return ta, tb, rows_a, rows_b


@pytest.fixture(scope="module")
def port_runs(jax_run, batches, tmp_path_factory):
    tcfg = tiny_cfg(t_config)
    out = {}
    for source in ("jax-priorities", "generator"):
        patch = reference_priorities(tcfg) if source == "jax-priorities" \
            else None
        out[source] = _port_pair(tcfg, jax_run["init"], batches,
                                 str(tmp_path_factory.mktemp(source)), patch)
    return out


# ---------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------


@pytest.mark.parametrize("source", ["jax-priorities", "generator"])
def test_resume_is_exact(port_runs, source):
    """The resumed run's steps 3-4 equal the uninterrupted run's bitwise:
    losses, every model tensor, every momentum buffer, the generator."""
    ta, tb, rows_a, rows_b = port_runs[source]
    assert [r["step"] for r in rows_a] == [1, 2, 3, 4]
    assert [r["step"] for r in rows_b] == [3, 4]
    for ra, rb in zip(rows_a[2:], rows_b):
        for k in LOSS_KEYS + ("grad_norm", "learning_rate"):
            assert ra[k] == rb[k], (ra["step"], k)
    sa, sb = ta.checkpoint_state(), tb.checkpoint_state()
    assert sa["step"] == sb["step"] == 4
    assert set(sa["model"]) == set(sb["model"])
    for k in sa["model"]:
        assert torch.equal(sa["model"][k], sb["model"][k]), k
    ma, mb = sa["optimizer"]["state"], sb["optimizer"]["state"]
    assert len(ma) == len(mb) > 40
    for i in ma:
        assert torch.equal(ma[i]["momentum_buffer"],
                           mb[i]["momentum_buffer"]), i
    assert torch.equal(sa["generator"], sb["generator"])
    assert ta.ckpt.all_steps() == tb.ckpt.all_steps() == [2, 4]


def test_resumed_run_matches_jax(jax_run, port_runs):
    """Per-step losses and learning rates of the reference's
    fit-then-resume against the port's, and the same checkpoint
    steps."""
    ta, tb, rows_a, rows_b = port_runs["jax-priorities"]
    port = {r["step"]: r for r in rows_a[:2] + rows_b}
    want = jax_run["rows"]
    assert sorted(want) == sorted(port) == [1, 2, 3, 4]
    for step in (1, 2, 3, 4):
        for k in LOSS_KEYS:
            assert port[step][k] == pytest.approx(want[step][k], rel=1e-4), \
                (step, k)
        assert port[step]["learning_rate"] == pytest.approx(
            want[step]["learning_rate"], rel=1e-6)
    assert jax_run["steps"] == tb.ckpt.all_steps() == [2, 4]


def test_prefetch_on_and_off_train_bitwise_alike(jax_run, batches, tmp_path):
    """``TRAIN.PREFETCH_TO_DEVICE`` changes neither the batch order nor
    the numbers; ``fit(it, 1)`` then ``fit(it, 3, start_step=1)`` takes
    exactly 3 batches from the caller's iterator."""
    states = {}
    for on in (True, False):
        cfg = tiny_cfg(t_config, f"TRAIN.PREFETCH_TO_DEVICE={on}")
        trainer = t_train.Trainer(cfg, str(tmp_path / str(on)), device="cpu")
        trainer.init_state(from_flax(jax_run["init"]))
        it = iter(batches)
        rows = trainer.fit(it, 1) + trainer.fit(it, 3, start_step=1)
        assert [r["step"] for r in rows] == [1, 2, 3]
        assert next(it) is batches[3]
        trainer.close()
        states[on] = (rows, trainer.model.state_dict())
    for k, v in states[True][1].items():
        assert torch.equal(v, states[False][1][k]), k
    assert [r["total_loss"] for r in states[True][0]] == \
        [r["total_loss"] for r in states[False][0]]


# ---------------------------------------------------------------------
# the manager against the reference's: walk back, quarantine, raise
# ---------------------------------------------------------------------


class _Jax:
    """The reference's Orbax manager over a one-array state."""

    def __init__(self, logdir):
        self.m = j_checkpoint.CheckpointManager(logdir)
        self.root = self.m.directory

    def save(self, step):
        self.m.save(step, {"w": jnp.full((64,), float(step))})
        self.m.wait()

    def restore(self, mismatch=False):
        like = {"v" if mismatch else "w": jnp.zeros((64,))}
        out = self.m.restore_with_fallback(like)
        return None if out is None else float(out[0]["w"][0]), out[1]

    def close(self):
        self.m.close()


class _Torch:
    def __init__(self, logdir):
        self.m = t_checkpoint.CheckpointManager(logdir)
        self.root = self.m.directory

    def save(self, step):
        self.m.save(step, {"w": torch.full((64,), float(step))})
        self.m.wait()

    def restore(self, mismatch=False):
        def load_into(state):
            if mismatch:
                raise ValueError("structure changed")

        out = self.m.restore_with_fallback(load_into)
        return None if out is None else float(out[0]["w"][0]), out[1]

    def close(self):
        self.m.close()


def _truncate_all(step_dir):
    for base, _, files in os.walk(step_dir):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "r+b") as fh:
                fh.truncate(os.path.getsize(path) // 2)


@pytest.mark.parametrize("case", ["corrupt_latest", "unverified_bad",
                                  "verified_bad"])
@pytest.mark.parametrize("impl", ["eksml_tpu", "eksml_tpu_torch"])
def test_walk_back_matches_the_reference(tmp_path, impl, case):
    """Steps 1-3 committed.  A truncated latest step fails verification:
    quarantined, step 2 restores.  A latest step without a manifest that
    fails to load: quarantined, step 2 restores.  A verified step that
    fails to load (a changed structure) raises and stays in place."""
    m = (_Jax if impl == "eksml_tpu" else _Torch)(str(tmp_path))
    try:
        for step in (1, 2, 3):
            m.save(step)
        step3 = os.path.join(m.root, "3")
        if case == "unverified_bad":
            os.remove(integrity.manifest_path(m.root, 3))
        if case != "verified_bad":
            _truncate_all(step3)
            assert m.restore() == (2.0, 2)
            assert not os.path.exists(step3)
            assert os.path.isdir(step3 + ".corrupt-0")
        else:
            with pytest.raises(RuntimeError, match="refusing to quarantine"):
                m.restore(mismatch=True)
            assert os.path.isdir(step3)
    finally:
        m.close()


def test_save_copies_to_host_before_returning(tmp_path):
    """The write runs in the background; the state it writes is the one
    of the call, whatever the caller does to its tensors afterwards."""
    m = t_checkpoint.CheckpointManager(str(tmp_path))
    w = torch.arange(1 << 20, dtype=torch.float32)
    buf = torch.ones(7)
    assert m.save(5, {"model": {"w": w}, "optimizer": {"state": {0: {
        "momentum_buffer": buf}}, "param_groups": [{"lr": 0.1}]}})
    w.mul_(-1)
    buf.zero_()
    m.wait()
    got = m.restore(5)
    assert torch.equal(got["model"]["w"],
                       torch.arange(1 << 20, dtype=torch.float32))
    assert torch.equal(got["optimizer"]["state"][0]["momentum_buffer"],
                       torch.ones(7))
    assert got["optimizer"]["param_groups"] == [{"lr": 0.1}]
    assert m.last_save["bytes"] == (4 << 20) + 28
    assert m.last_save["blocking_ms"] > 0 and m.last_save["write_ms"] > 0
    assert integrity.verify_step(m.directory, 5) == (
        True, "step 5: verified against manifest")
    m.close()


def test_max_to_keep_and_forced_rewrite(tmp_path):
    m = t_checkpoint.CheckpointManager(str(tmp_path), max_to_keep=5,
                                       digest=True)
    for step in range(1, 8):
        assert m.save(step, {"w": torch.full((3,), float(step))})
    m.wait()
    assert m.all_steps() == [3, 4, 5, 6, 7] and m.latest_step() == 7
    assert integrity.list_manifest_steps(m.directory) == [3, 4, 5, 6, 7]
    assert not m.save(7, {"w": torch.zeros(3)})          # committed
    assert m.save(7, {"w": torch.zeros(3)}, force=True)
    m.wait()
    assert torch.equal(m.restore()["w"], torch.zeros(3))
    assert integrity.verify_step(m.directory, 7)[0]
    with open(integrity.manifest_path(m.directory, 7)) as f:
        assert "sha256" in json.load(f)["files"]["state.pt"]
    assert not [n for n in os.listdir(m.directory) if n.startswith(".tmp")]
    m.close()


@pytest.mark.parametrize("elastic", [True, False])
def test_restore_across_a_topology_change(tmp_path, elastic):
    """A step saved on another device kind restores after the difference
    is logged; with ``RESILIENCE.ELASTIC_RESUME`` off it is refused."""
    saved_on = dict(t_checkpoint.topo_mod.current_topology("cpu"),
                    device_kind="NVIDIA H100 80GB HBM3")
    m = t_checkpoint.CheckpointManager(str(tmp_path), topology=saved_on)
    m.save(1, {"w": torch.ones(2)})
    m.close()
    m = t_checkpoint.CheckpointManager(
        str(tmp_path), topology=t_checkpoint.topo_mod.current_topology("cpu"),
        elastic=elastic)
    if elastic:
        state, step = m.restore_with_fallback()
        assert step == 1 and torch.equal(state["w"], torch.ones(2))
    else:
        with pytest.raises(RuntimeError, match="device_kind: NVIDIA H100"):
            m.restore_with_fallback()


# ---------------------------------------------------------------------
# backbone weights and the entry point's options
# ---------------------------------------------------------------------


def test_backbone_npz_matches_the_reference(jax_run, tmp_path):
    """An npz written by the reference's ``save_r50_npz`` from one
    backbone, loaded over another: the port's ``load_r50_npz`` equals
    ``from_flax`` of the reference's load, with the same counts; and
    ``Trainer.init_state`` loads it under ``BACKBONE.WEIGHTS``."""
    init = jax_run["init"]
    path = str(tmp_path / "r50.npz")
    source = jax.tree.map(lambda x: np.asarray(x) * 2.0 + 1.0,
                          init["backbone"])
    n = j_backbone.save_r50_npz(path, source)
    assert n > 10
    target = jax.tree.map(np.array, init["backbone"])
    merged, j_loaded, j_expected = j_backbone.load_r50_npz(path, target)
    want = from_flax({"backbone": merged})
    sd = from_flax(init)
    loaded, expected = load_r50_npz(path, sd)
    assert (loaded, expected) == (j_loaded, j_expected)
    assert loaded == expected == n
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    cfg = tiny_cfg(t_config, f"BACKBONE.WEIGHTS={path}")
    trainer = t_train.Trainer(cfg, str(tmp_path / "run"), device="cpu")
    model_sd = trainer.init_state().state_dict()
    for k, v in want.items():
        assert torch.equal(model_sd[k], v), k
    trainer.close()


_SYNTHETIC = ["--synthetic", "--total-steps", "2", "--config",
              *SMOKE_OVERRIDES, "TRAIN.BATCH_SIZE_PER_CHIP=1",
              "TRAIN.STEPS_PER_EPOCH=2", "TRAIN.LOG_PERIOD=1",
              "TELEMETRY.PORT=0"]


@pytest.mark.parametrize("argv,match", [
    (_SYNTHETIC + ["TRAIN.SHARDING.STRATEGY=tensor",
                   "TRAIN.SHARDING.MODEL_AXIS_SIZE=1"], "item 4"),
    (_SYNTHETIC + ["TRAIN.SHARDING.STRATEGY=2d",
                   "TRAIN.SHARDING.MODEL_AXIS_SIZE=1",
                   "TRAIN.SHARDING.RULES=(('fpn/.*/kernel$','2d'),"
                   "('maskrcnn/deconv/kernel$',(None,None,None,'model')),"
                   "('.*','fsdp'))"], "item 4"),
])
def test_entry_point_options_that_wait(tmp_path, argv, match, capfd):
    """``--synthetic`` under ``tensor``, and under ``2d`` with custom
    rules, no longer waits on ``match`` (the roadmap item that held it):
    it trains to the end under the plan its config names."""
    # main() finalizes the global config: restore it, so the overrides do
    # not reach the next test of this process
    saved = t_config.config.to_dict()
    try:
        assert t_train.main(["--device", "cpu", "--logdir",
                             str(tmp_path)] + argv) == 0
    finally:
        t_config.config.freeze(False)
        t_config.config.from_dict(saved)
        t_config.config.freeze()
    logged = "".join(capfd.readouterr())
    assert match not in logged
    cfg = tiny_cfg(t_config, *argv[argv.index("--config") + 1:])
    assert "sharding plan: " + t_sharding.ShardingPlan.from_config(
        cfg).describe() in logged
    assert ("tensor(model=1, rules=2)" in logged
            or "2d(fsdp=1, model=1, rules=3)" in logged)
    with open(tmp_path / "metrics.jsonl") as f:
        assert [json.loads(ln)["step"] for ln in f
                if '"total_loss"' in ln][-1] == 2


def test_entry_point_profile_writes_a_capture(tmp_path):
    """``--profile 2``: the entry point captures steps 2-3 with
    torch.profiler and writes the Chrome trace and its attribution by
    model component under ``<logdir>/profile``."""
    saved = t_config.config.to_dict()
    try:
        assert t_train.main([
            "--device", "cpu", "--logdir", str(tmp_path), "--synthetic",
            "--total-steps", "3", "--profile", "2", "--config",
            *SMOKE_OVERRIDES, "TRAIN.BATCH_SIZE_PER_CHIP=1",
            "TRAIN.STEPS_PER_EPOCH=3", "TRAIN.LOG_PERIOD=1",
            "TELEMETRY.PORT=0"]) == 0
    finally:
        t_config.config.freeze(False)
        t_config.config.from_dict(saved)
        t_config.config.freeze()
    profile = tmp_path / "profile"
    assert sorted(os.listdir(profile)) == ["attribution.json",
                                           "trace-step2-host0.json"]
    with open(profile / "attribution.json") as f:
        attr = json.load(f)
    assert attr["steps"] == [2, 3] and attr["reason"] == "cli"
    table = attr["component_table"]
    assert {"backbone", "backbone-bwd", "roi-fwd", "roi-bwd",
            "optimizer"} <= set(table["component_pct"])
    with open(tmp_path / "events-host0.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("profile_capture_done") == 1


# ---------------------------------------------------------------------
# the prefetcher on the CPU
# ---------------------------------------------------------------------


def _host_batches(n):
    for i in range(n):
        yield {"images": np.full((2, 3), i, np.float32),
               "image_id": np.asarray([i])}


def test_device_prefetcher_order_budget_and_errors():
    from eksml_tpu_torch.data.loader import DevicePrefetcher

    it = _host_batches(10)
    pf = DevicePrefetcher(it, "cpu", limit=3)
    got = [int(b["images"][0, 0]) for b in pf]
    assert got == [0, 1, 2]                        # the budget, in order
    pf.extend(2)
    got += [int(next(pf)["images"][0, 0]) for _ in range(2)]
    assert got == [0, 1, 2, 3, 4]
    pf.close()
    assert int(next(it)["images"][0, 0]) == 5      # nothing pulled past it

    def broken():
        yield from _host_batches(1)
        raise OSError("disk gone")

    pf = DevicePrefetcher(broken(), "cpu")
    assert set(next(pf)) == {"images"}             # host-only keys dropped
    with pytest.raises(OSError, match="disk gone"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    pf.close()
