"""The port's ``tensor`` and ``2d`` plans and custom
``TRAIN.SHARDING.RULES`` against the reference, on the CPU.

- **Placements, in one process.**  For ``tensor`` at ``{data: 1, model:
  2}`` and ``{data: 2, model: 2}``, ``2d`` at ``{fsdp: 2, model: 2}`` and
  ``{fsdp: 4, model: 2}``, default ``fsdp`` at ``{fsdp: 4}`` and three
  custom rule sets, every tensor's ``ShardingPlan.layout`` equals the
  reference's ``match_partition_rules`` spec on the seeded Flax tree
  (the reference's mesh over the 8 CPU devices of ``tests/conftest.py``)
  mapped onto the port's dims: the same split dims and the same local
  element count.  The only exceptions are the two deliberate
  differences (ROADMAP Queue 3), each asserted by kind and by bytes:
  FrozenBN statistics are buffers, which the port never shards, and
  under default ``fsdp`` a leaf the reference replicates because no dim
  divides is FSDP2's padded dim-0 shard.  ``tree_bytes_per_device``
  differs from the reference's by exactly those bytes.  A rule list the
  reference refuses raises ``ValueError`` in the port too.
- **One 4-rank gloo launch** (``tests/torch_dist_ranks.py sharding``,
  one thread per rank): one step under ``tensor`` (data 2 x model 2),
  ``2d`` (fsdp 2 x model 2), ``2d`` with REMAT (its recompute reads the
  sharded weights whole again inside the backward), a custom rule set,
  and ``replicated``, ``fsdp``, ``tensor``, ``2d`` and ``2d`` with REMAT
  under bf16 storage, each rank on one of 4 seeded images with unequal
  foreground.  The float32 runs equal the port's one-process step (with
  REMAT where the run has it) on the 4 images: losses and ``grad_norm`` to
  1e-5 relative, every raw gradient and updated parameter to 1e-5 of
  its largest magnitude.  The one-process step runs at one thread, as
  the ranks do: at torch's default thread count (one per core, 8 cores)
  oneDNN's backward gives ``backbone.group3_block0.conv1.weight`` a
  gradient 1.7e-4 (of its largest magnitude) away from the one-thread
  one on these images, under the existing ``fsdp`` plan and one process
  alike.
  The bf16 runs are held to the one-process bf16 step within
  ``BF16_ULPS`` bf16 epsilons (2^-8) of each tensor's largest magnitude.
  The one-process float32 step equals the JAX one-device step on the
  same 4 images at ``test_torch_train``'s tolerances (one JAX compile).
- **Restore.**  A ``2d`` Trainer step saved at world 4 restores bitwise
  at world 1 in this process, under every strategy.
"""

import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

jax.config.update("jax_platforms", "cpu")

import optax  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu import train as j_train  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.data import loader as j_loader  # noqa: E402
from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN  # noqa: E402
from eksml_tpu.ops import anchors as j_anchors  # noqa: E402
from eksml_tpu.parallel import sharding as j_sharding  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.convert import (flax_dims, flax_leaves,  # noqa: E402
                                     flax_path, from_flax, init_params)
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from eksml_tpu_torch.models import rpn as t_rpn  # noqa: E402
from eksml_tpu_torch.parallel import sharding as t_sharding  # noqa: E402
from eksml_tpu_torch.parallel.sharding import ShardingPlan  # noqa: E402
from test_torch_train import _close, jax_priorities  # noqa: E402

IMG = 128
N = 4
LOSS_KEYS = ("rpn_cls_loss", "rpn_box_loss", "frcnn_cls_loss",
             "frcnn_box_loss", "mrcnn_loss", "total_loss")
OVERRIDES = list(SMOKE_OVERRIDES) + [
    "PREPROC.DEVICE_NORMALIZE=False", "TRAIN.GRADIENT_CLIP=5.0",
    "TRAIN.BASE_LR=0.1", "TRAIN.WARMUP_STEPS=0", "TELEMETRY.PORT=0"]
ONE = ["TRAIN.BATCH_SIZE_PER_CHIP=4", "TRAIN.NUM_CHIPS=1"]
FOUR = ["TRAIN.BATCH_SIZE_PER_CHIP=1", "TRAIN.NUM_CHIPS=4"]
RANKS = os.path.join(REPO, "tests", "torch_dist_ranks.py")
BF16 = "TRAIN.PARAM_DTYPE=bfloat16"
REMAT = "TRAIN.REMAT=True"
#: the batch's seed: the first from 7 (``test_torch_distributed``'s) whose
#: four images all differ in GT objects and in foreground anchors
SEED = 8
#: bf16 budget of the 4-rank steps against the one-process bf16 step, in
#: bf16 epsilons (2^-8) of each tensor's largest magnitude.  Measured on
#: these images (every bf16 run alike): gradients at most 2.81
#: (``rpn.class.weight``: the ranks' mean of four bf16 per-image
#: gradients, reduced in bf16, against one bf16 rounding of the batch's);
#: updated parameters at most 4.76 (``fastrcnn.class.bias``: a
#: zero-initialised bias, whose value after one step is its update, so
#: each rounding of it counts against the update's own magnitude).
#: The budget is that worst case, rounded up, plus one.
BF16_ULPS = 6.0

TENSOR_RULES = (
    (r"maskrcnn/deconv/kernel$", (None, None, "fsdp", "model")),
    (r"fpn/posthoc_\d+/kernel$", (None, None, ("fsdp", "model"))),
    (r".*", "fsdp"),
)
SUBSET_2D_RULES = (
    (r"fpn/.*/kernel$", "2d"),
    (r"backbone/group3", "fsdp"),
    (r".*", "replicated"),
)
NOT_DIVIDING_RULES = (
    (r"fastrcnn/class/kernel$", (None, "model")),
    (r".*", "replicated"),
)

#: (strategy, mesh axes and sizes, rules)
CASES = {
    "tensor_m2": ("tensor", {"data": 1, "model": 2}, ()),
    "tensor_d2m2": ("tensor", {"data": 2, "model": 2}, ()),
    "2d_f2m2": ("2d", {"data": 1, "fsdp": 2, "model": 2}, ()),
    "2d_f4m2": ("2d", {"data": 1, "fsdp": 4, "model": 2}, ()),
    "fsdp_f4": ("fsdp", {"data": 1, "fsdp": 4, "model": 1}, ()),
    "rules_literal": ("2d", {"data": 1, "fsdp": 2, "model": 2},
                      TENSOR_RULES),
    "rules_2d_subset": ("2d", {"data": 1, "fsdp": 2, "model": 2},
                        SUBSET_2D_RULES),
}

#: the 4-rank runs: name → extra config items
RUNS = {
    "tensor": ["TRAIN.SHARDING.STRATEGY=tensor",
               "TRAIN.SHARDING.MODEL_AXIS_SIZE=2"],
    "2d": ["TRAIN.SHARDING.STRATEGY=2d", "TRAIN.SHARDING.MODEL_AXIS_SIZE=2",
           "TRAIN.SHARDING.FSDP_AXIS_SIZE=2"],
    "rules": ["TRAIN.SHARDING.STRATEGY=2d",
              "TRAIN.SHARDING.MODEL_AXIS_SIZE=2",
              "TRAIN.SHARDING.FSDP_AXIS_SIZE=2",
              f"TRAIN.SHARDING.RULES={TENSOR_RULES!r}"],
    "replicated_bf16": [BF16],
    "fsdp_bf16": ["TRAIN.SHARDING.STRATEGY=fsdp", BF16],
    "tensor_bf16": ["TRAIN.SHARDING.STRATEGY=tensor",
                    "TRAIN.SHARDING.MODEL_AXIS_SIZE=2", BF16],
    "2d_bf16": ["TRAIN.SHARDING.STRATEGY=2d",
                "TRAIN.SHARDING.MODEL_AXIS_SIZE=2",
                "TRAIN.SHARDING.FSDP_AXIS_SIZE=2", BF16],
}
# REMAT recomputes the backbone and the FPN in the backward, reading
# their sharded weights whole a second time
RUNS["2d_remat"] = RUNS["2d"] + [REMAT]
RUNS["2d_remat_bf16"] = RUNS["2d"] + [REMAT, BF16]
F32_RUNS = ("tensor", "2d", "rules", "2d_remat")
#: the one-process step each 4-rank run is held to (``ref``'s tags)
ONE_PROCESS = {"2d_remat": "f32_remat", "2d_remat_bf16": "bf16_remat"}
SAVE_2D = RUNS["2d"] + ["TRAIN.STEPS_PER_EPOCH=1", "TRAIN.CHECKPOINT_PERIOD=1"]
#: the plans the 2d step is restored under at world 4
RESTORE = {"replicated": [], "fsdp": ["TRAIN.SHARDING.STRATEGY=fsdp"],
           "tensor": RUNS["tensor"], "rules": RUNS["rules"]}


def cfg_of(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(OVERRIDES + list(extra))
    cfg.freeze()
    return cfg


# ---------------------------------------------------------------------
# placements against the reference's rule engine
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    """The seeded SMOKE state as the port's ``state_dict`` (with which
    names are parameters) and as the reference's Flax tree."""
    cfg = cfg_of(t_config, *ONE)
    sd = init_params(cfg, torch.Generator().manual_seed(42))
    with torch.device("meta"):
        params = {n for n, _ in MaskRCNN.from_config(cfg).named_parameters()}
    flax = {}
    for name, t in flax_leaves(sd):
        *path, leaf = name.split(".")
        node = flax
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(t.numpy())
    return {"sd": sd, "params": params, "flax": flax}


def reference_layout(case, flax):
    """The reference's spec per ``/`` path and its per-device bytes."""
    strategy, axes, rules = CASES[case]
    n = math.prod(axes.values())
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))
    plan = j_sharding.ShardingPlan(strategy, mesh, rules=rules)
    specs = plan.specs(flax)
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    by_path = {j_sharding.tree_path_str(p): tuple(s) for p, s in flat}
    placed = jax.device_put(flax, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs))
    return by_path, j_sharding.tree_bytes_per_device(placed)


def port_plan(case):
    strategy, axes, rules = CASES[case]
    return ShardingPlan(strategy, None, tuple(axes.values()), tuple(axes),
                        rules=rules)


def mapped_dims(name, shape, spec):
    """The reference's spec (Flax dims) on the port's dims."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(() if entries[d] is None else
                 ((entries[d],) if isinstance(entries[d], str)
                  else tuple(entries[d]))
                 for d in flax_dims(name, len(shape)))


def differences(case, trees):
    """Every tensor whose port layout differs from the reference's,
    → ``{name: (kind, port bytes - reference bytes)}``; asserts every
    other tensor equal."""
    _, axes, _ = CASES[case]
    ref, _ = reference_layout(case, trees["flax"])
    plan = port_plan(case)
    out = {}
    compared = 0
    for name, t in trees["sd"].items():
        is_param = name in trees["params"]
        lay = plan.layout(name, t.shape, is_param)
        want_dims = mapped_dims(name, t.shape, ref[lay.path])
        want_local = math.prod(
            d // math.prod(axes[a] for a in ax)
            for d, ax in zip(t.shape, want_dims))
        got_local = math.prod(lay.local_shape)
        if lay.dims == want_dims and got_local == want_local:
            compared += 1
            continue
        delta = (got_local - want_local) * t.element_size()
        if not is_param:
            kind = "FrozenBN buffer"
            assert lay.dims == tuple(() for _ in t.shape)
            assert got_local == t.numel()
        else:
            kind = "FSDP2 padded shard"
            assert plan.uses_fsdp2 and ref[lay.path] == (), (name, lay)
            f = axes["fsdp"]
            assert lay.dims[0] == ("fsdp",) and t.shape[0] % f != 0 or \
                t.numel() == 1, (name, lay)
        out[name] = (kind, delta)
    assert compared > 40
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_placements_equal_the_reference(case, trees):
    # the copied engine gives the reference's spec for every Flax leaf
    strategy, axes, rules = CASES[case]
    ref, _ = reference_layout(case, trees["flax"])
    flat = {path.replace(".", "/"): leaf
            for path, leaf in flax_leaves(trees["sd"])}
    if strategy != "replicated":
        assert t_sharding.match_partition_rules(
            rules or t_sharding.DEFAULT_RULES[strategy], flat, axes) == ref
    diff = differences(case, trees)
    strategy = CASES[case][0]
    kinds = {kind for kind, _ in diff.values()}
    if strategy == "tensor":
        assert not diff      # tensor replicates every buffer as well
    assert kinds <= {"FrozenBN buffer", "FSDP2 padded shard"}
    if not port_plan(case).uses_fsdp2:
        assert "FSDP2 padded shard" not in kinds


@pytest.mark.parametrize("case", sorted(CASES))
def test_bytes_per_device_equal_the_reference_but_named(case, trees):
    plan = port_plan(case)
    _, ref_bytes = reference_layout(case, trees["flax"])
    port_bytes = sum(
        math.prod(plan.layout(n, t.shape, n in trees["params"]).local_shape)
        * t.element_size() for n, t in trees["sd"].items())
    named = sum(d for _, d in differences(case, trees).values())
    assert port_bytes == ref_bytes + named, (port_bytes, ref_bytes, named)


def test_target_layouts_in_the_ports_dims(trees):
    """The mask head's transposed conv keeps its output features on the
    port's dim 1; a conv's on dim 0, a dense layer's on dim 0; a literal
    spec's Flax input dim lands on the port's dim 1 (conv) or 0
    (transposed conv), and a 3x3x32x32 conv's fsdp dim is the reference's
    (I, Flax dim 2), not the one torch's order would pick."""
    plan = port_plan("tensor_m2")
    sd = trees["sd"]
    dims = {n: plan.layout(n, sd[n].shape).dims for n in (
        "maskrcnn.deconv.weight", "fpn.lateral_2.weight",
        "fastrcnn.fc6.weight", "rpn.conv0.weight")}
    assert dims["maskrcnn.deconv.weight"] == ((), ("model",), (), ())
    assert dims["fpn.lateral_2.weight"] == (("model",), (), (), ())
    assert dims["fastrcnn.fc6.weight"] == (("model",), ())
    lit = port_plan("rules_literal")
    assert lit.layout("maskrcnn.deconv.weight",
                      sd["maskrcnn.deconv.weight"].shape).dims == (
        ("fsdp",), ("model",), (), ())
    assert lit.layout("fpn.posthoc_2.weight",
                      sd["fpn.posthoc_2.weight"].shape).dims == (
        (), ("fsdp", "model"), (), ())
    fsdp = port_plan("fsdp_f4")
    w = sd["fpn.posthoc_2.weight"]
    assert w.shape[0] == w.shape[1]
    assert fsdp.layout("fpn.posthoc_2.weight", w.shape).dims == (
        (), ("fsdp",), (), ())


@pytest.mark.parametrize("strategy,axes,want", [
    ("fsdp", {"data": 1, "fsdp": 8, "model": 1}, (371840, -1740)),
    ("2d", {"data": 1, "fsdp": 2, "model": 2}, (212480, 0)),
])
def test_full_width_differences_are_the_named_bytes(strategy, axes, want):
    """At the default config's widths (R50-FPN, float32), the bytes per
    device the port holds beyond the reference's specs (on the Flax
    leaves' shapes): the FrozenBN statistics, whole in the port, and
    FSDP2's padded shards of the leaves the reference replicates (fewer
    bytes than a whole copy).  ROADMAP Queue 3 quotes these."""
    cfg = t_config.config.clone()
    cfg.freeze(False)
    cfg.update_args([       # the defaults, whatever an earlier test set
        "MODE_MASK=True", "MODE_CASCADE=False", "DATA.NUM_CLASSES=81",
        "BACKBONE.RESNET_NUM_BLOCKS=(3,4,6,3)", "BACKBONE.NORM=FreezeBN",
        "BACKBONE.FREEZE_AT=2", "FPN.NUM_CHANNEL=256",
        "FPN.FRCNN_FC_HEAD_DIM=1024", "MRCNN.HEAD_DIM=256"])
    with torch.device("meta"):
        model = MaskRCNN.from_config(cfg)
    params = {n for n, _ in model.named_parameters()}
    sd = model.state_dict()
    shapes = {}
    for name, t in flax_leaves(sd):
        *path, leaf = name.split(".")
        node = shapes
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:math.prod(axes.values())]).reshape(
        tuple(axes.values())), tuple(axes))
    specs = j_sharding.ShardingPlan(strategy, mesh).specs(shapes)
    ref = {j_sharding.tree_path_str(p): tuple(spec) for p, spec in
           jax.tree_util.tree_flatten_with_path(specs)[0]}
    plan = ShardingPlan(strategy, None, tuple(axes.values()), tuple(axes))
    buffers = padded = 0
    for name, t in sd.items():
        lay = plan.layout(name, t.shape, name in params)
        ref_local = math.prod(
            d // math.prod(axes[a] for a in ax)
            for d, ax in zip(t.shape, mapped_dims(name, t.shape,
                                                  ref[lay.path])))
        delta = (math.prod(lay.local_shape) - ref_local) * 4
        if name in params:
            padded += delta
        else:
            buffers += delta
    assert (buffers, padded) == want


BAD_RULES = {
    "no_catchall": ((r"kernel$", "fsdp"),),
    "empty": (),
    "bad_action": ((r".*", "shard"),),
    "bad_regex": ((r"(", "fsdp"), (r".*", "replicated")),
    "bad_entry": ((r".*", (None, 3)),),
}


@pytest.mark.parametrize("bad", sorted(BAD_RULES))
def test_refused_rule_lists_raise_in_both(bad):
    rules = BAD_RULES[bad]
    if bad != "empty":
        with pytest.raises(ValueError):
            j_sharding.validate_rules(rules)
        with pytest.raises(ValueError):
            t_sharding.validate_rules(rules)
    cfg = cfg_of(t_config, *ONE, "TRAIN.SHARDING.STRATEGY=fsdp",
                 f"TRAIN.SHARDING.RULES={rules!r}")
    if bad == "empty":      # () selects the strategy's own rules in both
        assert ShardingPlan.from_config(cfg).rules == \
            j_sharding.DEFAULT_RULES["fsdp"]
        return
    with pytest.raises(ValueError):
        ShardingPlan.from_config(cfg)


@pytest.mark.parametrize("where", ["axis", "rank", "divide"])
def test_literal_specs_the_reference_refuses_raise(where, trees):
    """A literal spec that does not divide its dim, names an axis the
    mesh lacks, or has more entries than the leaf: ``_match_leaf``
    raises in both packages."""
    rules = {"divide": NOT_DIVIDING_RULES,
             "axis": ((r"rpn/conv0/kernel$", (None, None, None, "pipe")),
                      (r".*", "replicated")),
             "rank": ((r"rpn/conv0/bias$", (None, "model")),
                      (r".*", "replicated"))}[where]
    axes = {"data": 1, "model": 2}
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), tuple(axes))
    with pytest.raises(ValueError):
        j_sharding.match_partition_rules(rules, trees["flax"], mesh)
    flat = {path.replace(".", "/"): leaf
            for path, leaf in flax_leaves(trees["sd"])}
    with pytest.raises(ValueError):
        t_sharding.match_partition_rules(rules, flat, axes)
    plan = ShardingPlan("tensor", None, (1, 2), tuple(axes), rules=rules)
    with pytest.raises(ValueError):
        for n, t in trees["sd"].items():
            plan.layout(n, t.shape, n in trees["params"])


def test_explain_names_the_rule(trees):
    plan = port_plan("rules_2d_subset")
    with torch.device("meta"):
        model = MaskRCNN.from_config(cfg_of(t_config, *ONE))
    text = plan.explain(model)
    lines = {ln.split()[0]: ln for ln in text.splitlines()[1:]}
    assert "<- fpn/.*/kernel$" in lines["fpn/lateral_2/kernel"]
    assert "<- backbone/group3" in lines["backbone/group3_block0/conv1/kernel"]
    assert "<- .*" in lines["rpn/conv0/kernel"]
    assert "replicated" in lines["backbone/FrozenBN_0/mean"]
    assert "<- (buffer)" in lines["backbone/FrozenBN_0/mean"]
    assert " 1:fsdp*model " in lines["fpn/lateral_2/kernel"] or \
        " 0:model,1:fsdp " in lines["fpn/lateral_2/kernel"]
    assert text.startswith("sharding plan '2d' over mesh {'data': 1, "
                           "'fsdp': 2, 'model': 2}")


def test_describe_gives_the_references_strings():
    for case in sorted(CASES):
        strategy, axes, rules = CASES[case]
        n = math.prod(axes.values())
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(
            tuple(axes.values())), tuple(axes))
        assert port_plan(case).describe() == j_sharding.ShardingPlan(
            strategy, mesh, rules=rules).describe()


def test_priced_bytes_are_the_references_plan(trees):
    """``plan_collectives`` prices the bytes the reference's plans move:
    the targets are the leaves its ``tensor`` plan puts ``model`` on, the
    rest its other parameter leaves (FrozenBN statistics, leaves in the
    reference, are buffers the port never moves)."""
    from eksml_tpu_torch.profiling import predict as t_predict

    ref, _ = reference_layout("tensor_m2", trees["flax"])
    flat = {flax_path(n): t for n, t in trees["sd"].items()}
    params = {flax_path(n) for n in trees["params"]}

    def nbytes(paths):
        return sum(flat[p].numel() * flat[p].element_size() for p in paths)

    targets = {p for p, spec in ref.items()
               if any("model" in (e if isinstance(e, tuple) else (e,))
                      for e in spec)}
    assert targets and targets <= params
    with torch.device("meta"):
        model = MaskRCNN.from_config(cfg_of(t_config, *ONE))
    meta = t_predict.train_meta(model, {"images": torch.zeros(1, IMG, IMG, 3)})
    assert meta["target_param_bytes"] == nbytes(targets)
    assert meta["param_bytes"] - meta["target_param_bytes"] == \
        nbytes(params - targets)
    frozen = {flax_path(n) for n, p in model.named_parameters()
              if not p.requires_grad}
    assert meta["target_grad_bytes"] == nbytes(targets - frozen)
    rows = t_predict.plan_collectives(meta, {"data": 1, "fsdp": 2,
                                             "model": 2}, "2d")
    assert [(op, b) for op, b, _ in rows[:4]] == [
        ("all-gather", nbytes(targets)),
        ("reduce-scatter", nbytes(targets - frozen)),
        ("all-gather", nbytes(params - targets)),
        ("reduce-scatter", nbytes(params - targets - frozen))]


# ---------------------------------------------------------------------
# four gloo ranks against one process and against JAX
# ---------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_process_step(cfg, params, batch, pri):
    """The port's step in this process at one thread (as the ranks): →
    (metrics, raw gradients, updated state)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = MaskRCNN.from_config(cfg)
        model.load_state_dict(params)
        t_train.cast_for_storage(model, cfg.TRAIN.PARAM_DTYPE)
        model.train()
        opt, sched = t_train.make_optimizer(model, cfg)
        names = {id(p): n for n, p in model.named_parameters()}
        order = [p for g in opt.param_groups for p in g["params"]]
        grads = {}
        norm = t_train.global_norm

        def keep(tensors):
            for p, g in zip(order, tensors):
                grads[names[id(p)]] = g.detach().clone()
            return norm(tensors)

        t_train.global_norm = keep
        try:
            metrics = t_train.make_train_step(
                model, opt, sched, float(cfg.TRAIN.GRADIENT_CLIP))(
                batch, pri, 0)
        finally:
            t_train.global_norm = norm
        return ({k: float(v) for k, v in metrics.items()}, grads,
                {k: v.clone() for k, v in model.state_dict().items()})
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """4 seeded images, one seeded init, the JAX priorities of the
    global batch, the JAX one-device step on it, and the port's
    one-process steps (float32 and bf16 storage)."""
    jcfg = j_config.config.clone()
    jcfg.freeze(False)
    jcfg.update_args(OVERRIDES + ONE)
    jcfg.freeze()
    batch = j_loader.make_synthetic_batch(jcfg, batch_size=N, image_size=IMG,
                                          seed=SEED, gt_mask_size=28)
    batch = {k: v for k, v in batch.items()
             if k not in ("image_scale", "image_id")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flax_model = FlaxMaskRCNN.from_config(jcfg)
    key = jax.random.PRNGKey(42)
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
           for k, v in jax_priorities(key, N, a, n).items()}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    p0 = from_flax(jax.device_get(params))
    out = {"batch": tbatch, "np_batch": batch, "priorities": pri,
           "params": p0, "cfg": tcfg,
           "jax_losses": {k: float(v) for k, v in losses.items()},
           "jax_grads": from_flax(jax.device_get(grads)),
           "jax_params": from_flax(jax.device_get(new))}
    for tag, extra in (("f32", ()), ("bf16", (BF16,)),
                       ("f32_remat", (REMAT,)),
                       ("bf16_remat", (REMAT, BF16))):
        out[tag] = one_process_step(cfg_of(t_config, *ONE, *extra), p0,
                                    tbatch, pri)
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """One launch of 4 ranks (one thread each) running every plan of
    ``RUNS`` and the ``2d`` Trainer step saved at world 4."""
    workdir = tmp_path_factory.mktemp("sharding")
    torch.save({"per_rank": 1, "batch": ref["batch"],
                "np_batch": ref["np_batch"], "priorities": ref["priorities"],
                "params": ref["params"], "overrides": OVERRIDES + FOUR,
                "runs": RUNS, "save": SAVE_2D, "restore": RESTORE},
               os.path.join(workdir, "inputs.pt"))
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("PROCESS_ID", "SLICE_INDEX", "JOB_COMPLETION_INDEX",
                         "LOCAL_RANK", "LOCAL_WORLD_SIZE", "NUM_PROCESSES")}
    base.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", OMP_NUM_THREADS="1",
                PYTHONPATH=REPO, NUM_PROCESSES=str(N))
    procs = [subprocess.Popen(
        [sys.executable, RANKS, "sharding", str(workdir)],
        env=dict(base, PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(N)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-6000:]}"
    out = [torch.load(os.path.join(workdir, f"sharding-rank{r}.pt"),
                      weights_only=False) for r in range(N)]
    return {"ranks": out, "workdir": str(workdir)}


def test_the_four_images_have_unequal_foreground(ref):
    b = ref["batch"]
    model = MaskRCNN.from_config(ref["cfg"])
    anchors = torch.cat(model._anchors((IMG, IMG), "cpu"))
    labels, _ = t_rpn.match_anchors(anchors, b["gt_boxes"], b["gt_valid"],
                                    0.7, 0.3, gt_crowd=b["gt_crowd"])
    fg = (labels == 1).sum(dim=1).tolist()
    gt = b["gt_valid"].sum(dim=1).tolist()
    assert len(set(fg)) == N and len(set(gt)) == N, (fg, gt)


@pytest.mark.parametrize("run", F32_RUNS)
def test_four_ranks_equal_one_process(ref, ranks, run):
    metrics, grads, state = ref[ONE_PROCESS.get(run, "f32")]
    for rank, out in enumerate(ranks["ranks"]):
        got = out[run]
        assert out["world"] == N
        for k in LOSS_KEYS + ("grad_norm",):
            assert got["metrics"][k] == pytest.approx(metrics[k],
                                                      rel=1e-5), (rank, k)
        assert set(got["grads"]) == set(grads)
        for name, want in grads.items():
            _close(got["grads"][name].numpy(), want.numpy(), 1e-5)
        assert set(got["params"]) == set(state)
        for name, want in state.items():
            _close(got["params"][name].numpy(), want.numpy(), 1e-5)


def _ulps(got, want):
    """Largest |got - want| in bf16 epsilons of ``want``'s largest
    magnitude."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / (want.abs().max().clamp(min=1e-30) * 2.0 ** -8))


@pytest.mark.parametrize("run", ["replicated_bf16", "fsdp_bf16",
                                 "tensor_bf16", "2d_bf16", "2d_remat_bf16"])
def test_bf16_storage_across_ranks_within_ulps(ref, ranks, run):
    metrics, grads, state = ref[ONE_PROCESS.get(run, "bf16")]
    worst = 0.0
    for out in ranks["ranks"]:
        got = out[run]
        for k in LOSS_KEYS:
            assert got["metrics"][k] == pytest.approx(metrics[k],
                                                      rel=1e-5), k
        for name, want in grads.items():
            assert got["grads"][name].dtype == torch.bfloat16, name
            worst = max(worst, _ulps(got["grads"][name], want))
        for name, want in state.items():
            if want.is_floating_point():
                assert got["params"][name].dtype == want.dtype, name
                worst = max(worst, _ulps(got["params"][name], want))
    assert worst <= BF16_ULPS, worst


def test_one_process_step_equals_jax(ref):
    metrics, grads, state = ref["f32"]
    for k in LOSS_KEYS:
        assert metrics[k] == pytest.approx(ref["jax_losses"][k],
                                           rel=1e-4), k
    params = dict(MaskRCNN.from_config(ref["cfg"]).named_parameters())
    for name, want in ref["jax_grads"].items():
        if name in params and params[name].requires_grad:
            _close(grads[name].numpy(), want.numpy(), 1e-4)
    moved = 0
    for name, p0 in ref["params"].items():
        want = (ref["jax_params"][name] - p0).numpy()
        _close((state[name] - p0).numpy(), want, 1e-3)
        moved += bool(np.abs(want).max() > 0)
    assert moved > 40


@pytest.mark.parametrize("run", F32_RUNS + ("fsdp_bf16",))
def test_rank_shards_are_the_plans_layout(ref, ranks, run):
    """Each rank's local parameter shapes are what ``layout`` says, and
    the placements split the dims it names."""
    cfg = cfg_of(t_config, *FOUR, *RUNS[run])
    for rank, out in enumerate(ranks["ranks"]):
        got = out[run]
        shape, axes = got["mesh"]
        k = t_sharding.sharding_knobs(cfg)
        plan = ShardingPlan(str(k["STRATEGY"]), None, shape, axes,
                            rules=tuple(k["RULES"]))
        sharded = 0
        for name, (local, shard_dims) in got["local"].items():
            lay = plan.layout(name, ref["params"][name].shape)
            if plan.uses_fsdp2 and lay.spec == ():
                # FSDP2's padded dim-0 shard: every rank allocates the
                # layout's (padded) size and holds its torch.chunk of it
                n = ref["params"][name].shape[0]
                chunks = [len(c) for c in torch.arange(n).chunk(N)]
                assert lay.local_shape[0] == chunks[0] == -(-n // N)
                want = chunks[rank] if rank < len(chunks) else 0
                assert local == (want,) + lay.local_shape[1:], (name, local)
            else:
                assert local == lay.local_shape, (name, local, lay)
            want = [d for d, ax in enumerate(lay.dims)
                    for a in ax if dict(zip(axes, shape))[a] > 1]
            assert sorted(shard_dims) == sorted(want), (name, shard_dims, lay)
            sharded += local != tuple(ref["params"][name].shape)
        assert sharded > 10


def test_plans_describe_their_mesh(ranks):
    out = ranks["ranks"][0]
    assert out["tensor"]["describe"] == "tensor(model=2, rules=2)"
    assert out["tensor"]["mesh"] == ((2, 2), ("data", "model"))
    assert out["2d"]["describe"] == "2d(fsdp=2, model=2, rules=2)"
    assert out["2d"]["mesh"] == ((1, 2, 2), ("data", "fsdp", "model"))
    assert out["rules"]["describe"] == "2d(fsdp=2, model=2, rules=3)"
    assert out["fsdp_bf16"]["describe"] == "fsdp(axis=4, rules=1)"
    assert "<- maskrcnn/deconv/kernel$" in out["rules"]["explain"]


def test_replica_sync_check_passes_over_shards(ranks):
    """``assert_replicas_in_sync`` fingerprints sharded tensors whole:
    ranks holding different shards of one state are in sync."""
    for out in ranks["ranks"]:
        for run in RUNS:
            assert out[run]["in_sync"] is True, run


# ---------------------------------------------------------------------
# elastic restore: 2d at world 4 → world 4 under every plan, → world 1
# ---------------------------------------------------------------------


def _assert_state_equals_live(state, live):
    assert set(state["model"]) == set(live["model"])
    for k, v in live["model"].items():
        assert torch.equal(state["model"][k], v), k
    assert set(state["momentum"]) == set(live["momentum"])
    assert len(live["momentum"]) > 40
    for i, v in live["momentum"].items():
        assert torch.equal(state["momentum"][i], v), i
    assert torch.equal(state["generator"], live["generator"])


@pytest.mark.parametrize("strategy", sorted(RESTORE))
def test_2d_world4_step_restores_bitwise_at_world4(ranks, strategy):
    for out in ranks["ranks"]:
        step, state = out["restored"][strategy]
        assert step == 1
        _assert_state_equals_live(state, ranks["ranks"][0]["saved"]["live"])



@pytest.mark.parametrize("strategy", ["replicated", "fsdp", "tensor", "2d"])
def test_2d_world4_step_restores_bitwise_at_world1(ranks, strategy):
    saved = ranks["ranks"][0]["saved"]
    assert saved["describe"] == "2d(fsdp=2, model=2, rules=2)"
    assert saved["topology"]["strategy"] == "2d"
    assert saved["topology"]["process_count"] == N
    for out in ranks["ranks"][1:]:
        assert out["saved"]["rows"][-1]["total_loss"] == \
            saved["rows"][-1]["total_loss"]
    extra = {"replicated": [], "fsdp": ["TRAIN.SHARDING.STRATEGY=fsdp"],
             "tensor": ["TRAIN.SHARDING.STRATEGY=tensor"],
             "2d": ["TRAIN.SHARDING.STRATEGY=2d",
                    "TRAIN.SHARDING.MODEL_AXIS_SIZE=1"]}[strategy]
    trainer = t_train.Trainer(
        cfg_of(t_config, "TRAIN.BATCH_SIZE_PER_CHIP=1", "TRAIN.NUM_CHIPS=1",
               *extra),
        os.path.join(ranks["workdir"], "w4_2d"), device="cpu")
    try:
        assert trainer.restore_or_init() == 1
        state = trainer.checkpoint_state()
    finally:
        trainer.close()
    _assert_state_equals_live(
        {"model": state["model"], "generator": state["generator"],
         "momentum": {i: s["momentum_buffer"] for i, s in
                      state["optimizer"]["state"].items()}}, saved["live"])
