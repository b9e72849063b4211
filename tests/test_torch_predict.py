"""The port's roofline of the training step (``eksml_tpu_torch/profiling/
predict.py``, ``analyze_memory`` in ``profiling/memory.py``) on the CPU:

- the pure functions copied from ``eksml_tpu/profiling/predict.py``
  (collective pricing, ``section_of``, ``compare_predictions``,
  ``calibrate``) against the reference's on the same inputs: exact;
- one training step at SMOKE widths, batch 1, 128² canvas, float32,
  counted by ``count_train_step``: the convolution and matrix-product
  FLOPs of each component, forward and backward, equal exactly an
  independent count from the layer shapes written here (a layer whose
  weight trains and whose input needs a gradient costs 2× its forward
  in the backward, 1× when it needs one of the two, nothing when
  frozen: ``BACKBONE.FREEZE_AT=2``);
- the forward FLOPs per component against the reference's own train
  step lowered on the CPU (``lower_train_step``), summed over its
  ``convolution`` and ``dot`` instructions with the reference's formula
  (``attribution._modeled_flops``: 2 × output elements × kernel elements
  / output channels; 2 × output elements × contracted size).  The
  compiled HLO names its operands without their shapes, so the shapes
  are read from the operands' own lines.  Tolerance: equal to 1e-9
  relative, with three exceptions, each checked: the mask head's
  transposed convolution counts its dilated zeros there (4× the port's
  for a 2×2 stride-2 kernel); XLA:CPU swaps the operands of the RPN's
  3×3 convolution on P6 (a 2×2 map at this canvas: the kernel becomes
  the left operand, ``rhs_reversal``), so the formula reads the map as
  the kernel and counts 1024 FLOPs for its 73 728; and a CPU lowering
  may turn a dot or a convolution into a custom call (none of the five
  components has one at this size; the test names any that appears);
- ROIAlign: each call counted once from the kernel phase's closed form
  (``bytes_and_ops`` on the call's own ROIs), none of the plain
  version's operations; REMAT's recompute apart; a predict forward
  (``count_predict_step``) counted without a backward or a collective;
- every operation's bytes land on a component or ``other``, ``other``
  at most 10 % (the observe phase allows 30 % of device time); the
  prediction carries the reference's keys and its sections sum to the
  total;
- liveness on a toy module: the peak and the live set equal the hand
  count exactly;
- ``Trainer.fit`` with ``TELEMETRY.PREDICTED_STEP_TIME`` on and off: the
  same losses bit for bit, the gauge published once and not at all.
"""

import os
import re
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

jax.config.update("jax_platforms", "cpu")

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu.profiling import predict as j_predict  # noqa: E402
from eksml_tpu.profiling.attribution import HloAttribution  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu_torch.data import loader as t_loader  # noqa: E402
from eksml_tpu_torch.models.heads import max_fg_proposals  # noqa: E402
from eksml_tpu_torch.ops.roi_align import KERNELS  # noqa: E402
from eksml_tpu_torch.profiling import memory as t_memory  # noqa: E402
from eksml_tpu_torch.profiling import named_scope  # noqa: E402
from eksml_tpu_torch.profiling import predict as t_predict  # noqa: E402

IMG = 128
BATCH = 1
FORWARD = ("backbone", "fpn-conv", "rpn-head", "box-head", "mask-head")
MATMUL = (t_predict.MATMUL,)
OTHER_MAX_PCT = 10.0


def smoke_cfg(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}", "TRAIN.PRECISION=float32",
        "TELEMETRY.PORT=0", *extra])
    return config_mod.finalize_configs(True, cfg)


def _batches(cfg, n=2):
    ds = t_loader.SyntheticDataset(num_images=2 * BATCH, height=IMG,
                                   width=IMG,
                                   num_classes=cfg.DATA.NUM_CLASSES)
    return t_loader.DetectionLoader(ds.records(), cfg, batch_size=BATCH,
                                    gt_mask_size=28).batches(n)


def _counted_step(cfg, record_rois=False):
    with tempfile.TemporaryDirectory() as logdir:
        trainer = t_train.Trainer(cfg, logdir, device="cpu")
        trainer.init_state()
        batch = trainer._to_device(next(iter(_batches(cfg, 1))))
        pri = trainer._priorities(batch, 0)
        calls = []
        if record_rois:
            fwd, bwd = KERNELS.fwd._plain, KERNELS.bwd._plain

            def keep(kind, plain):
                def call(*args):
                    calls.append((kind, args))
                    return plain(*args)
                return call

            KERNELS.fwd._plain = keep("roi_align_fwd", fwd)
            KERNELS.bwd._plain = keep("roi_align_bwd", bwd)
        try:
            _, counts = t_predict.count_train_step(
                trainer._step, batch, pri, 0, trainer.model,
                trainer.optimizer)
        finally:
            if record_rois:
                KERNELS.fwd._plain, KERNELS.bwd._plain = fwd, bwd
        trainer.close()
    return counts, calls


@pytest.fixture(scope="module")
def step_counts():
    cfg = smoke_cfg(t_config)
    counts, calls = _counted_step(cfg, record_rois=True)
    return cfg, counts, calls


# ---------------------------------------------------------------------
# the independent count from the layer shapes
# ---------------------------------------------------------------------


def conv(n, hw, k, cin, cout):
    """Forward FLOPs (a multiply-add is 2) of a k×k convolution producing
    ``hw`` × ``hw`` maps for ``n`` inputs."""
    return 2 * n * hw * hw * k * k * cin * cout


def layer_counts(cfg):
    """{component: [(forward FLOPs, backward multiple), ...]} of the
    training step's convolutions and matrix products at ``IMG``,
    ``BATCH``, from the config's widths."""
    b, c = BATCH, cfg.FPN.NUM_CHANNEL
    frozen = cfg.BACKBONE.FREEZE_AT - 1     # stem + res2
    layers = {k: [] for k in FORWARD}
    bb = layers["backbone"]
    bb.append((conv(b, IMG // 2, 7, 3, 64), 0))
    cin, hw = 64, IMG // 4
    for stage, blocks in enumerate(cfg.BACKBONE.RESNET_NUM_BLOCKS):
        ch = 64 * 2 ** stage
        for blk in range(blocks):
            out_hw = hw // 2 if (stage > 0 and blk == 0) else hw
            if stage < frozen:
                mult_in, mult = 0, 0
            elif stage == frozen and blk == 0:
                mult_in, mult = 1, 2        # its input is detached
            else:
                mult_in, mult = 2, 2
            bb.append((conv(b, hw, 1, cin, ch), mult_in))
            bb.append((conv(b, out_hw, 3, ch, ch), mult))
            bb.append((conv(b, out_hw, 1, ch, 4 * ch), mult))
            if blk == 0:
                bb.append((conv(b, out_hw, 1, cin, 4 * ch), mult_in))
            cin, hw = 4 * ch, out_hw
    sizes = [IMG // s for s in (4, 8, 16, 32)]
    for i, (ci, s) in enumerate(zip((256, 512, 1024, 2048), sizes)):
        layers["fpn-conv"].append((conv(b, s, 1, ci, c), 1 if i == 0 else 2))
        layers["fpn-conv"].append((conv(b, s, 3, c, c), 2))
    a = len(cfg.RPN.ANCHOR_RATIOS)
    for s in sizes + [IMG // 64]:
        layers["rpn-head"] += [(conv(b, s, 3, c, c), 2),
                               (conv(b, s, 1, c, a), 2),
                               (conv(b, s, 1, c, 4 * a), 2)]
    n, fc, k = b * cfg.FRCNN.BATCH_PER_IM, cfg.FPN.FRCNN_FC_HEAD_DIM, \
        cfg.DATA.NUM_CLASSES
    layers["box-head"] += [(2 * n * 49 * c * fc, 2), (2 * n * fc * fc, 2),
                           (2 * n * fc * k, 2), (2 * n * fc * 4 * k, 2)]
    m = b * max_fg_proposals(cfg.FRCNN.BATCH_PER_IM, cfg.FRCNN.FG_RATIO)
    hd, r = cfg.MRCNN.HEAD_DIM, cfg.MRCNN.RESOLUTION // 2
    mh = layers["mask-head"]
    mh += [(conv(m, r, 3, c if i == 0 else hd, hd), 2) for i in range(4)]
    mh.append((2 * m * r * r * 4 * hd * hd, 2))       # 2×2/2 transposed
    mh.append((conv(m, 2 * r, 1, hd, k), 2))
    return layers


@pytest.mark.parametrize("component", FORWARD)
def test_forward_flops_equal_the_layer_count(step_counts, component):
    cfg, counts, _ = step_counts
    want = sum(f for f, _ in layer_counts(cfg)[component])
    assert counts.flops(component, MATMUL) == want


@pytest.mark.parametrize("component", FORWARD)
def test_backward_flops_equal_the_layer_count(step_counts, component):
    cfg, counts, _ = step_counts
    want = sum(f * m for f, m in layer_counts(cfg)[component])
    assert counts.flops(component + "-bwd", MATMUL) == want


# ---------------------------------------------------------------------
# the reference's lowered step
# ---------------------------------------------------------------------

_LINE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*\w+\[([0-9,]*)\]\S*"
                   r"\s+([\w\-]+)\((.*)$")
_OPERAND = re.compile(r"%([\w.\-]+)")


def _dims(text):
    return [int(d) for d in text.split(",") if d]


def reference_forward_flops(hlo):
    """From the compiled HLO text: {component: FLOPs} of the
    reference's convolution and dot instructions in its forward
    components by its formula, the custom calls found in them, and the
    convolutions lowered with swapped operands (output dims, the
    formula's FLOPs)."""
    shapes, lines = {}, {}
    for line in hlo.splitlines():
        m = _LINE.match(line)
        if m:
            shapes[m.group(1)] = _dims(m.group(2))
            lines[m.group(1)] = (m.group(3), m.group(4))
    attr = HloAttribution(hlo)
    flops, custom, swapped = {}, {}, {}
    for name, (opcode, rest) in lines.items():
        comp = attr.instr_component.get(name)
        if comp not in FORWARD:
            continue
        if opcode == "custom-call":
            custom.setdefault(comp, []).append(name)
            continue
        if opcode not in ("convolution", "dot"):
            continue
        out = int(np.prod(shapes[name]))
        lhs, rhs = _OPERAND.findall(rest)[:2]
        if opcode == "convolution":
            kernel = shapes[rhs]
            f = 2 * out * int(np.prod(kernel)) // kernel[-1]
            if "rhs_reversal" in rest:
                swapped.setdefault(comp, []).append((shapes[name], f))
        else:
            m = re.search(r"lhs_contracting_dims=\{([0-9,]+)\}", rest)
            f = 2 * out * int(np.prod([shapes[lhs][int(i)]
                                       for i in m.group(1).split(",")]))
        flops[comp] = flops.get(comp, 0) + f
    return flops, custom, swapped


@pytest.fixture(scope="module")
def reference_flops():
    cfg = j_config.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        f"TRAIN.BATCH_SIZE_PER_CHIP={BATCH}", "TRAIN.PRECISION=float32"])
    cfg.freeze()
    hlo, _ = j_predict.lower_train_step(cfg, batch_size=BATCH,
                                        image_size=IMG)
    return reference_forward_flops(hlo)


@pytest.mark.parametrize("component", FORWARD)
def test_forward_flops_against_the_reference_lowering(step_counts,
                                                      reference_flops,
                                                      component):
    cfg, counts, _ = step_counts
    ref, custom, swapped = reference_flops
    assert component not in custom, (
        f"{component}: the CPU lowering made custom calls "
        f"{custom[component]}, which the reference's count misses")
    got = counts.flops(component, MATMUL)
    want = ref[component]
    if component == "mask-head":
        # the reference counts the transposed convolution over its
        # stride-dilated input: 4× the port's for a 2×2/2 kernel
        deconv = layer_counts(cfg)["mask-head"][4][0]
        got += 3 * deconv
    c = cfg.FPN.NUM_CHANNEL
    p6 = [BATCH, IMG // 64, IMG // 64, c]
    if component == "rpn-head":
        # the P6 3x3 convolution, lowered with its operands swapped
        ((dims, formula),) = swapped[component]
        assert dims == p6
        want += conv(BATCH, IMG // 64, 3, c, c) - formula
    else:
        assert component not in swapped, swapped[component]
    assert got == pytest.approx(want, rel=1e-9)


# ---------------------------------------------------------------------
# ROIAlign, attribution, the prediction
# ---------------------------------------------------------------------


def test_roi_align_is_counted_once_per_call_from_the_closed_form(
        step_counts):
    _, counts, calls = step_counts
    kernels = counts.kernel_calls()
    names = [o.name for o in kernels]
    # box, mask and mask-target forwards; two backwards with four seeds
    assert names.count("roi_align_fwd") == 3
    assert names.count("roi_align_bwd") == 2
    assert names.count("copy_to_global") == 8
    assert [k for k, _ in calls] == [o.name for o in kernels
                                     if o.name != "copy_to_global"]
    for o, (kind, args) in zip(
            [o for o in kernels if o.name != "copy_to_global"], calls):
        if kind == "roi_align_fwd":
            feats, rois, strides, out, s = args[:5]
            want = t_predict.bytes_and_ops(
                rois.numpy(), out, s, feats[0].element_size(),
                sizes=[tuple(f.shape[1:3]) for f in feats],
                strides=strides, channels=feats[0].shape[-1])
        else:
            accs, rois, g, strides, out, s = args[:6]
            want = t_predict.bytes_and_ops(
                rois.numpy(), out, s, g.element_size(), backward=True,
                sizes=[tuple(a.shape[1:3]) for a in accs], strides=strides,
                channels=g.shape[-1])
        assert (o.bytes, o.flops) == want
    # none of the plain versions' operations (index_add_, the taps'
    # gathers) is counted: the ROIAlign components hold the kernels and
    # the backward's additions of the features' gradients only
    rest = [o.name for o in counts.ops
            if o.component in ("roi-fwd", "roi-bwd") and o.kind != "kernel"]
    assert set(rest) <= {"aten.add.Tensor"}, rest


def test_every_byte_has_a_component_and_other_is_small(step_counts):
    _, counts, _ = step_counts
    rows = counts.by_component()
    total = sum(r["bytes"] for r in rows.values())
    assert total == sum(o.bytes for o in counts.ops)
    assert all(o.component for o in counts.ops)
    assert 100.0 * rows.get("other", {"bytes": 0})["bytes"] / total \
        <= OTHER_MAX_PCT
    # every model component of the step shows up, forward and backward
    for comp in FORWARD:
        assert rows[comp]["flops"] > 0 and rows[comp + "-bwd"]["flops"] > 0
    assert rows["optimizer"]["bytes"] > 0


def test_prediction_has_the_reference_keys_and_sums(step_counts):
    _, counts, _ = step_counts
    pred = t_predict.predict_for_step(counts, device_kind=None,
                                      mesh_shape={"data": 1, "model": 1})
    for key in ("predicted_step_time_ms", "sections_ms", "components_ms",
                "component_costs", "comms_ms", "collectives", "totals",
                "comm_sizes", "hbm", "target", "precision"):
        assert key in pred, key
    assert pred["target"] == "h100"
    total = pred["predicted_step_time_ms"]
    assert sum(pred["sections_ms"].values()) == pytest.approx(total,
                                                              rel=1e-12)
    assert sum(pred["components_ms"].values()) == pytest.approx(total,
                                                                rel=1e-12)
    assert pred["sections_ms"]["bwd"] > 0 and pred["sections_ms"]["fwd"] > 0
    # world 1: the all-reduce moves nothing
    assert pred["collectives"][0]["predicted_ms"] == 0.0
    assert pred["model_flops"] == pred["totals"]["flops"]
    hbm = pred["hbm"]
    assert hbm["capacity"]["fits"]
    assert hbm["peak_hbm_bytes"] == max(p["live_bytes"]
                                        for p in hbm["timeline"])
    assert len(hbm["timeline"]) <= 64
    assert sum(hbm["live_at_peak_by_component"].values()) \
        == hbm["peak_hbm_bytes"]


def test_grad_exchange_is_priced_once_from_the_plan(step_counts):
    _, counts, _ = step_counts
    grads = counts.meta["grad_bytes"]
    pred = t_predict.predict_for_step(counts, mesh_shape={"data": 8})
    (row,) = pred["collectives"]
    assert row["opcode"] == "all-reduce" and row["bytes"] == grads
    spec = t_predict.CHIP_SPECS["h100"]
    want = grads * 2 * 7 / 8 / spec["ici_bytes_per_sec"] * 1e3
    assert row["predicted_ms"] == pytest.approx(want, rel=1e-12)
    assert pred["sections_ms"]["comms"] == pytest.approx(want, rel=1e-12)
    fsdp = t_predict.predict_for_step(counts, mesh_shape={"fsdp": 4},
                                      strategy="fsdp")
    assert [r["opcode"] for r in fsdp["collectives"]] == [
        "all-gather", "reduce-scatter"]


def test_remat_recompute_is_tallied_in_the_backward_and_apart():
    cfg = smoke_cfg(t_config, "TRAIN.REMAT=True")
    counts, _ = _counted_step(cfg)
    layers = layer_counts(cfg)
    recompute = counts.flops(kinds=MATMUL, recompute=True)
    fwd = sum(counts.flops(c, MATMUL) for c in ("backbone", "fpn-conv"))
    # the backbone reruns whole; the FPN's recompute stops once the last
    # saved input exists (checkpoint's early stop)
    assert counts.flops("backbone-bwd", MATMUL, recompute=True) \
        == counts.flops("backbone", MATMUL)
    assert 0 < recompute <= fwd
    for comp in ("backbone", "fpn-conv"):
        assert counts.flops(comp + "-bwd", MATMUL, recompute=False) == sum(
            f * m for f, m in layers[comp])
    pred = t_predict.predict_for_step(counts)
    assert pred["recompute_flops"] >= recompute
    assert pred["model_flops"] == pred["totals"]["flops"] \
        - pred["recompute_flops"]


def test_predict_step_counts_the_forward_only(step_counts):
    """``count_predict_step`` on one SMOKE predict forward on the same
    canvas: the trunk's FLOPs equal the training step's forward, nothing
    is backward, the two ROIAlign forwards (box, mask) are counted by
    their closed form, and no collective is priced."""
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.models import MaskRCNN

    cfg, train_counts, _ = step_counts
    model = MaskRCNN.from_config(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    images = torch.rand(BATCH, IMG, IMG, 3)
    hw = torch.full((BATCH, 2), float(IMG))
    out, counts = t_predict.count_predict_step(model.eval(), images, hw)
    assert out["boxes"].shape[0] == BATCH
    for comp in ("backbone", "fpn-conv", "rpn-head"):
        assert counts.flops(comp, MATMUL) == \
            train_counts.flops(comp, MATMUL)
    assert not any(o.backward for o in counts.ops)
    assert [o.name for o in counts.kernel_calls()] == ["roi_align_fwd"] * 2
    pred = t_predict.predict_for_step(counts, mesh_shape={"data": 8})
    assert pred["collectives"] == [] and pred["sections_ms"]["bwd"] == 0.0
    assert pred["meta"]["kind"] == "predict"


# ---------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(64, 64))    # 16384 B

    def forward(self, x):                                  # [32, 64]
        with named_scope("backbone"):
            h = x @ self.w                                 # 8192 B
        with named_scope("fpn"):
            y = torch.relu(h)                              # 8192 B
        del h
        with named_scope("rpn"):
            z = torch.cat([y, y])                          # 16384 B
        del y
        return z.sum()                                     # 4 B


def test_liveness_of_a_toy_module_equals_the_hand_count():
    model = Toy()
    x = torch.ones(32, 64)
    counter = t_predict.StepCounter("cpu", {"params": [model.w],
                                            "batch": [x]}, model=model)
    with torch.no_grad(), counter:
        model(x)
    counts = counter.counts()
    assert [o.name for o in counts.ops] == [
        "aten.mm.default", "aten.relu.default", "aten.cat.default",
        "aten.sum.default"]
    # after each op: h; h + y; y + z (h freed); z + s (y freed)
    assert counts.timeline == [8192, 16384, 24576, 16388]
    hbm = t_memory.analyze_memory(counts)
    assert hbm["peak_hbm_bytes"] == 16384 + 8192 + 24576
    assert hbm["peak_opcode"] == "aten.cat.default"
    assert hbm["live_at_peak_by_component"] == {
        "params": 16384, "rpn-head": 16384, "batch": 8192,
        "fpn-conv": 8192}
    assert [t["bytes"] for t in hbm["top_tensors"]] == [16384, 8192]
    assert hbm["resident_bytes"] == {"params": 16384, "batch": 8192}


# ---------------------------------------------------------------------
# the pure functions, against the reference's
# ---------------------------------------------------------------------


def test_ring_factor_and_hierarchical_split_equal_the_reference():
    for op in ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all", "all-reduce-start"):
        for k in (0, 1, 2, 3, 8, 64):
            assert t_predict._ring_factor(op, k) == \
                j_predict._ring_factor(op, k)
    for args in ((1e9, 16, 8, 450e9, 50e9), (3e6, 64, 8, 1e11, 1e10),
                 (1e8, 4, 1, 2e11, 2e10)):
        assert t_predict.hierarchical_allreduce_split(*args) == \
            j_predict.hierarchical_allreduce_split(*args)
        assert t_predict.hierarchical_allreduce_seconds(*args) == \
            j_predict.hierarchical_allreduce_seconds(*args)


@pytest.mark.parametrize("exchange", ["flat", "hierarchical"])
def test_price_collective_equals_the_reference(exchange):
    groups = [((0, 1, 2, 3),), ((0, 4), (1, 5), (2, 6), (3, 7)),
              (tuple(range(8)),), ((0, 1, 4, 5), (2, 3, 6, 7))]
    for g in groups:
        for slice_devices in (None, 0, 4, 2):
            for op in ("all-reduce", "all-gather", "reduce-scatter"):
                args = (op, 1.5e8, g, slice_devices, 450e9, 50e9)
                assert t_predict.price_collective(
                    *args, exchange=exchange) == j_predict.price_collective(
                    *args, exchange=exchange)


def test_comm_sizes_and_section_of_equal_the_reference():
    for mesh in ({}, {"data": 8}, {"fsdp": 4, "data": 2},
                 {"slice": 2, "data": 1, "fsdp": 4, "model": 2}):
        assert t_predict.comm_sizes_for_mesh(mesh) == \
            j_predict.comm_sizes_for_mesh(mesh)
    for comp in ("allreduce", "optimizer", "backbone-bwd", "backbone",
                 "other", "roi-bwd", "roi-fwd"):
        assert t_predict.section_of(comp) == j_predict.section_of(comp)


def test_compare_predictions_equals_the_reference():
    base = {"predicted_step_time_ms": 100.0,
            "components_ms": {"backbone": 50.0, "fpn-conv": 30.0,
                              "roi-fwd": 0.5, "other": 19.5}}
    for fresh in (
            {"predicted_step_time_ms": 100.0,
             "components_ms": dict(base["components_ms"])},
            {"predicted_step_time_ms": 120.0,
             "components_ms": {"backbone": 70.0, "fpn-conv": 30.0,
                               "other": 20.0}},
            {"predicted_step_time_ms": 101.0,
             "components_ms": {"backbone": 20.0, "fpn-conv": 65.0,
                               "other": 16.0}},
            {"predicted_step_time_ms": 104.0,
             "components_ms": {"backbone": 50.0, "fpn-conv": 30.0,
                               "new-thing": 9.0, "other": 15.0}}):
        for bound in (10.0, 5.0):
            assert t_predict.compare_predictions(fresh, base, bound) == \
                j_predict.compare_predictions(fresh, base, bound)
    assert t_predict.compare_predictions(
        base, {"predicted_step_time_ms": 0.0}) == \
        j_predict.compare_predictions(base, {"predicted_step_time_ms": 0.0})


def test_calibrate_equals_the_reference(tmp_path):
    points = [{"rung": "a", "measured_ms": 120.0, "predicted_ms": 40.0,
               "measured_source": "x", "fit_group": "measured"},
              {"rung": "b", "measured_ms": 300.0, "predicted_ms": 90.0,
               "measured_source": "y", "fit_group": "measured"},
              {"rung": "c", "measured_ms": 50.0, "predicted_ms": 2.0,
               "measured_source": "z", "fit_group": "smoke"}]
    for pts in (points, points[:1], []):
        assert t_predict.calibrate(pts) == j_predict.calibrate(pts)
    # the glob route reads bench records that carry their prediction
    import json

    for name, rec in (("1344_b4", {"step_time_ms": 320.0,
                                   "predicted_step_time_ms": 180.0,
                                   "operating_point": "1344_b4"}),
                      ("micro", {"step_time_ms": 9.0,
                                 "predicted_step_time_ms": 3.0,
                                 "forward_only": True})):
        (tmp_path / f"bench_rung_{name}.json").write_text(json.dumps(rec))
    got = t_predict.calibration_points(str(tmp_path))
    assert got == j_predict.calibration_points(str(tmp_path))
    assert [p["rung"] for p in got] == ["1344_b4"]


def test_spec_lookup_reads_the_table(monkeypatch):
    assert t_predict.target_for_device_kind("NVIDIA H100 80GB HBM3") \
        == "h100"
    # the PCIe and NVL parts have other peaks: not this row
    for kind in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "cpu", None, ""):
        assert t_predict.target_for_device_kind(kind) is None
    with pytest.raises(ValueError, match="unknown target"):
        t_predict.chip_spec("v5e")
    # given the reference's rows, the lookups answer as the reference's
    monkeypatch.setattr(t_predict, "CHIP_SPECS", j_predict.CHIP_SPECS)
    monkeypatch.setattr(t_predict, "DEVICE_KIND_TO_TARGET",
                        j_predict.DEVICE_KIND_TO_TARGET)
    for target in j_predict.CHIP_SPECS:
        assert t_predict.chip_spec(target) == j_predict.chip_spec(target)
    for kind in ("TPU v5 lite", "TPU v4", "cpu", None):
        assert t_predict.target_for_device_kind(kind) == \
            j_predict.target_for_device_kind(kind)


# ---------------------------------------------------------------------
# the trainer's knob
# ---------------------------------------------------------------------


def _fit(knob, monkeypatch):
    published = []
    real = t_predict.publish_predicted_gauge

    def spy(pred, registry=None):
        published.append(pred["predicted_step_time_ms"])
        return real(pred, registry)

    monkeypatch.setattr(t_predict, "publish_predicted_gauge", spy)
    cfg = smoke_cfg(t_config, "TRAIN.LOG_PERIOD=1",
                    f"TELEMETRY.PREDICTED_STEP_TIME={knob}")
    with tempfile.TemporaryDirectory() as logdir:
        trainer = t_train.Trainer(cfg, logdir, device="cpu")
        rows = trainer.fit(_batches(cfg), total_steps=2)
        pred = trainer.last_prediction
        trainer.close()
    return rows, published, pred


def test_predicted_step_time_knob_keeps_the_losses_and_publishes_once(
        monkeypatch):
    on, published_on, pred = _fit(True, monkeypatch)
    off, published_off, none = _fit(False, monkeypatch)
    keys = [k for k in on[0] if k.endswith("_loss")] + ["grad_norm"]
    assert keys
    for a, b in zip(on, off):
        for k in keys:
            assert a[k] == b[k], k
    assert len(published_on) == 1 and published_on[0] > 0
    assert pred["predicted_step_time_ms"] == published_on[0]
    assert published_off == [] and none is None
