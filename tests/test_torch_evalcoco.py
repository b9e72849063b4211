"""The port's COCO evaluation (``eksml_tpu_torch/evalcoco``) against
``eksml_tpu/evalcoco`` and against ``tests/coco_oracle.py`` on the same
seeded inputs, on the CPU:

- ``COCOEvaluator`` on the oracle test's fixtures (bbox on adversarial
  scenes, segm with crowd, score ties, empty sets): every metric equal
  to the JAX package's and the oracle's to 1e-12.
- The C++ mask ops (``evalcoco/native_src/maskops.cc``): RLE counts,
  IoU matrices and greedy matches identical to the reference's library
  and to the port's numpy paths; ``compress_counts`` and ``rle_encode``
  byte-equal to the reference's.
- ``run_evaluation`` with a stub predictor (the ground truth with
  jitter, the same in both runners): AP dicts equal and non-zero, on the
  square canvas and with ``PREPROC.BUCKETS``.
- ``run_evaluation`` with the real model at SMOKE widths on
  ``mini_coco``'s val images, from ``convert.from_flax`` weights: the
  raw detections to the serve parity test's tolerances (boxes 1e-3 px,
  scores 1e-5, masks 1e-4; classes and validity equal) and the AP
  dicts to 1e-6.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import conftest  # noqa: E402
from coco_oracle import OracleEval  # noqa: E402
from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.data import masks as j_masks  # noqa: E402
from eksml_tpu.data.coco import CocoDataset as JCocoDataset  # noqa: E402
from eksml_tpu.evalcoco import cocoeval as j_cocoeval  # noqa: E402
from eksml_tpu.evalcoco import native as j_native  # noqa: E402
from eksml_tpu.evalcoco import runner as j_runner  # noqa: E402
from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch._native import LIBRARIES, build_all  # noqa: E402
from eksml_tpu_torch.convert import (flax_leaves, from_flax,  # noqa: E402
                                     init_params)
from eksml_tpu_torch.data import masks as t_masks  # noqa: E402
from eksml_tpu_torch.data.coco import CocoDataset  # noqa: E402
from eksml_tpu_torch.evalcoco import cocoeval as t_cocoeval  # noqa: E402
from eksml_tpu_torch.evalcoco import native as t_native  # noqa: E402
from eksml_tpu_torch.evalcoco import runner as t_runner  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from test_evalcoco_oracle import (KEYS, _bbox_fixture,  # noqa: E402
                                  _rect_mask)
from torch_dist_ranks import (EVAL_BUCKETS, EVAL_OVERRIDES,  # noqa: E402
                              gt_stub, shape_records)

EVALUATORS = {"eksml_tpu": j_cocoeval.COCOEvaluator,
              "eksml_tpu_torch": t_cocoeval.COCOEvaluator}


def _cfg(config_mod, *extra):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + list(EVAL_OVERRIDES)
                    + ["TELEMETRY.PORT=0"] + list(extra))
    cfg.freeze()
    return cfg


def _all_three(calls, iou_type, num_classes, recs, oracle_gt, oracle_dt):
    """The two evaluators and the oracle over one fixture; returns their
    result dicts."""
    out = {}
    for name, cls in EVALUATORS.items():
        ev = cls(recs, num_classes=num_classes, iou_type=iou_type)
        for args, kw in calls:
            ev.add_detections(*args, **kw)
        out[name] = ev.accumulate()
    orc = OracleEval(iou_type)
    for iid, g in oracle_gt.items():
        orc.add_gt(iid, g)
    for iid, d in oracle_dt.items():
        orc.add_dt(iid, d)
    out["oracle"] = orc.accumulate()
    return out


def _agree(out, keys=KEYS, tol=1e-12):
    port = out["eksml_tpu_torch"]
    assert set(port) == set(out["eksml_tpu"])
    for k in port:
        assert abs(port[k] - out["eksml_tpu"][k]) <= tol, k
    for k in keys:
        assert abs(port.get(k, -1.0) - out["oracle"].get(k, -1.0)) <= tol, k


# ---------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_bbox_evaluator_matches_jax_and_oracle(seed):
    recs, o_gts, o_dts, det_calls = _bbox_fixture(seed)
    calls = [((iid, b, s, c), {}) for iid, b, s, c in det_calls if len(b)]
    _agree(_all_three(calls, "bbox", 3, recs, o_gts, o_dts))


@pytest.mark.parametrize("rle", [False, True])
def test_segm_evaluator_with_crowd_matches_jax_and_oracle(rle):
    """The segm fixture of the oracle test (a crowd absorbing two
    detections, sloppy boxes), as dense masks and as RLE dicts."""
    H = W = 96
    gt_masks = [_rect_mask(H, W, 10, 10, 40, 40),
                _rect_mask(H, W, 50, 50, 90, 90)]
    det_masks = [_rect_mask(H, W, 12, 12, 40, 40),
                 _rect_mask(H, W, 52, 52, 80, 80),
                 _rect_mask(H, W, 60, 60, 88, 88),
                 _rect_mask(H, W, 0, 60, 20, 90)]
    enc = t_masks.rle_encode if rle else (lambda m: m)
    recs = [{"image_id": 0,
             "boxes": np.asarray([[10, 10, 40, 40], [50, 50, 90, 90]],
                                 np.float64),
             "classes": np.asarray([0, 0], np.int64),
             "iscrowd": np.asarray([0, 1], np.int64),
             "areas": np.asarray([900.0, 1600.0]),
             "masks": [enc(m) for m in gt_masks]}]
    boxes = np.asarray([[0, 0, 95, 95]] * 4, np.float64)
    scores = np.asarray([0.9, 0.8, 0.7, 0.6])
    calls = [((0, boxes, scores, np.zeros(4, np.int64)),
              {"masks": [enc(m) for m in det_masks]})]
    o_gt = {0: [{"bbox": [10, 10, 30, 30], "area": 900.0, "iscrowd": 0,
                 "category_id": 0, "mask": gt_masks[0]},
                {"bbox": [50, 50, 40, 40], "area": 1600.0, "iscrowd": 1,
                 "category_id": 0, "mask": gt_masks[1]}]}
    o_dt = {0: [{"bbox": [0, 0, 95, 95], "score": float(s),
                 "category_id": 0, "mask": m}
                for s, m in zip(scores, det_masks)]}
    _agree(_all_three(calls, "segm", 1, recs, o_gt, o_dt))


def test_tie_scores_and_empty_sets_match_jax_and_oracle():
    """Equal scores competing for one gt, a det better matched to an
    out-of-range gt (the tie fixture), then dets of a class with no gt
    and a gt with no dets on an empty image."""
    recs = [{"image_id": 0,
             "boxes": np.asarray([[0, 0, 32, 32], [40, 40, 140, 140]],
                                 np.float64),
             "classes": np.asarray([0, 0], np.int64),
             "iscrowd": np.asarray([0, 0], np.int64),
             "areas": np.asarray([1024.0, 10000.0])}]
    det_boxes = np.asarray([[0, 0, 30, 32], [2, 0, 32, 32],
                            [30, 30, 140, 140]], np.float64)
    calls = [((0, det_boxes, np.asarray([0.5, 0.5, 0.4]),
               np.zeros(3, np.int64)), {})]
    o_gt = {0: [{"bbox": [0, 0, 32, 32], "area": 1024.0, "iscrowd": 0,
                 "category_id": 0},
                {"bbox": [40, 40, 100, 100], "area": 10000.0,
                 "iscrowd": 0, "category_id": 0}]}
    o_dt = {0: [{"bbox": [0, 0, 30, 32], "score": 0.5, "category_id": 0},
                {"bbox": [2, 0, 30, 32], "score": 0.5, "category_id": 0},
                {"bbox": [30, 30, 110, 110], "score": 0.4,
                 "category_id": 0}]}
    _agree(_all_three(calls, "bbox", 1, recs, o_gt, o_dt))

    recs = [{"image_id": 0, "boxes": np.asarray([[5, 5, 50, 50]],
                                                np.float64),
             "classes": np.asarray([1], np.int64),
             "iscrowd": np.asarray([0], np.int64),
             "areas": np.asarray([2025.0])},
            {"image_id": 1, "boxes": np.zeros((0, 4)),
             "classes": np.zeros((0,), np.int64),
             "iscrowd": np.zeros((0,), np.int64), "areas": np.zeros((0,))}]
    calls = [((0, np.asarray([[60, 60, 90, 90]], np.float64),
               np.asarray([0.9]), np.asarray([0], np.int64)), {}),
             ((1, np.asarray([[10, 10, 30, 30]], np.float64),
               np.asarray([0.8]), np.asarray([1], np.int64)), {})]
    o_gt = {0: [{"bbox": [5, 5, 45, 45], "area": 2025.0, "iscrowd": 0,
                 "category_id": 1}], 1: []}
    o_dt = {0: [{"bbox": [60, 60, 30, 30], "score": 0.9, "category_id": 0}],
            1: [{"bbox": [10, 10, 20, 20], "score": 0.8, "category_id": 1}]}
    _agree(_all_three(calls, "bbox", 2, recs, o_gt, o_dt))
    # nothing at all: every metric -1 in all three
    out = {name: cls([], num_classes=2).accumulate()
           for name, cls in EVALUATORS.items()}
    assert out["eksml_tpu_torch"] == out["eksml_tpu"]
    assert set(out["eksml_tpu_torch"].values()) == {-1.0}


# ---------------------------------------------------------------------
# the C++ mask ops
# ---------------------------------------------------------------------


def test_both_native_libraries_build_into_the_port():
    libs = build_all()
    assert set(libs) == {"maskops", "imageops"}
    for lib in libs.values():
        assert lib.loaded, lib.error
        assert lib.src.startswith(os.path.join(REPO, "eksml_tpu_torch"))
        assert os.path.dirname(lib.lib_path) == os.path.join(
            REPO, "eksml_tpu_torch", "_build")
    assert LIBRARIES["maskops"] is t_native._LIB


def _random_masks(rng, n, h, w):
    out = []
    for _ in range(n):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
        m[y0:y0 + rng.randint(2, h - y0), x0:x0 + rng.randint(2, w - x0)] = 1
        m ^= (rng.rand(h, w) < 0.05).astype(np.uint8)   # ragged edges
        out.append(m)
    out[0][0, 0] = 1      # a mask that starts with a foreground run
    return out


@pytest.mark.parametrize("seed", range(3))
def test_native_mask_ops_match_jax_and_numpy(seed, monkeypatch):
    rng = np.random.RandomState(seed)
    h, w = 37, 53
    dets, gts = _random_masks(rng, 6, h, w), _random_masks(rng, 4, h, w)
    crowd = np.asarray([0, 1, 0, 0], np.uint8)
    assert t_native.get_lib() is not None and j_native.get_lib() is not None

    rles = [t_masks.rle_encode(m) for m in dets]
    for m, r in zip(dets, rles):
        want = j_masks.rle_encode(m)
        assert r == want and t_native.rle_encode_native(m) == want["counts"]
        assert t_masks.compress_counts(r["counts"]) == \
            j_masks.compress_counts(want["counts"])
        np.testing.assert_array_equal(t_masks.rle_decode(r), m)
    dense = t_native.mask_iou_native(dets, gts, crowd)
    np.testing.assert_array_equal(dense,
                                  j_native.mask_iou_native(dets, gts, crowd))
    g_rles = [t_masks.rle_encode(m) for m in gts]
    rle = t_native.rle_iou_masks(rles, g_rles, crowd)
    np.testing.assert_array_equal(rle, j_native.rle_iou_masks(rles, g_rles,
                                                              crowd))
    np.testing.assert_array_equal(rle, dense)
    ignore = crowd.astype(bool) | (rng.rand(4) < 0.3)
    g_order = np.argsort(ignore, kind="mergesort")
    thr = t_cocoeval.IOU_THRESHS
    got = t_native.greedy_match_native(dense, crowd, ignore, g_order, thr)
    want = j_native.greedy_match_native(dense, crowd, ignore, g_order, thr)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

    # the port's numpy paths give the same answers, the evaluator's
    # python greedy loop included
    def segm_eval():
        ev = t_cocoeval.COCOEvaluator(
            [{"image_id": 0, "boxes": np.tile([[0., 0., w, h]], (4, 1)),
              "classes": np.ones(4, np.int64), "iscrowd": crowd,
              "masks": gts}], num_classes=2, iou_type="segm")
        ev.add_detections(0, np.tile([[0., 0., w, h]], (6, 1)),
                          np.random.RandomState(seed).rand(6),
                          np.ones(6, np.int64), masks=dets)
        return ev.accumulate()

    native = segm_eval()
    monkeypatch.setattr(t_native, "get_lib", lambda: None)
    assert t_native.mask_iou_native(dets, gts, crowd) is None
    assert t_native.greedy_match_native(dense, crowd, ignore, g_order,
                                        thr) is None
    np.testing.assert_array_equal(
        t_cocoeval.mask_iou(dets, gts, crowd), dense)
    np.testing.assert_array_equal(
        t_native.rle_iou_masks(rles, g_rles, crowd), dense)
    for m, r in zip(dets, rles):
        assert t_masks.rle_encode(m) == r
    assert segm_eval() == native


# ---------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------

@pytest.mark.parametrize("bucketed", [False, True])
def test_run_evaluation_with_a_stub_matches_jax(bucketed):
    extra = [EVAL_BUCKETS] if bucketed else []
    records = shape_records()
    results, seen = {}, {}
    for name, mod, cfg_mod in (("eksml_tpu", j_runner, j_config),
                               ("eksml_tpu_torch", t_runner, t_config)):
        cfg = _cfg(cfg_mod, *extra)
        seen[name] = []
        stub = gt_stub(records, seen[name])
        if mod is j_runner:
            results[name] = mod.run_evaluation(None, None, cfg, records,
                                               batch_size=2, predict_fn=stub)
        else:
            results[name] = mod.run_evaluation(None, cfg, records,
                                               batch_size=2, predict_fn=stub,
                                               device="cpu")
    got, want = results["eksml_tpu_torch"], results["eksml_tpu"]
    assert set(got) == set(want) and "segm/AP" in got
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert got["bbox/AP"] > 0.2 and got["segm/AP"] > 0.2
    assert seen["eksml_tpu_torch"] == seen["eksml_tpu"]
    canvases = set(seen["eksml_tpu_torch"])
    assert canvases == ({(64, 128), (128, 64), (128, 128)} if bucketed
                        else {(128, 128)})


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = _cfg(t_config)
    with pytest.raises(RuntimeError, match="cuda"):
        t_runner.run_evaluation(None, cfg, shape_records(),
                                predict_fn=lambda *a: {})
    with pytest.raises(RuntimeError, match="cuda"):
        t_runner.make_eval_fn(cfg)


@pytest.fixture(scope="module")
def real_weights(tmp_path_factory):
    """``mini_coco`` and one set of weights in both packages: the port's
    seeded init as a Flax tree, and ``from_flax`` of that tree."""
    base = conftest.mini_coco.__wrapped__(tmp_path_factory.mktemp("coco"))
    tcfg, jcfg = _cfg(t_config), _cfg(j_config)
    tree = {}
    for name, t in flax_leaves(init_params(
            tcfg, torch.Generator().manual_seed(3))):
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(np.ascontiguousarray(t.numpy()))
    model = MaskRCNN.from_config(tcfg)
    model.load_state_dict(from_flax(tree))
    return base, tcfg, jcfg, tree, model


@pytest.fixture(scope="module")
def real_eval(real_weights):
    """Both runners with the real model on ``mini_coco``'s val images
    from the same weights, each predict output kept."""
    base, tcfg, jcfg, tree, model = real_weights
    flax_model = FlaxMaskRCNN.from_config(jcfg)
    jax_predict = j_runner.make_predict_fn(flax_model)
    outs = {"eksml_tpu": [], "eksml_tpu_torch": []}

    def keep(name, out):
        outs[name].append({k: np.asarray(v) for k, v in out.items()})
        return out

    t_recs = CocoDataset(base, "val2017").records(skip_empty=False)
    j_recs = JCocoDataset(base, "val2017").records(skip_empty=False)
    res = {
        "eksml_tpu_torch": t_runner.run_evaluation(
            model, tcfg, t_recs, batch_size=2, device="cpu",
            predict_fn=lambda m, im, hw: keep(
                "eksml_tpu_torch",
                {k: v.numpy() for k, v in t_runner.predict(m, im,
                                                           hw).items()})),
        "eksml_tpu": j_runner.run_evaluation(
            flax_model, tree, jcfg, j_recs, batch_size=2,
            predict_fn=lambda p, im, hw: keep("eksml_tpu",
                                              jax_predict(p, im, hw)))}
    return res, outs


def test_run_evaluation_with_the_model_matches_jax_detections(real_eval):
    _, outs = real_eval
    got, want = outs["eksml_tpu_torch"], outs["eksml_tpu"]
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["valid"].any()
        np.testing.assert_array_equal(g["valid"].sum(1), w["valid"].sum(1))
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(g["masks"], w["masks"], rtol=0, atol=1e-4)


def test_run_evaluation_with_the_model_matches_jax_ap(real_eval):
    res, _ = real_eval
    got, want = res["eksml_tpu_torch"], res["eksml_tpu"]
    assert set(got) == set(want) and {"bbox/AP", "segm/AP"} <= set(got)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_eval_ckpt_ap_equals_the_reference_ap(real_weights, real_eval,
                                              tmp_path, capsys):
    """``python -m eksml_tpu_torch.tools.eval_ckpt`` on a port checkpoint
    of the ``from_flax`` weights: its AP equals the reference's
    ``run_evaluation`` on the same weights to 1e-6, from the newest
    verified step and from ``--step``; a missing step exits 1."""
    from eksml_tpu_torch.tools import eval_ckpt
    from eksml_tpu_torch.utils.checkpoint import CheckpointManager

    base, _, _, _, model = real_weights
    want = real_eval[0]["eksml_tpu"]
    ckpt = CheckpointManager(str(tmp_path))
    for step in (3, 5):
        ckpt.save(step, {"model": model.state_dict(), "step": step})
        ckpt.wait()
    ckpt.close()
    argv = ["--logdir", str(tmp_path), "--data", str(base), "--device",
            "cpu", "--config", *SMOKE_OVERRIDES, *EVAL_OVERRIDES,
            "TEST.EVAL_BATCH_SIZE=2"]
    for extra, step in (([], 5), (["--step", "3"], 3)):
        assert eval_ckpt.main(argv[:6] + extra + argv[6:]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got["step"] == step and got["num_images"] == 2
        assert {"bbox/AP", "segm/AP"} <= set(got)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, k
    assert eval_ckpt.main(argv[:6] + ["--step", "4"] + argv[6:]) == 1


# ---------------------------------------------------------------------
# chip_smoke.py's eval phases, rehearsed on the CPU
# ---------------------------------------------------------------------


def test_chip_smoke_eval_phases_run_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s train, eval, eval_reference and coco phases at
    SMOKE widths on the CPU, the last two on 128² canvases (the wrappers
    take their plain versions,
    counted here as the kernels would be; the eval_reference's "card"
    run is a second CPU run): 2 ROIAlign forward launches per eval batch,
    equal detections and AP, one bucketed training step, and
    ``train.main`` on the shapes JPEGs with val AP at steps 1 and 2."""
    import chip_smoke

    import eksml_tpu_torch.device as t_device
    import eksml_tpu_torch.train as t_train
    from eksml_tpu_torch.ops.cuda import roi_align_kernel
    from eksml_tpu_torch.ops.roi_align import KERNELS

    monkeypatch.setattr(chip_smoke, "BATCH", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "EVAL_IMAGES", 4)
    monkeypatch.setattr(chip_smoke, "REF_IMG", 128)
    monkeypatch.setattr(chip_smoke, "REF_BUCKETS",
                        "PREPROC.BUCKETS=((64,128),(128,64),(128,128))")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cpu = lambda device="cuda": torch.device("cpu")  # noqa: E731
    for mod in (t_device, t_train, t_runner):
        monkeypatch.setattr(mod, "resolve_device", cpu)

    def counted(kernel, fn):
        def call(*a, **k):
            kernel.launches += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(KERNELS.fwd, "_plain",
                        counted(KERNELS.fwd, KERNELS.fwd._plain))
    monkeypatch.setattr(KERNELS.bwd, "_plain",
                        counted(KERNELS.bwd, KERNELS.bwd._plain))
    copy = roi_align_kernel.CopyToGlobal.__call__
    monkeypatch.setattr(roi_align_kernel.CopyToGlobal, "__call__",
                        lambda self, src: counted(self, copy)(self, src))
    cfg = t_config.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + [
        "TRAIN.LOG_PERIOD=1", "TRAIN.BATCH_SIZE_PER_CHIP=2",
        "PREPROC.TEST_SHORT_EDGE_SIZE=128", "TEST.EVAL_BATCH_SIZE=2",
        "DATA.NUM_WORKERS=2", "TELEMETRY.PORT=0"])
    cfg.freeze()
    trainer, _, _ = chip_smoke.phase_train(cfg, KERNELS, 0,
                                           str(tmp_path / "train"))
    out = chip_smoke.phase_eval(cfg, KERNELS, trainer, str(tmp_path), 0)
    trainer.close()
    assert out["batches"] == 2
    assert out["launches"] == {"roi_align_fwd": 4, "roi_align_bwd": 0,
                               "copy_to_global": 0}
    ref = chip_smoke.phase_eval_reference(KERNELS, 0, str(tmp_path),
                                          device="cpu")
    assert ref["errors"] == {"boxes": 0.0, "scores": 0.0, "masks": 0.0,
                             "AP": 0.0}
    # as the lifecycle phase's in-process --synthetic run leaves it
    glob = t_config.config
    glob.freeze(False)
    glob.DATA.SYNTHETIC = True
    try:
        coco = chip_smoke.phase_coco(KERNELS, 0, str(tmp_path), device="cpu")
    finally:
        glob.freeze(False)
        glob.DATA.SYNTHETIC = False
        glob.freeze()
    assert sorted(coco["evals"]) == [1, 2]
    assert coco["launches"]["roi_align_bwd"] == 4   # 2 per training step
