"""The PyTorch port's ops (``eksml_tpu_torch/ops``) against the JAX
package on the CPU: boxes, anchors, NMS and the plain ROIAlign, plus the
CUDA wrapper's CPU route.  Inputs come from numpy seeds and go through
both implementations."""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from eksml_tpu.ops import anchors as j_anchors  # noqa: E402
from eksml_tpu.ops import boxes as j_boxes  # noqa: E402
from eksml_tpu.ops import nms as j_nms  # noqa: E402
from eksml_tpu.ops.pallas import roi_align_kernel as j_pallas  # noqa: E402
from eksml_tpu.ops.pallas.roi_align_kernel import (  # noqa: E402
    TILE, pallas_batched_multilevel_roi_align, sublane_align)
from eksml_tpu_torch.ops import anchors as t_anchors  # noqa: E402
from eksml_tpu_torch.ops import boxes as t_boxes  # noqa: E402
from eksml_tpu_torch.ops import nms as t_nms  # noqa: E402
from eksml_tpu_torch.ops import roi_align as t_roi  # noqa: E402
from eksml_tpu_torch.ops import sampling as t_sampling  # noqa: E402
from eksml_tpu_torch.ops.cuda.roi_align_kernel import (  # noqa: E402
    CopyToGlobal, RoiAlignBackward, RoiAlignForward, RoiAlignFunction,
    RoiAlignKernels)

# the module (eksml_tpu.ops re-exports a function of the same name)
j_roi = importlib.import_module("eksml_tpu.ops.roi_align")

STRIDES = (4, 8, 16, 32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _random_boxes(rng, n, img=128.0, degenerate=0):
    xy = rng.rand(n, 2) * img
    wh = rng.rand(n, 2) * img / 3 + 1.0
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if degenerate:
        boxes[:degenerate, 2:] = boxes[:degenerate, :2]   # zero area
    return boxes


# ---------------------------------------------------------------------
# boxes and anchors
# ---------------------------------------------------------------------


def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    a = _random_boxes(rng, 40, degenerate=3)
    b = _random_boxes(rng, 30)
    np.testing.assert_allclose(
        t_boxes.pairwise_iou(_t(a), _t(b)).numpy(),
        np.asarray(j_boxes.pairwise_iou(a, b)), rtol=1e-6, atol=1e-7)
    w = (10.0, 10.0, 5.0, 5.0)
    anchors = _random_boxes(rng, 40)
    np.testing.assert_allclose(
        t_boxes.encode_boxes(_t(a[3:]), _t(anchors[3:]), w).numpy(),
        np.asarray(j_boxes.encode_boxes(a[3:], anchors[3:], w)),
        rtol=1e-5, atol=1e-5)
    # deltas past clip_exp=4.135 must clamp, not overflow
    deltas = (rng.randn(40, 4) * 4).astype(np.float32)
    deltas[:5, 2:] = 50.0
    got = t_boxes.decode_boxes(_t(deltas), _t(anchors), w).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_boxes.decode_boxes(deltas, anchors, w)),
        rtol=1e-5, atol=1e-3)
    assert np.isfinite(got).all()
    hw = np.asarray([[100.0, 80.0]] * 40, np.float32)
    boxes = (rng.randn(40, 4) * 120).astype(np.float32)
    np.testing.assert_array_equal(
        t_boxes.clip_boxes(_t(boxes), _t(hw[:, 0]), _t(hw[:, 1])).numpy(),
        np.asarray(j_boxes.clip_boxes(boxes, hw[:, 0], hw[:, 1])))


def test_anchors_match_jax():
    args = ((256, 192), (4, 8, 16, 32, 64), (32, 64, 128, 256, 512),
            (0.5, 1.0, 2.0))
    for got, want in zip(t_anchors.generate_fpn_anchors(*args),
                         j_anchors.generate_fpn_anchors(*args)):
        np.testing.assert_array_equal(got, want)
    assert t_anchors.num_anchors_per_level(args[0], args[1], 3) == \
        j_anchors.num_anchors_per_level(args[0], args[1], 3)


def test_top_k_breaks_ties_like_lax_top_k():
    x = np.asarray([[1.0, 3.0, 3.0, -np.inf, 2.0, 3.0, -np.inf, -np.inf],
                    [-np.inf] * 8], np.float32)
    vals, idx = t_nms.top_k(_t(x), 6)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


# ---------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------


def _nms_case(kind, rng):
    """Clustered boxes (long suppression chains), with score ties and
    -inf padding rows."""
    k = 300                       # > one 256-box tile
    centers = rng.rand(12, 2) * 100
    c = centers[rng.randint(0, 12, k)] + rng.randn(k, 2) * 3
    wh = 10 + rng.rand(k, 2) * 8
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.rand(k).astype(np.float32)
    if kind in ("ties", "ties_and_padding"):
        scores = np.round(scores * 8) / 8        # heavy ties
    if kind in ("padding", "ties_and_padding"):
        pad = rng.rand(k) < 0.2
        scores[pad] = -np.inf
        boxes[pad] = 0.0
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("kind", ["plain", "ties", "padding",
                                  "ties_and_padding"])
def test_nms_mask_matches_jax(kind):
    boxes, scores = _nms_case(kind, np.random.RandomState(1))
    want = np.asarray(j_nms.nms_mask(boxes, scores, 0.5))
    got = t_nms.nms_mask(_t(boxes), _t(scores), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    seq = t_nms.nms_mask_sequential(_t(boxes), _t(scores), 0.5).numpy()
    np.testing.assert_array_equal(seq, want)
    # small tiles: the cross-tile suppression path
    np.testing.assert_array_equal(
        t_nms.nms_mask(_t(boxes), _t(scores), 0.5, tile=32).numpy(), want)


def test_batched_nms_mask_equals_per_member():
    """All members iterate together until every one has converged; the
    result still equals NMS of each member alone."""
    rng = np.random.RandomState(2)
    cases = [_nms_case(kind, rng) for kind in ("plain", "ties", "padding")]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    got = t_nms.nms_mask(_t(boxes), _t(scores), 0.7).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(j_nms.nms_mask(boxes[i], scores[i], 0.7)))


@pytest.mark.parametrize("kind", ["ties", "ties_and_padding"])
def test_topk_nms_matches_jax(kind):
    boxes, scores = _nms_case(kind, np.random.RandomState(3))
    j_idx, j_sc, j_valid = j_nms._topk_nms(jnp.asarray(boxes),
                                          jnp.asarray(scores), 0.5, 100)
    idx, sc, valid = t_nms._topk_nms(_t(boxes), _t(scores), 0.5, 100)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(j_sc))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))


def test_class_aware_nms_matches_jax():
    boxes, scores = _nms_case("ties_and_padding", np.random.RandomState(4))
    cls = np.random.RandomState(5).randint(1, 6, len(scores)).astype(np.int32)
    want = j_nms.class_aware_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                 0.5, 50, class_ids=jnp.asarray(cls))
    got = t_nms.class_aware_nms(_t(boxes), _t(scores), 0.5, 50,
                                class_ids=_t(cls))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # batched: one offset scale per image, as under the reference's vmap
    got_b = t_nms.class_aware_nms(_t(boxes)[None].repeat(2, 1, 1),
                                  _t(scores)[None].repeat(2, 1), 0.5, 50,
                                  class_ids=_t(cls)[None].repeat(2, 1))
    for g, w in zip(got_b, want):
        np.testing.assert_array_equal(g.numpy()[1], np.asarray(w))


# ---------------------------------------------------------------------
# ROIAlign (plain version)
# ---------------------------------------------------------------------


def _feats(rng, b=2, img=128, c=16):
    return [rng.randn(b, img // s, img // s, c).astype(np.float32)
            for s in STRIDES]


def _rois(rng, b, n, img=128):
    out = []
    for _ in range(b):
        ctr = rng.rand(n, 2) * img * 0.6 + img * 0.2
        size = np.exp(rng.rand(n) * np.log(24)) * 4
        ar = np.exp(rng.randn(n) * 0.3)
        w, h = size * ar, size / ar
        x1 = np.clip(ctr[:, 0] - w / 2, 1, img - 2)
        y1 = np.clip(ctr[:, 1] - h / 2, 1, img - 2)
        out.append(np.stack([x1, y1, np.clip(x1 + w, None, img - 2),
                             np.clip(y1 + h, None, img - 2)], 1))
    rois = np.stack(out).astype(np.float32)
    # a border ROI (zero-padded taps), a ROI larger than P5 (whose 4x4
    # map is far below the TPU kernel's 64x64 tile), a sub-pixel ROI
    rois[0, 0] = [0.0, 0.0, 12.0, 9.0]
    rois[-1, 1] = [-40.0, -30.0, 170.0, 150.0]
    rois[-1, 2] = [50.0, 50.0, 50.4, 50.7]
    return rois


@pytest.mark.parametrize("out_size", [7, 14])
def test_plain_roi_align_matches_jax(out_size):
    rng = np.random.RandomState(out_size)
    feats = _feats(rng)
    rois = _rois(rng, 2, 24)
    want = np.asarray(j_roi.batched_multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES,
        out_size))
    got = t_roi.batched_multilevel_roi_align(
        [_t(f) for f in feats], _t(rois), STRIDES, out_size)
    assert got.shape == (2, 24, out_size, out_size, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_array_equal(
        t_roi.assign_fpn_levels(_t(rois.reshape(-1, 4))).numpy(),
        np.asarray(j_roi.assign_fpn_levels(jnp.asarray(rois.reshape(-1, 4)))))


def test_single_level_and_single_image_forms_match_jax():
    rng = np.random.RandomState(11)
    feats = _feats(rng, b=1)
    rois = _rois(rng, 1, 10)[0]
    np.testing.assert_allclose(
        t_roi.roi_align(_t(feats[0][0]), _t(rois), 0.25, 7).numpy(),
        np.asarray(j_roi.roi_align(jnp.asarray(feats[0][0]),
                                   jnp.asarray(rois), 0.25, 7)), atol=1e-4)
    np.testing.assert_allclose(
        t_roi.multilevel_roi_align([_t(f[0]) for f in feats], _t(rois),
                                   STRIDES, 14).numpy(),
        np.asarray(j_roi.multilevel_roi_align(
            [jnp.asarray(f[0]) for f in feats], jnp.asarray(rois), STRIDES,
            14)), atol=1e-4)


def test_plain_roi_align_matches_pallas_kernel_interpret():
    """Against the TPU kernel itself (interpret mode), on ROIs whose
    tile-fit level equals the FPN heuristic level — the case where the
    two level rules agree."""
    rng = np.random.RandomState(7)
    feats = _feats(rng)
    rois = _rois(rng, 2, 16)
    rois[1, 1] = [20.0, 24.0, 100.0, 90.0]     # replace the >P5 ROI
    flat = jnp.asarray(rois.reshape(-1, 4))
    same = np.asarray(
        j_roi.assign_fpn_levels_tile_fit(flat, STRIDES, 4, TILE,
                                         align=sublane_align(jnp.float32))
        == j_roi.assign_fpn_levels(flat) - 2)
    assert same.all()
    want = np.asarray(pallas_batched_multilevel_roi_align(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois), STRIDES,
        7, 2, 2, True))
    got = t_roi.batched_multilevel_roi_align(
        [_t(f) for f in feats], _t(rois), STRIDES, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_plain_roi_align_bf16_accumulates_in_f32():
    """bf16 features: coordinates and sums in f32, one rounding at the
    end — equal to the f32 result on the same (bf16-exact) values,
    rounded once."""
    rng = np.random.RandomState(9)
    feats = [_t(f).bfloat16() for f in _feats(rng)]
    rois = _t(_rois(rng, 2, 12))
    got = t_roi.batched_multilevel_roi_align(feats, rois, STRIDES, 7)
    ref = t_roi.batched_multilevel_roi_align([f.float() for f in feats],
                                             rois, STRIDES, 7)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref.bfloat16(), rtol=0, atol=0)


def test_cuda_wrapper_sends_cpu_tensors_to_the_plain_version():
    rng = np.random.RandomState(8)
    feats = [_t(f) for f in _feats(rng)]
    rois = _t(_rois(rng, 2, 8))
    wrapper = RoiAlignForward(t_roi.batched_multilevel_roi_align)
    got = wrapper(feats, rois, STRIDES, 7)
    torch.testing.assert_close(
        got, t_roi.batched_multilevel_roi_align(feats, rois, STRIDES, 7),
        rtol=0, atol=0)
    assert wrapper.launches == 0
    before = [k.launches for k in t_roi.KERNELS]
    torch.testing.assert_close(
        t_roi.dispatch_roi_align(feats, rois, STRIDES, 14),
        t_roi.batched_multilevel_roi_align(feats, rois, STRIDES, 14),
        rtol=0, atol=0)
    assert [k.launches for k in t_roi.KERNELS] == before


# ---------------------------------------------------------------------
# ROIAlign backward (plain version) and the autograd function
# ---------------------------------------------------------------------


def _vjp_case(seed, b=2, n=24, c=16, out_size=7):
    rng = np.random.RandomState(seed)
    feats = _feats(rng, b=b, c=c)
    rois = _rois(rng, b, n)
    g = rng.randn(b, n, out_size, out_size, c).astype(np.float32)
    return feats, rois, g


def _grad_close(got, want, rel):
    """Each level within ``rel`` of its largest magnitude."""
    for a, w in zip(got, want):
        a = np.asarray(a, np.float64)
        w = np.asarray(w, np.float64)
        assert a.shape == w.shape
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-12))


@pytest.mark.parametrize("out_size", [7, 14])
def test_roi_align_backward_plain_matches_jax_vjp(out_size):
    """float32, 1e-5 of each level's largest gradient (sums in another
    order)."""
    feats, rois, g = _vjp_case(out_size, out_size=out_size)
    _, vjp = jax.vjp(lambda fs: j_roi.batched_multilevel_roi_align(
        fs, jnp.asarray(rois), STRIDES, out_size),
        tuple(jnp.asarray(f) for f in feats))
    want = vjp(jnp.asarray(g))[0]
    got = t_roi.roi_align_backward_plain(
        [_t(f) for f in feats], _t(rois), _t(g), STRIDES, out_size)
    assert all(a.dtype == torch.float32 for a in got)
    assert any(float(a.abs().max()) > 0 for a in got[1:])
    _grad_close([a.numpy() for a in got], want, 1e-5)


def test_roi_align_backward_plain_matches_pallas_backward_interpret():
    """Against the TPU backward kernel itself (interpret mode), on ROIs
    whose tile-fit level equals the FPN heuristic level."""
    feats, rois, g = _vjp_case(21)
    rois[1, 1] = [20.0, 24.0, 100.0, 90.0]     # replace the >P5 ROI
    flat = jnp.asarray(rois.reshape(-1, 4))
    same = np.asarray(
        j_roi.assign_fpn_levels_tile_fit(flat, STRIDES, 4, TILE,
                                         align=sublane_align(jnp.float32))
        == j_roi.assign_fpn_levels(flat) - 2)
    assert same.all()
    want = j_pallas._pallas_backward(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois),
        jnp.asarray(g), STRIDES, 7, 2, 2, True)
    got = t_roi.roi_align_backward_plain(
        [_t(f) for f in feats], _t(rois), _t(g), STRIDES, 7)
    _grad_close([a.numpy() for a in got], want, 1e-4)


def test_roi_align_backward_plain_bf16_accumulates_in_f32():
    feats, rois, g = _vjp_case(22)
    f16 = [_t(f).bfloat16() for f in feats]
    g16 = _t(g).bfloat16()
    got = t_roi.roi_align_backward_plain(f16, _t(rois), g16, STRIDES, 7)
    ref = t_roi.roi_align_backward_plain([f.float() for f in f16], _t(rois),
                                         g16.float(), STRIDES, 7)
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, r.bfloat16(), rtol=0, atol=0)


def test_roi_align_function_on_cpu_matches_autograd_of_plain_version():
    """``RoiAlignFunction`` with the wrappers on CPU tensors (each takes
    its plain version): the forward and the feature gradients of the
    plain version under autograd, no ROI gradient, no launch."""
    feats, rois, g = _vjp_case(23)
    kernels = RoiAlignKernels(t_roi.batched_multilevel_roi_align,
                              t_roi.accumulate_roi_align_backward)
    fa = [_t(f).requires_grad_() for f in feats]
    fb = [_t(f).requires_grad_() for f in feats]
    r = _t(rois).requires_grad_()
    want = t_roi.batched_multilevel_roi_align(fa, _t(rois), STRIDES, 7)
    got = RoiAlignFunction.apply(kernels, r, STRIDES, 7, 2, 2, *fb)
    assert got.grad_fn is not None
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    want.backward(_t(g))
    got.backward(_t(g))
    _grad_close([b.grad.numpy() for b in fb],
                [a.grad.numpy() if a.grad is not None
                 else np.zeros(a.shape) for a in fa], 1e-5)
    assert r.grad is None
    assert [k.launches for k in kernels] == [0, 0, 0]


def test_backward_and_copy_wrappers_send_cpu_tensors_to_plain_versions():
    feats, rois, g = _vjp_case(24)
    accs = [torch.ones(f.shape) for f in feats]
    bwd = RoiAlignBackward(t_roi.accumulate_roi_align_backward)
    out = bwd(accs, _t(rois), _t(g), STRIDES, 7)
    plain = t_roi.roi_align_backward_plain(
        [_t(f) for f in feats], _t(rois), _t(g), STRIDES, 7)
    for o, a, p in zip(out, accs, plain):
        assert o is a                       # accumulated in place
        _grad_close([(o - 1.0).numpy()], [p.numpy()], 1e-5)
    copy = CopyToGlobal()
    src = _t(feats[0])
    dst = copy(src)
    assert dst.data_ptr() != src.data_ptr() and torch.equal(dst, src)
    assert bwd.launches == copy.launches == 0


@pytest.mark.parametrize("out_size", [7, 14])
def test_footprint_reckoner_covers_exactly_the_changed_pixels(out_size):
    """``chip_smoke.roi_footprint`` (the count of the footprint design's
    reductions) for single ROIs of each kind ``make_rois`` draws
    (log-uniform, border-crossing, sub-pixel, larger than the canvas):
    rows × columns are exactly the pixels that the plain backward changes
    for a random nonzero ``g``, on the ROI's level and nowhere else, and
    neither list is longer than 2·out·s."""
    rng = np.random.RandomState(30 + out_size)
    sizes = [(chip_smoke.CANVAS // s,) * 2 for s in STRIDES]
    for kind in range(4):
        for _ in range(3):
            roi = chip_smoke.make_rois(rng, 1, kinds=[kind])
            lv = int(chip_smoke.fpn_levels(roi, len(STRIDES))[0])
            rows, cols = chip_smoke.roi_footprint(roi[0], out_size, 2,
                                                  sizes[lv], STRIDES[lv])
            assert 0 < len(rows) <= 2 * out_size * 2
            assert 0 < len(cols) <= 2 * out_size * 2
            accs = [torch.zeros((1, h, w, 1)) for h, w in sizes]
            g = rng.randn(1, 1, out_size, out_size, 1).astype(np.float32)
            t_roi.accumulate_roi_align_backward(accs, _t(roi[None]), _t(g),
                                                STRIDES, out_size)
            for i, acc in enumerate(accs):
                want = np.zeros(sizes[i], bool)
                if i == lv:
                    want[np.ix_(rows, cols)] = True
                np.testing.assert_array_equal(acc[0, :, :, 0].numpy() != 0,
                                              want, err_msg=f"kind {kind}")


def test_sampler_mask_keeps_every_pick_once():
    """``sample_mask_by_priority`` over a batch: per row at most ``k``
    candidates, the ones with the highest priorities."""
    rng = np.random.RandomState(25)
    cand = _t(rng.rand(3, 50) < 0.4)
    pri = _t(rng.rand(3, 50).astype(np.float32))
    mask = t_sampling.sample_mask_by_priority(cand, pri, 6,
                                              limit=torch.tensor([6, 2, 0]))
    assert mask.sum(1).tolist() == [6, 2, 0]
    assert not (mask & ~cand).any()
    top = torch.where(cand, pri, torch.full_like(pri, -1.0)).sort(
        1, descending=True).values
    assert (pri[0][mask[0]].min() >= top[0, 5])
