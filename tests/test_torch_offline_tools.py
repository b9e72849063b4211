"""The port's offline tools (``eksml_tpu_torch/tools/``: make_shapes_coco,
convergence_run, op_microbench, bench_loader, bench_sweep) on the CPU at
SMOKE widths, held to the reference tools (``tools/*.py``):

- the shapes generator's annotation JSON equals the reference's byte for
  byte; its images equal the reference's bitwise where no wedge is drawn,
  and every shape it draws equals a point-in-polygon oracle (the
  reference fills a triangle inside out, ROADMAP Queue 3);
- the vendored earlier NMS and anchor-matching formulations and the
  microbench's inputs equal the reference's on the same seed (keep masks,
  labels and matched indices exactly; the inputs exactly);
- ``check_convergence`` gives the reference's verdicts;
- each tool's CPU smoke prints the reference's JSON keys;
- the convergence runs banked from the card (``artifacts/h100/``) pass
  the reference's gate."""

import glob
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from test_torch_masks import oracle_fill  # noqa: E402

from eksml_tpu_torch.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu_torch.tools import bench_loader  # noqa: E402
from eksml_tpu_torch.tools import bench_sweep  # noqa: E402
from eksml_tpu_torch.tools import convergence_run  # noqa: E402
from eksml_tpu_torch.tools import make_shapes_coco  # noqa: E402
from eksml_tpu_torch.tools import op_microbench  # noqa: E402
from tools import convergence_run as j_convergence  # noqa: E402
from tools import make_shapes_coco as j_shapes  # noqa: E402

SIZE = 64
N_IMG = 8
# (split, seed, id_base) as the reference's main and convergence run
SPLITS = (("train2017", 0, 1000), ("val2017", 1, 100000))

# the summary keys of the reference's convergence run
# (tools/convergence_run.py:163-183)
CONVERGENCE_KEYS = ("steps", "image_size", "batch_size", "overrides",
                    "train_seconds", "early_loss", "late_loss",
                    "loss_drop_pct", "bbox_AP", "bbox_AP50", "segm_AP",
                    "segm_AP50", "device", "curve")
# the reference's op microbench object (tools/op_microbench.py:236-246)
MICRO_KEYS = ("device_kind", "params", "results", "unit",
              "new_minus_old_ms")
MICRO_PARAMS = ("image_size", "batch", "pre_nms", "levels",
                "anchors_total", "iters", "nms_tile")
LOADER_KEYS = ("metric", "value", "unit", "images_per_sec_per_core",
               "cpu_cores", "image_size", "batch_size", "workers",
               "with_masks")
# the architecture-shrinking overrides (tests/test_convergence_artifact.py)
SHRINK_KEYS = ("BACKBONE.RESNET_NUM_BLOCKS", "FPN.NUM_CHANNEL",
               "MRCNN.HEAD_DIM", "FPN.FRCNN_FC_HEAD_DIM")


def _reference_split(tmp_path, monkeypatch, split, seed, id_base):
    """The reference's ``make_split`` into ``tmp_path/ref``: (the
    annotation file's bytes, the image arrays it encoded, by file name),
    the arrays captured before the JPEG encode."""
    from PIL import Image

    seen = []
    real = Image.fromarray

    def capture(arr, *a, **k):
        seen.append(np.array(arr, copy=True))
        return real(arr, *a, **k)

    monkeypatch.setattr(Image, "fromarray", capture)
    dst = str(tmp_path / "ref")
    j_shapes.make_split(dst, split, N_IMG, SIZE, seed, id_base)
    monkeypatch.setattr(Image, "fromarray", real)
    with open(os.path.join(dst, "annotations",
                           f"instances_{split}.json"), "rb") as f:
        text = f.read()
    names = [im["file_name"] for im in json.loads(text)["images"]]
    return text, dict(zip(names, seen))


@pytest.mark.parametrize("split,seed,id_base", SPLITS)
def test_shapes_annotations_equal_the_reference(tmp_path, monkeypatch,
                                                split, seed, id_base):
    want, _ = _reference_split(tmp_path, monkeypatch, split, seed, id_base)
    dst = str(tmp_path / "port")
    records = make_shapes_coco.make_split(dst, split, N_IMG, SIZE, seed,
                                          id_base, skip_empty=False)
    with open(os.path.join(dst, "annotations",
                           f"instances_{split}.json"), "rb") as f:
        assert f.read() == want
    # JPEGs where PIL imports, as the reference writes them
    assert sorted(os.listdir(os.path.join(dst, split))) == sorted(
        os.listdir(str(tmp_path / "ref" / split)))
    assert [r["image_id"] for r in records] == list(
        range(id_base, id_base + N_IMG))
    for rec in records:
        assert rec["_image"].shape == (SIZE, SIZE, 3)
        assert rec["_image"].dtype == np.uint8


@pytest.mark.parametrize("split,seed,id_base", SPLITS)
def test_shapes_images_without_a_wedge_equal_the_reference(
        tmp_path, monkeypatch, split, seed, id_base):
    text, ref = _reference_split(tmp_path, monkeypatch, split, seed,
                                 id_base)
    data, pixels = make_shapes_coco.shapes_split(split, N_IMG, SIZE, seed,
                                                 id_base)
    wedged = {a["image_id"] for a in data["annotations"]
              if a["category_id"] == 3}
    plain = [im for im in data["images"] if im["id"] not in wedged]
    assert plain and wedged       # both kinds occur at these seeds
    for im in data["images"]:
        same = np.array_equal(pixels[im["file_name"]],
                              ref[im["file_name"]])
        # a wedge paints the reference's canvas outside its triangle
        assert same == (im["id"] not in wedged), im


@pytest.mark.parametrize("split,seed,id_base", SPLITS)
def test_shapes_are_drawn_as_the_oracle_fills_them(monkeypatch, split, seed,
                                                   id_base):
    """Every polygon the generator draws (wedges included) paints exactly
    the oracle's pixels; the reference's fill of each wedge paints the
    rest of the canvas (the two fills partition it)."""
    from eksml_tpu.data.masks import polygon_fill as j_fill

    drawn = []
    real = make_shapes_coco.polygon_fill

    def recording(poly, h, w):
        m = real(poly, h, w)
        drawn.append((np.asarray(poly).copy(), m))
        return m

    monkeypatch.setattr(make_shapes_coco, "polygon_fill", recording)
    _, pixels = make_shapes_coco.shapes_split(split, N_IMG, SIZE, seed,
                                              id_base)
    wedges = [(p, m) for p, m in drawn if len(p) == 3]
    assert wedges and len(wedges) < len(drawn)
    for poly, m in drawn:
        want = oracle_fill([tuple(v) for v in poly], SIZE, SIZE)
        np.testing.assert_array_equal(m, want)
    for poly, m in wedges:
        ref = j_fill(poly, SIZE, SIZE)
        assert int(ref.sum()) + int(m.sum()) == SIZE * SIZE
    # and the images come out as the oracle's fills make them
    monkeypatch.setattr(make_shapes_coco, "polygon_fill",
                        lambda p, h, w: oracle_fill(
                            [tuple(v) for v in p], h, w))
    _, oracle_pixels = make_shapes_coco.shapes_split(split, N_IMG, SIZE,
                                                     seed, id_base)
    for name, img in pixels.items():
        np.testing.assert_array_equal(img, oracle_pixels[name])


def test_the_reference_inverts_a_triangle_the_port_fills():
    """The figure in ROADMAP Queue 3: a triangle on a 24x24 canvas."""
    from eksml_tpu.data.masks import polygon_fill as j_fill

    tri = np.asarray([(4.0, 4.0), (20.0, 4.0), (4.0, 22.0)])
    port = make_shapes_coco.polygon_fill(tri, 24, 24)
    ref = j_fill(tri, 24, 24)
    np.testing.assert_array_equal(port, oracle_fill(
        [tuple(v) for v in tri], 24, 24))
    assert (int(port.sum()), int(ref.sum())) == (144, 432)
    np.testing.assert_array_equal(ref, 1 - port)


# ---------------------------------------------------------------------
# op_microbench: the inputs and the vendored formulations
# ---------------------------------------------------------------------

MICRO = dict(image_size=256, batch=2, pre_nms=300)


@pytest.fixture(scope="module")
def reference_ops():
    """The reference microbench's ``(fn, args)`` per op at ``MICRO``
    (its ``timeit`` captured instead of run)."""
    from tools import op_microbench as j_micro

    seen = {}

    def capture(fn, args, iters, warmup=3):
        seen[len(seen)] = (fn, args)
        return 0.0

    real = j_micro.timeit
    j_micro.timeit = capture
    try:
        j_micro.main(["--iters", "1", "--image-size",
                      str(MICRO["image_size"]), "--batch",
                      str(MICRO["batch"]), "--pre-nms",
                      str(MICRO["pre_nms"])])
    finally:
        j_micro.timeit = real
    names = op_microbench.OPS.split(",")
    return {names[i]: v for i, v in seen.items()}


@pytest.fixture(scope="module")
def port_ops():
    inputs = op_microbench.make_inputs(MICRO["image_size"], MICRO["batch"],
                                       MICRO["pre_nms"])
    return op_microbench.build_ops(inputs, torch.device("cpu"),
                                   MICRO["batch"], 5, MICRO["pre_nms"],
                                   0.7)


def _np(x):
    return np.asarray(x)


def test_microbench_inputs_equal_the_reference(reference_ops, port_ops):
    """The same ``RandomState(0)`` draws in the same order: every op's
    arguments equal the reference's exactly (the stacked NMS batch as
    ``[B, L, K]`` where the reference has ``[B * L, K]``)."""
    assert list(reference_ops) == list(port_ops)
    for name in port_ops:
        ref = reference_ops[name][1]
        got = port_ops[name][1]
        flat_ref = [a for x in ref for a in (x if isinstance(x, list)
                                             else [x])]
        flat_got = [a for x in got for a in (x if isinstance(x, list)
                                             else [x])]
        assert len(flat_ref) == len(flat_got), name
        for r, g in zip(flat_ref, flat_got):
            r = _np(r)
            g = g.numpy()
            assert r.dtype == g.dtype, (name, r.dtype, g.dtype)
            np.testing.assert_array_equal(g.reshape(r.shape), r)


@pytest.mark.parametrize("name", ["nms_old", "nms_old_stacked",
                                  "matching_ag", "nms_new",
                                  "nms_new_stacked", "matching_ga"])
def test_microbench_ops_equal_the_reference(reference_ops, port_ops, name):
    """The vendored ``nms_mask_global_fixedpoint`` and
    ``match_anchors_ag`` (and the production ops beside them) give the
    reference's keep masks, labels and matched GT indices exactly."""
    rfn, rargs = reference_ops[name]
    fn, args = port_ops[name]
    want = rfn(*rargs)
    got = fn(*args)
    if name.startswith("nms"):
        want = _np(want)
        np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
        assert 0 < want.sum() < want.size
    else:
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), _np(w))
        assert (_np(want[0]) == 1).any()


def test_check_convergence_gives_the_reference_verdicts():
    """The four cases of ``tests/test_convergence_artifact.py``."""
    for check in (convergence_run.check_convergence,
                  j_convergence.check_convergence):
        check(early=1.0, late=0.6, ap50=0.2)
        check(early=0.95, late=1.09, ap50=0.53)
        with pytest.raises(AssertionError, match="no material"):
            check(early=1.0, late=0.95, ap50=0.3)
        with pytest.raises(AssertionError, match="AP50 too low"):
            check(early=1.0, late=0.5, ap50=0.01)


# ---------------------------------------------------------------------
# CPU smokes of the four tools
# ---------------------------------------------------------------------

def test_convergence_run_on_the_cpu(tmp_path, capsys):
    from eksml_tpu_torch.config import config

    out = str(tmp_path / "conv.json")
    saved = config.to_dict()
    try:
        summary = convergence_run.main(
            ["--device", "cpu", "--steps", "2", "--size", "128",
             "--num-train", "4", "--num-val", "2", "--batch-size", "1",
             "--no-check", "--out", out, "--config", *SMOKE_OVERRIDES,
             "DATA.NUM_WORKERS=2"], workdir=str(tmp_path))
    finally:
        config.freeze(False)
        config.from_dict(saved)
        config.freeze()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        assert json.loads(f.read()) == line == json.loads(json.dumps(summary))
    for key in CONVERGENCE_KEYS:
        assert key in line, key
    assert line["steps"] == 2 and line["image_size"] == 128
    assert [c["step"] for c in line["curve"]] == [1, 2]
    assert all(math.isfinite(c["total_loss"]) for c in line["curve"])
    assert line["device"] == "cpu" and line["card"] is None
    assert line["torch"] == torch.__version__
    assert line["eval_images"] == 2
    # the plain versions count no launch on the CPU
    assert line["launches"] == {"roi_align_fwd": 0, "roi_align_bwd": 0,
                                "copy_to_global": 0}
    for key in ("bbox_AP", "bbox_AP50", "segm_AP", "segm_AP50"):
        assert line[key] >= 0.0, key


def test_op_microbench_banks_the_cpu_name_only(tmp_path, capsys):
    out = op_microbench.main(
        ["--device", "cpu", "--iters", "1", "--image-size", "128",
         "--batch", "1", "--pre-nms", "64", "--bank", "--artifacts-dir",
         str(tmp_path), "--out", str(tmp_path / "line.json")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in MICRO_KEYS:
        assert key in line, key
    assert tuple(line["params"]) == MICRO_PARAMS
    assert list(line["results"]) == op_microbench.OPS.split(",")
    assert all(isinstance(v, float) for v in line["results"].values())
    assert sorted(os.listdir(tmp_path)) == ["line.json",
                                            "op_microbench_cpu.json"]
    with open(tmp_path / "op_microbench_cpu.json") as f:
        banked = json.load(f)
    assert banked == out and "banked_at" in banked
    assert op_microbench.bank_name(
        {"device_kind": "NVIDIA H100 80GB HBM3"}) == "op_microbench_h100.json"
    assert op_microbench.bank_name({"device_kind": None}) == \
        "op_microbench_cpu.json"


def test_bench_loader_on_the_cpu(capsys):
    from eksml_tpu_torch.config import config

    before = config.to_dict()
    rec = bench_loader.main(["--image-size", "448", "--batch-size", "2",
                             "--batches", "2", "--workers", "2",
                             "--source-hw", "96", "128"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tuple(line) == LOADER_KEYS and line == rec
    assert line["value"] > 0 and line["image_size"] == 448
    assert config.to_dict() == before      # a clone was configured


def test_bench_sweep_one_quick_row(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench_sweep, "CONFIGS", [bench_sweep.CONFIGS[0]])
    out = str(tmp_path / "sweep.json")
    payload = bench_sweep.main(["--quick", "--steps", "1", "--out", out])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        assert json.load(f) == line == payload
    (row,) = line["sweep"]
    assert row["config"] == "bf16" and "error" not in row, row
    assert row["operating_point"] == "1344_b4"
    assert row["precision"] == "bfloat16" and row["batch_size"] == 1
    assert row["image_size"] == [128, 128] and row["value"] > 0
    assert row["wall_s"] > 0


def test_bench_sweep_rows_and_their_errors(tmp_path, monkeypatch):
    """The timeout and no-JSON branches, the ladder faked; every row's
    command and its timeout, on the card too."""
    names = [c[0] for c in bench_sweep.CONFIGS]
    assert names == ["bf16", "bf16_remat", "f32", "bf16_bucket",
                     "bf16_f32ingest"]
    calls = []

    def fake(cmd, timeout, cwd):
        calls.append((cmd, timeout))
        if "float32" in cmd:
            raise subprocess.TimeoutExpired(cmd, timeout)
        if "--remat" in cmd:
            return "not json\n", "a\nb\nc\nd\n"
        return json.dumps({"value": 1.5}) + "\n", ""

    monkeypatch.setattr(bench_sweep, "run_row", fake)
    payload = bench_sweep.main(["--out", str(tmp_path / "s.json")])
    rows = {r["config"]: r for r in payload["sweep"]}
    assert rows["f32"]["error"] == "timeout after 1200s"
    assert rows["bf16_remat"]["error"] == "no JSON line"
    assert rows["bf16_remat"]["stderr_tail"] == ["b", "c", "d"]
    assert rows["bf16"]["value"] == 1.5
    for cmd, timeout in calls:
        assert timeout == bench_sweep.DEFAULT_TIMEOUT
        assert cmd[1:3] == ["-m", "eksml_tpu_torch.tools.bench"]
        assert cmd[cmd.index("--device") + 1] == "cuda"
    bucket = calls[names.index("bf16_bucket")][0]
    assert bucket[bucket.index("--rungs") + 1] == "832x1344_b4"
    ingest = calls[names.index("bf16_f32ingest")][0]
    assert ingest[ingest.index("--config") + 1:] == [
        "PREPROC.DEVICE_NORMALIZE=False"]


def test_bench_sweep_kills_a_timed_out_rows_session(tmp_path):
    """A row past its timeout is killed with everything it started."""
    pid_file = tmp_path / "grandchild.pid"
    cmd = [sys.executable, "-c",
           "import subprocess, sys, time\n"
           "p = subprocess.Popen([sys.executable, '-c', "
           "'import time; time.sleep(60)'])\n"
           f"open({str(pid_file)!r}, 'w').write(str(p.pid))\n"
           "time.sleep(60)\n"]
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        bench_sweep.run_row(cmd, 3.0, str(tmp_path))
    assert time.monotonic() - t0 < 30
    pid = int(pid_file.read_text())
    for _ in range(50):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        pytest.fail(f"the row's grandchild {pid} outlived the timeout")


# ---------------------------------------------------------------------
# the convergence runs banked from the card
# ---------------------------------------------------------------------

BANKED = sorted(glob.glob(os.path.join(REPO, "artifacts", "h100",
                                       "convergence_*.json")))


def test_both_convergence_runs_are_banked():
    assert [os.path.basename(p) for p in BANKED] == [
        "convergence_bf16.json", "convergence_f32.json"]
    assert not glob.glob(os.path.join(REPO, "artifacts", "h100",
                                      "convergence_r*.json"))


@pytest.mark.parametrize("path", BANKED, ids=os.path.basename)
def test_banked_convergence_run_passes_the_reference_gate(path):
    with open(path) as f:
        art = json.load(f)
    j_convergence.check_convergence(art["early_loss"], art["late_loss"],
                                    art["bbox_AP50"])
    assert art["segm_AP"] > 0.0
    assert (art["steps"], art["image_size"], art["batch_size"]) == (
        600, 512, 4)
    steps = [c["step"] for c in art["curve"]]
    assert steps == sorted(steps) and steps[-1] == art["steps"]
    assert all(math.isfinite(c["total_loss"]) and c["total_loss"] > 0
               for c in art["curve"])
    assert not any(o.startswith(k) for o in art["overrides"]
                   for k in SHRINK_KEYS), art["overrides"]
    assert "H100" in art["device"] and "H100" in art["card"]
    assert art["card"].strip().endswith("W")      # the power limit
    bf16 = "TRAIN.PRECISION=bfloat16" in art["overrides"]
    assert bf16 == path.endswith("_bf16.json")
    # the kernels ran: 3 / 2 / 8 per step, 2 per eval batch of 4
    n, batches = art["steps"], -(-art["eval_images"] // 4)
    assert art["launches"] == {"roi_align_fwd": 3 * n + 2 * batches,
                               "roi_align_bwd": 2 * n,
                               "copy_to_global": 8 * n}


def test_chip_smoke_tools_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_tools`` rehearsed on the CPU at small microbench
    shapes: the plain versions are wrapped to count launches, so the
    phase's 3 / 2 / 8 per step and 2 per eval batch hold here too, and
    every microbench input lies on the phase's device."""
    import chip_smoke
    from eksml_tpu_torch.config import config
    from eksml_tpu_torch.ops.cuda import roi_align_kernel
    from eksml_tpu_torch.ops.roi_align import KERNELS

    monkeypatch.setattr(chip_smoke, "CANVAS", 256)
    monkeypatch.setattr(chip_smoke, "BATCH", 2)
    monkeypatch.setattr(chip_smoke, "TOOLS_PRE_NMS", 300)
    monkeypatch.setattr(chip_smoke, "TOOLS_ITERS", 1)
    monkeypatch.setattr(chip_smoke, "TOOLS_LOADER_BATCHES", 1)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)

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
    before = config.to_dict()
    out = chip_smoke.phase_tools(KERNELS, str(tmp_path), device="cpu")
    assert config.to_dict() == before
    assert out["launches"] == {"roi_align_fwd": 3 * 4 + 2,
                               "roi_align_bwd": 2 * 4,
                               "copy_to_global": 8 * 4}
    assert out["op_microbench"]["params"]["image_size"] == 256
    assert out["bench_loader"]["image_size"] == 1344
    assert out["convergence_run"]["steps"] == 4
