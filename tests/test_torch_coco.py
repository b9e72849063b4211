"""The port's COCO data path (``eksml_tpu_torch/data``: ``coco``,
``robust``, the file-backed ``DetectionLoader`` and the C++ resize)
against ``eksml_tpu/data`` on the same seeded inputs, on the CPU, and the
entry point ``python -m eksml_tpu_torch.train`` without ``--synthetic``.

- ``CocoDataset`` on ``mini_coco`` and on adversarial annotation files
  (an unknown category, a ``null`` bbox, an RLE segmentation, a crowd):
  records equal field by field, the same ``preflight`` messages, the
  same strict-mode raise.
- ``RobustImageReader`` / ``QuarantineLedger`` / the loader's
  quarantine and starvation paths: the cases of
  ``tests/test_data_robust.py`` against the port, and one the reference
  lacks: a missing decoder (no PIL) raises ``ImportError`` at once and
  quarantines nothing.
- The C++ resize byte-equal to the reference's; file-backed loader
  batches byte-identical to the reference's for the same seed, square
  and with ``PREPROC.BUCKETS``, through decode threads and ``spawn``
  decode processes; the decode worker's import chain imports no torch.
- ``train.main`` on ``mini_coco`` with ``TRAIN.EVAL_PERIOD=1`` writes
  ``val/bbox/AP`` and ``val/segm/AP`` and the step-2 checkpoint.
"""

import errno
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

jax.config.update("jax_platforms", "cpu")

import conftest  # noqa: E402
from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu.data import coco as j_coco  # noqa: E402
from eksml_tpu.data import loader as j_loader  # noqa: E402
from eksml_tpu.data import native as j_native  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.data import coco as t_coco  # noqa: E402
from eksml_tpu_torch.data import loader as t_loader  # noqa: E402
from eksml_tpu_torch.data import native as t_native  # noqa: E402
from eksml_tpu_torch.data.robust import (  # noqa: E402
    PERMANENT, TRANSIENT, DataStarvationError, PermanentDataError,
    QuarantineLedger, QuarantineOverflowError, RobustImageReader,
    classify_error)
from test_data_robust import _disk_records, _tiny_coco, _truncate  # noqa: E402

# an ephemeral exporter port: the xdist workers never share 9090
SMOKE = list(t_config.SMOKE_OVERRIDES) + ["TELEMETRY.PORT=0"]


def _port_cfg(*extra, config_mod=t_config):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(extra))
    return cfg


def _small_cfg(max_quarantine_frac=0.5, config_mod=t_config):
    """``test_data_robust._small_cfg`` on a clone of either package's
    config."""
    cfg = _port_cfg(config_mod=config_mod)
    cfg.PREPROC.MAX_SIZE = 64
    cfg.PREPROC.TRAIN_SHORT_EDGE_SIZE = (32, 32)
    cfg.DATA.MAX_GT_BOXES = 4
    cfg.DATA.NUM_WORKERS = 0
    cfg.DATA.WORKER_PROCESSES = 0
    cfg.RESILIENCE.DATA.IO_BACKOFF_SEC = 0.001
    cfg.RESILIENCE.DATA.MAX_QUARANTINE_FRAC = max_quarantine_frac
    return cfg


def _loader(recs, cfg, module=t_loader, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("seed", 3)
    kw.setdefault("num_workers", 0)
    kw.setdefault("gt_mask_size", 8)
    kw.setdefault("prefetch", 1)
    return module.DetectionLoader(recs, cfg, **kw)


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return conftest.mini_coco.__wrapped__(tmp_path_factory.mktemp("coco"))


# ---------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------


@pytest.mark.parametrize("split,skip_empty", [("train2017", True),
                                              ("val2017", False)])
def test_coco_records_match_jax(coco_dir, split, skip_empty):
    got = t_coco.CocoDataset(coco_dir, split, validate="warn")
    want = j_coco.CocoDataset(coco_dir, split, validate="warn")
    assert got.class_names == want.class_names
    assert got.cat_id_to_class == want.cat_id_to_class
    _same_records(got.records(skip_empty=skip_empty),
                  want.records(skip_empty=skip_empty))
    assert got.preflight() == want.preflight() == []
    np.testing.assert_array_equal(
        t_coco.load_image(got.records()[0]["path"]),
        j_coco.load_image(want.records()[0]["path"]))


def _adversarial(data, base):
    """An unknown category, a ``null`` bbox, an RLE segmentation and a
    crowd, on the ``_tiny_coco`` annotation file."""
    anns = data["annotations"]
    anns.append({"id": 10, "image_id": 1, "category_id": 777,
                 "bbox": [1, 1, 5, 5], "iscrowd": 0, "area": 25})
    anns.append({"id": 11, "image_id": 2, "category_id": 1,
                 "bbox": None, "iscrowd": 0, "area": 25})
    anns.append({"id": 12, "image_id": 2, "category_id": 1,
                 "bbox": [4, 4, 20, 12], "iscrowd": 1, "area": 200,
                 "segmentation": {"size": [30, 40],
                                  "counts": [130, 12, 18, 12, 18, 12,
                                             1000]}})
    anns.append({"id": 13, "image_id": 3, "category_id": 1,
                 "bbox": [20, 10, 15, 15], "iscrowd": 0, "area": 100,
                 "segmentation": {"size": [30, 40], "counts": "PX42b0"}})


@pytest.mark.parametrize("validate", ["off", "warn"])
def test_coco_adversarial_annotations_match_jax(tmp_path, validate):
    base = _tiny_coco(tmp_path, _adversarial)
    got = t_coco.CocoDataset(base, "train2017", validate=validate)
    want = j_coco.CocoDataset(base, "train2017", validate=validate)
    recs = got.records()
    _same_records(recs, want.records())
    assert [len(r["boxes"]) for r in recs] == [1, 2, 2]
    assert recs[1]["iscrowd"].tolist() == [0, 1]
    assert isinstance(recs[1]["segmentation"][1], dict)
    issues = got.preflight()
    assert issues == want.preflight()
    text = "\n".join(issues)
    assert "unknown category_id 777" in text
    assert "annotation 11: malformed bbox None" in text
    with pytest.raises(ValueError) as t_err:
        t_coco.CocoDataset(base, "train2017", validate="strict")
    with pytest.raises(ValueError) as j_err:
        j_coco.CocoDataset(base, "train2017", validate="strict")
    assert str(t_err.value) == str(j_err.value)
    assert "RESILIENCE.DATA.VALIDATE=strict" in str(t_err.value)


@pytest.mark.parametrize("mutate,match", [
    (lambda d, b: d["annotations"][0].update(category_id=777),
     "unknown category_id 777"),
    (lambda d, b: d["annotations"][0].update(bbox=[5, 5, 0, 10]),
     "degenerate bbox"),
    (lambda d, b: d["annotations"][0].update(segmentation=[[1, 2, 3]]),
     "malformed segmentation"),
    (lambda d, b: d["images"].append({"id": 9, "height": 30, "width": 40}),
     "missing/invalid file_name"),
    (lambda d, b: os.remove(b / "train2017" / "t_2.jpg"),
     "file-existence probe"),
])
def test_coco_preflight_and_strict_mode_match_jax(tmp_path, mutate, match):
    base = _tiny_coco(tmp_path, mutate)
    issues = t_coco.CocoDataset(base, "train2017").preflight(sample_files=16)
    assert issues == j_coco.CocoDataset(base, "train2017").preflight(
        sample_files=16)
    assert match in "\n".join(issues)
    with pytest.raises(ValueError, match="dataset issue"):
        t_coco.CocoDataset(base, "train2017", validate="strict")


# ---------------------------------------------------------------------
# robust ingest: the reference's cases against the port
# ---------------------------------------------------------------------


def test_classify_transient_vs_permanent():
    assert classify_error(OSError(errno.EIO, "io")) == TRANSIENT
    assert classify_error(OSError(errno.ESTALE, "stale nfs")) == TRANSIENT
    assert classify_error(TimeoutError()) == TRANSIENT
    assert classify_error(FileNotFoundError(2, "gone")) == PERMANENT
    assert classify_error(ValueError("broken data stream")) == PERMANENT
    assert classify_error(OSError("image file is truncated")) == PERMANENT


def test_reader_retries_transients_and_classifies_permanents():
    img = np.zeros((4, 4, 3), np.uint8)
    calls = []

    def flaky(path):
        calls.append(path)
        if len(calls) < 3:
            raise OSError(errno.EIO, "injected")
        return img

    r = RobustImageReader(io_retries=3, backoff_sec=0.001,
                          sleep=lambda s: None, load=flaky)
    assert r.read("/x.jpg") is img and len(calls) == 3
    assert r.transient_recoveries == 1

    def broken(path):
        calls.append(path)
        raise ValueError("broken data stream")

    calls.clear()
    r = RobustImageReader(io_retries=5, sleep=lambda s: None, load=broken)
    with pytest.raises(PermanentDataError) as ei:
        r.read("/x.jpg")
    assert ei.value.kind == "decode" and len(calls) == 1

    def gone(path):
        raise FileNotFoundError(errno.ENOENT, "gone", path)

    with pytest.raises(PermanentDataError) as ei:
        RobustImageReader(sleep=lambda s: None, load=gone).read("/x.jpg")
    assert ei.value.kind == "missing"

    sleeps = []

    def stale(path):
        raise OSError(errno.ESTALE, "stale forever")

    r = RobustImageReader(io_retries=2, backoff_sec=0.5, backoff_factor=2.0,
                          sleep=sleeps.append, load=stale)
    with pytest.raises(PermanentDataError) as ei:
        r.read("/x.jpg")
    assert ei.value.kind == "io_exhausted" and ei.value.attempts == 3
    assert sleeps == [0.5, 1.0]


def test_missing_decoder_raises_import_error_and_quarantines_nothing(
        tmp_path, monkeypatch):
    """The port's difference from the reference: an ``ImportError`` of
    the decoder (no PIL) propagates at once, from the reader and through
    the loader, instead of quarantining record after record until the
    circuit breaker fires."""
    calls = []

    def no_pil(path):
        calls.append(path)
        raise ImportError("No module named 'PIL'")

    r = RobustImageReader(io_retries=3, sleep=lambda s: None, load=no_pil)
    with pytest.raises(ImportError, match="PIL"):
        r.read("/x.jpg")
    assert calls == ["/x.jpg"]

    monkeypatch.setattr(t_coco, "load_image", no_pil)
    cfg = _small_cfg()
    loader = _loader(_disk_records(tmp_path), cfg,
                     ledger_dir=str(tmp_path / "log"))
    with pytest.raises(ImportError, match="PIL"):
        next(iter(loader.batches(1)))
    assert loader._ledger.count == 0
    assert not os.path.exists(tmp_path / "log" / "quarantine-host0.jsonl")


def test_substitution_keeps_shapes_and_the_schedule(tmp_path):
    """A truncated record quarantines once, its substitute comes from its
    own bucket, and the shared bucket schedule and the draws are those of
    a clean run (the same batches as the reference's dirty run, too)."""
    cfg = _small_cfg()
    cfg.PREPROC.BUCKETS = ((32, 64), (64, 32), (64, 64))
    sizes = [(40, 60), (60, 40)] * 3
    clean = _disk_records(tmp_path / "clean", sizes=sizes)
    dirty = _disk_records(tmp_path / "dirty", sizes=sizes)
    _truncate(dirty[1]["path"])
    la = _loader(clean, cfg.clone(), seed=7)
    lb = _loader(dirty, cfg.clone(), seed=7)
    shapes_a = [b["images"].shape for b in la.batches(10)]
    got = list(lb.batches(10))
    assert [b["images"].shape for b in got] == shapes_a
    assert lb._ledger.count == 1
    np.testing.assert_array_equal(la._sched_rng.get_state()[1],
                                  lb._sched_rng.get_state()[1])
    np.testing.assert_array_equal(la.rng.get_state()[1],
                                  lb.rng.get_state()[1])
    jcfg = _small_cfg(config_mod=j_config)
    jcfg.PREPROC.BUCKETS = cfg.PREPROC.BUCKETS
    want = list(_loader(dirty, jcfg, module=j_loader, seed=7).batches(10))
    _same_batches(got, want)
    sub = _loader(dirty, cfg.clone(), batch_size=1)._substitute_for(dirty[1])
    assert sub["image_id"] == 3


def test_quarantine_census_ledger_and_breaker(tmp_path):
    cfg = _small_cfg()
    recs = _disk_records(tmp_path / "a", n=3)
    _truncate(recs[0]["path"])
    logdir = str(tmp_path / "log")
    loader = _loader(recs, cfg, ledger_dir=logdir)
    list(loader.batches(12))     # 24 draws over 3 records
    assert loader._ledger.count == 1
    with open(os.path.join(logdir, "quarantine-host0.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 and lines[0]["kind"] == "decode"
    assert lines[0]["path"] == recs[0]["path"]
    # the resume keeps the census; one above the breaker refuses
    led = QuarantineLedger(total_records=3, max_frac=0.5,
                           path=os.path.join(logdir, "quarantine-host0.jsonl"))
    assert led.count == 1 and led.is_quarantined(0)
    with pytest.raises(QuarantineOverflowError, match="resumed"):
        QuarantineLedger(total_records=10, max_frac=0.05, path=led.path)

    cfg = _small_cfg(max_quarantine_frac=0.2)
    recs = _disk_records(tmp_path / "b")
    for r in recs[:3]:
        _truncate(r["path"])
    loader = _loader(recs, cfg, ledger_dir=str(tmp_path / "log2"))
    with pytest.raises(QuarantineOverflowError) as ei:
        list(loader.batches(20))
    assert "MAX_QUARANTINE_FRAC" in str(ei.value)
    assert os.path.join(str(tmp_path / "log2"),
                        "quarantine-host0.jsonl") in str(ei.value)
    assert loader._ledger.count == 2


def test_injected_eio_recovers_without_a_ledger_entry(tmp_path):
    cfg = _small_cfg()
    cfg.RESILIENCE.DATA.FAULT_INJECT_EIO_PATH = "img_001"
    cfg.RESILIENCE.DATA.FAULT_INJECT_EIO_COUNT = 1
    loader = _loader(_disk_records(tmp_path), cfg)
    assert len(list(loader.batches(8))) == 8
    assert loader._ledger.count == 0
    assert loader._reader.transient_recoveries == 1
    assert loader.health.scalars()["io_recoveries"] == 1.0


def test_dead_producer_raises_a_diagnostic(tmp_path, monkeypatch):
    cfg = _small_cfg()
    cfg.RESILIENCE.DATA.STARVATION_TIMEOUT_SEC = 0.2
    loader = _loader(_disk_records(tmp_path, n=2), cfg)

    class DeadThread:
        daemon = True

        def __init__(self, *a, **k):
            pass

        def start(self):
            pass

        def is_alive(self):
            return False

        def join(self, timeout=None):
            pass

    monkeypatch.setattr(threading, "Thread", DeadThread)
    with pytest.raises(DataStarvationError) as ei:
        next(iter(loader.batches(1)))
    assert "queue depth" in str(ei.value) and "quarantined" in str(ei.value)


# ---------------------------------------------------------------------
# the resize and the file-backed loader
# ---------------------------------------------------------------------


@pytest.mark.parametrize("shape,out", [((60, 80, 3), (96, 128)),
                                       ((100, 64, 3), (128, 82)),
                                       ((33, 47, 1), (17, 101))])
def test_native_resize_is_byte_equal_to_jax(shape, out):
    img = np.random.RandomState(sum(shape)).rand(*shape).astype(
        np.float32) * 255
    got = t_native.resize_bilinear_native(img, *out)
    want = j_native.resize_bilinear_native(img, *out)
    assert got is not None and want is not None
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert t_loader._bilinear_resize(img, *out).tobytes() == want.tobytes()
    for n_threads in (2, 0):
        assert t_native.resize_bilinear_native(
            img, *out, n_threads=n_threads).tobytes() == want.tobytes()


@pytest.mark.parametrize("buckets,workers,processes", [
    ((), 0, 0), ((), 2, 0),
    (((96, 128), (128, 112), (128, 128)), 2, 0),
    (((96, 128), (128, 112), (128, 128)), 0, 2)])
def test_file_backed_batches_match_jax(coco_dir, buckets, workers,
                                       processes):
    extra = SMOKE + ["PREPROC.TRAIN_SHORT_EDGE_SIZE=(96,128)",
                     f"DATA.WORKER_PROCESSES={processes}"]
    tcfg = _port_cfg(*extra)
    jcfg = _port_cfg(*extra, config_mod=j_config)
    for cfg in (tcfg, jcfg):
        cfg.PREPROC.BUCKETS = buckets
    t_recs = t_coco.CocoDataset(coco_dir, "train2017").records()
    j_recs = j_coco.CocoDataset(coco_dir, "train2017").records()
    got = list(t_loader.DetectionLoader(
        t_recs, tcfg, 2, seed=5, num_workers=workers,
        gt_mask_size=28).batches(6))
    want = list(j_loader.DetectionLoader(
        j_recs, jcfg, 2, seed=5, num_workers=0, gt_mask_size=28).batches(6))
    _same_batches(got, want)
    shapes = {b["images"].shape[1:3] for b in got}
    if buckets:   # mini_coco's train images fit all three
        assert shapes <= set(buckets) and len(shapes) >= 2
    else:
        assert shapes == {(128, 128)}


def test_decode_workers_import_no_torch():
    """``coco.load_image`` (the spawn workers' target) and the robust
    reader import nothing of torch."""
    code = ("import sys; import eksml_tpu_torch.data.coco, "
            "eksml_tpu_torch.data.robust; "
            "print(sorted(m for m in sys.modules if m == 'torch' "
            "or m.startswith('torch.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO,
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------
# the entry point on COCO data
# ---------------------------------------------------------------------


def test_entry_point_trains_on_coco_with_periodic_eval(coco_dir, tmp_path):
    logdir = str(tmp_path / "run")
    assert t_train.main([
        "--device", "cpu", "--logdir", logdir, "--total-steps", "2",
        "--config", *SMOKE, "PREPROC.TEST_SHORT_EDGE_SIZE=128",
        "RPN.TEST_PRE_NMS_TOPK=64", "RPN.TEST_POST_NMS_TOPK=32",
        f"DATA.BASEDIR={coco_dir}", "DATA.NUM_CLASSES=3",
        "TRAIN.BATCH_SIZE_PER_CHIP=1", "TRAIN.STEPS_PER_EPOCH=1",
        "TRAIN.EVAL_PERIOD=1", "TRAIN.CHECKPOINT_PERIOD=2",
        "TRAIN.LOG_PERIOD=1", "DATA.NUM_WORKERS=2"]) == 0
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    evals = [r for r in rows if "val/bbox/AP" in r]
    assert [r["step"] for r in evals] == [1, 2]
    for r in evals:
        assert "val/segm/AP" in r and -1.0 <= r["val/bbox/AP"] <= 1.0
    train_rows = [r for r in rows if "total_loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2]
    assert all(r["data/quarantined"] == 0.0 and r["data/batch_build_ms"] > 0
               for r in train_rows)
    assert [d for d in os.listdir(os.path.join(logdir, "checkpoints"))
            if d.isdigit()] == ["2"]
