"""The port's COCO eval across ranks on the CPU: two gloo ranks, each
started by the JobSet env (``tests/torch_dist_ranks.py``, which imports
no JAX), at SMOKE widths on 128² canvases.  Each multi-process test has
its own time limit (the launch's), so a per-batch collective that would
hang unequal shards fails the test instead of stalling the suite.

- ``run_evaluation`` sharded over 2 ranks gives the one-process AP, with
  the ground-truth stub (square and bucketed; non-zero AP) and with the
  model (its detections equal the one-process run's); rank 1 returns
  ``{}``; a predict that raises on rank 1 only still reaches the gather,
  and both ranks raise.
- ``Trainer._run_eval`` under FSDP2 with ``PREPROC.BUCKETS`` over shards
  of unequal batch counts finishes, predicts with an unsharded local
  replica (the trainer's module stays sharded), and gives the
  one-process AP and detections.
- ``python -m eksml_tpu_torch.train`` without ``--synthetic`` as 2 ranks
  under ``fsdp`` on ``mini_coco`` with ``TRAIN.EVAL_PERIOD=1`` writes
  ``val/bbox/AP`` and ``val/segm/AP`` and the step-2 checkpoint.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import conftest  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch.convert import init_params  # noqa: E402
from eksml_tpu_torch.evalcoco import runner  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from test_torch_distributed import launch  # noqa: E402
from torch_dist_ranks import (EVAL_BUCKETS, EVAL_OVERRIDES,  # noqa: E402
                              gt_stub, recording_predict, shape_records)

SMOKE = list(t_config.SMOKE_OVERRIDES) + ["TELEMETRY.PORT=0"]
OVERRIDES = SMOKE + list(EVAL_OVERRIDES) + [
    "TRAIN.BATCH_SIZE_PER_CHIP=1", "TRAIN.NUM_CHIPS=2"]


def _cfg(*extra):
    cfg = t_config.config.clone()
    cfg.freeze(False)
    cfg.update_args(SMOKE + list(EVAL_OVERRIDES) + list(extra))
    cfg.freeze()
    return cfg


def _same_ap(got, want):
    assert set(got) == set(want) and {"bbox/AP", "segm/AP"} <= set(got)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


def _same_outputs(got, want):
    """Per-image predict rows (keyed by content size) to the serve
    parity tolerances; the ranks' replicas compute on the CPU as the
    one-process model does, so they agree far closer."""
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        for k in ("classes", "valid"):
            assert torch.equal(g[k], w[k]), (key, k)
        for k, tol in (("boxes", 1e-3), ("scores", 1e-5), ("masks", 1e-4)):
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=tol)


@pytest.fixture(scope="module")
def params():
    return init_params(_cfg(), torch.Generator().manual_seed(4))


def _one_process(params, records, *extra, batch_size=2):
    """The one-process AP and detections of the model."""
    cfg = _cfg(*extra)
    model = MaskRCNN.from_config(cfg)
    model.load_state_dict(params)
    outputs = {}
    res = runner.run_evaluation(model, cfg, records, batch_size=batch_size,
                                device="cpu",
                                predict_fn=recording_predict(outputs))
    return res, outputs


def test_sharded_eval_equals_one_process(params, tmp_path):
    records = shape_records()
    torch.save({"records": records, "params": params,
                "overrides": OVERRIDES}, os.path.join(tmp_path, "inputs.pt"))
    ranks = launch("eval", tmp_path, local_form=False, timeout=300)
    assert [r["world"] for r in ranks] == [2, 2]
    for name, extra in (("stub", ()), ("stub_bucketed", (EVAL_BUCKETS,))):
        want = runner.run_evaluation(None, _cfg(*extra), records,
                                     batch_size=2,
                                     predict_fn=gt_stub(records),
                                     device="cpu")
        _same_ap(ranks[0][name], want)
        assert want["bbox/AP"] > 0.2 and want["segm/AP"] > 0.2
        assert ranks[1][name] == {}
    want, outputs = _one_process(params, records)
    _same_ap(ranks[0]["model"], want)
    assert ranks[1]["model"] == {}
    merged = {**ranks[0]["model_outputs"], **ranks[1]["model_outputs"]}
    _same_outputs(merged, outputs)
    # the failing rank raised its own error, the other one names it
    assert ranks[1]["error"] == "ValueError: predict failed on purpose"
    assert ranks[0]["error"] == ("RuntimeError: eval failed on rank(s) [1]; "
                                 "see their logs")


def test_fsdp_bucketed_eval_over_unequal_shards(params, tmp_path):
    records = shape_records(n=5)
    torch.save({"records": records, "params": params,
                "overrides": OVERRIDES}, os.path.join(tmp_path, "inputs.pt"))
    ranks = launch("fsdp_eval", tmp_path, local_form=True, timeout=300)
    for r, out in enumerate(ranks):
        assert out["seen"] == [{"sharded": False,
                                "is_trainer_model": False}], r
        assert out["still_sharded"], r
    # unequal shards: 3 and 2 predict batches of one image
    assert [len(out["outputs"]) for out in ranks] == [3, 2]
    want, outputs = _one_process(params, records, EVAL_BUCKETS,
                                 batch_size=1)
    _same_ap(ranks[0]["results"], want)
    assert ranks[1]["results"] == {}
    _same_outputs({**ranks[0]["outputs"], **ranks[1]["outputs"]}, outputs)


def test_entry_point_two_ranks_train_on_coco_with_eval(tmp_path):
    base = conftest.mini_coco.__wrapped__(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    run = tmp_path / "run"
    argv = [sys.executable, "-m", "eksml_tpu_torch.train", "--device", "cpu",
            "--logdir", str(run), "--total-steps", "2", "--config", *SMOKE,
            *EVAL_OVERRIDES, f"DATA.BASEDIR={base}", "DATA.NUM_CLASSES=3",
            "TRAIN.NUM_CHIPS=2", "TRAIN.BATCH_SIZE_PER_CHIP=1",
            "TRAIN.STEPS_PER_EPOCH=1", "TRAIN.EVAL_PERIOD=1",
            "TRAIN.CHECKPOINT_PERIOD=2", "TRAIN.LOG_PERIOD=1",
            "TRAIN.SHARDING.STRATEGY=fsdp"]
    procs, logs = [], []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("PROCESS_ID", "SLICE_INDEX",
                            "JOB_COMPLETION_INDEX")}
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="1", LOCAL_WORLD_SIZE="2",
                   LOCAL_RANK=str(r), OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        logs.append(tmp_path / f"rank{r}.log")
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(argv, env=env, cwd=REPO, stdout=f,
                                          stderr=subprocess.STDOUT))
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [path.read_text() for path in logs]
    assert codes == [0, 0], [t[-3000:] for t in texts]
    with open(run / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    evals = [r for r in rows if "val/bbox/AP" in r]
    assert [r["step"] for r in evals] == [1, 2]
    assert all("val/segm/AP" in r for r in evals)
    assert [r["step"] for r in rows if "total_loss" in r] == [1, 2]
    ckpts = [n for n in os.listdir(run / "checkpoints") if n.isdigit()]
    assert ckpts == ["2"]
    # no eval failed on either rank ("eval at step N failed")
    assert all("eval at step" not in t for t in texts)
    assert all("training complete at 2 steps" in t for t in texts)
