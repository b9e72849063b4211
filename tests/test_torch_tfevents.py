"""The port's TensorBoard event files (``eksml_tpu_torch/utils/tfevents.py``)
and cuDNN's algorithm choice set in one place
(``eksml_tpu_torch/utils/compile_cache.py``), on the CPU.

- The writer's records round-trip through the port's reader; CRC32C
  matches its check value; a flipped bit anywhere in a file makes the
  reader raise.
- A ``Trainer.fit`` of 2 SMOKE steps, in a process where ``tensorboard``
  cannot import, writes event files; ``tensorboard``'s own
  ``EventAccumulator`` reads every scalar of ``metrics.jsonl`` back at its
  step, equal as float32 (skipped only where tensorboard is absent).
- No module of the port (nor ``chip_smoke.py``) but ``compile_cache``
  assigns ``torch.backends.cudnn.benchmark`` or ``benchmark_limit``; the
  policy the trainer's ``run_start`` row records for f32 and bf16
  training, and the serving engine's, equal ``compile_cache.POLICY`` and
  the policy table in ``PERF.md``; the autotune phase's rule picks as
  that table says it does.
"""

import ast
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu_torch.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu_torch.utils import compile_cache  # noqa: E402
from eksml_tpu_torch.utils import tfevents  # noqa: E402

#: a SMOKE Trainer on the CPU, logging every step
TRAIN_ITEMS = list(SMOKE_OVERRIDES) + [
    "TRAIN.BATCH_SIZE_PER_CHIP=1", "TRAIN.LOG_PERIOD=1",
    "TELEMETRY.PORT=0", "TELEMETRY.PREDICTED_STEP_TIME=False"]

FIT_WITHOUT_TENSORBOARD = """
import json, sys
# tensorboard (and torch's writer over it) cannot import in this process
for name in ("tensorboard", "torch.utils.tensorboard", "tensorboardX"):
    sys.modules[name] = None
from eksml_tpu_torch import config as t_config
from eksml_tpu_torch import train as t_train
from eksml_tpu_torch.data import loader as t_loader

cfg = t_config.config.clone()
cfg.freeze(False)
cfg.update_args(json.loads(sys.argv[2]))
cfg = t_config.finalize_configs(True, cfg)
ds = t_loader.SyntheticDataset(num_images=2, height=128, width=128,
                               num_classes=cfg.DATA.NUM_CLASSES)
loader = t_loader.DetectionLoader(ds.records(), cfg, batch_size=1,
                                  gt_mask_size=28)
trainer = t_train.Trainer(cfg, sys.argv[1], device="cpu")
trainer.init_state()
trainer.fit(loader.batches(), total_steps=2)
trainer.close()
try:
    import tensorboard  # noqa: F401
    print("TENSORBOARD IMPORTED")
except ImportError:
    print("NO TENSORBOARD")
"""


ACCUMULATE = """
import json, sys
sys.modules["tensorflow"] = None
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator)

acc = EventAccumulator(sys.argv[1], size_guidance={"scalars": 0})
acc.Reload()
print(json.dumps({tag: {e.step: e.value for e in acc.Scalars(tag)}
                  for tag in acc.Tags()["scalars"]}))
"""


def _write(tmp_path):
    w = tfevents.EventFileWriter(str(tmp_path))
    w.add_scalars(1, {"loss": 1.25, "lr": 0.01, "grad": float("nan")})
    w.add_scalars(7, {"loss": -0.5})
    w.close()
    return w.path


def test_events_round_trip(tmp_path):
    assert tfevents.crc32c(b"123456789") == 0xE3069283   # CRC-32C check
    path = _write(tmp_path)
    assert re.fullmatch(r"events\.out\.tfevents\.\d{10}\..+",
                        os.path.basename(path))
    events = tfevents.read_events(path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert [e["step"] for e in events] == [0, 1, 7]
    got = tfevents.read_scalars(str(tmp_path))
    assert got["loss"] == {1: 1.25, 7: -0.5}
    assert got["lr"] == {1: float(np.float32(0.01))}
    assert np.isnan(got["grad"][1])


def test_the_reader_raises_on_a_flipped_bit(tmp_path):
    path = _write(tmp_path)
    with open(path, "rb") as f:
        data = f.read()
    for pos in range(len(data)):
        bad = bytearray(data)
        bad[pos] ^= 0x10
        with open(path, "wb") as f:
            f.write(bytes(bad))
        with pytest.raises(tfevents.CorruptRecordError):
            tfevents.read_events(path)


@pytest.fixture(scope="module")
def fit_logdir(tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("fit"))
    proc = subprocess.run(
        [sys.executable, "-c", FIT_WITHOUT_TENSORBOARD, logdir,
         json.dumps(TRAIN_ITEMS)], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO TENSORBOARD" in proc.stdout
    return logdir


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_writes_event_files_without_tensorboard(fit_logdir):
    pytest.importorskip("tensorboard")
    assert glob.glob(os.path.join(fit_logdir, "events.out.tfevents.*"))
    # tensorboard's reader in a process of its own, on its stub of
    # TensorFlow (importing TensorFlow itself takes seconds)
    proc = subprocess.run(
        [sys.executable, "-c", ACCUMULATE, fit_logdir], capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = {tag: {int(step): v for step, v in by_step.items()}
            for tag, by_step in json.loads(
                proc.stdout.strip().splitlines()[-1]).items()}
    ours = tfevents.read_scalars(fit_logdir)
    rows = [r for r in _rows(fit_logdir) if "step" in r]
    assert [r["step"] for r in rows if "total_loss" in r] == [1, 2]
    n = 0
    for r in rows:
        for k, v in r.items():
            if k in ("step", "time") or not isinstance(v, float):
                continue
            assert seen[k][r["step"]] == np.float32(v), (k, r["step"])
            assert ours[k][r["step"]] == np.float32(v), (k, r["step"])
            n += 1
    assert n >= 2 * 6          # the losses at least, at both steps


def _policy_table():
    """``{(mode, precision): setting}`` of PERF.md's policy table (rows
    ``| <mode> | <precision> | `<setting>` |``)."""
    with open(os.path.join(REPO, "PERF.md")) as f:
        text = f.read()
    rows = re.findall(r"^\| (train|serve|eval) \| (float32|bfloat16) \| "
                      r"`(\w+)` \|", text, re.M)
    return {(m, p): s for m, p, s in rows}


def test_the_policy_is_perf_mds_table():
    assert _policy_table() == compile_cache.POLICY
    assert set(compile_cache.POLICY.values()) <= set(compile_cache.SETTINGS)


def test_run_start_records_the_policy(fit_logdir, tmp_path):
    import torch

    from eksml_tpu_torch import config as t_config
    from eksml_tpu_torch.convert import init_params
    from eksml_tpu_torch.serve import InferenceEngine
    from eksml_tpu_torch.train import Trainer

    (start,) = [r for r in _rows(fit_logdir) if r.get("event") == "run_start"]
    assert start["cudnn"] == compile_cache.policy_for("train", "float32")
    cfg = t_config.config.clone()
    cfg.freeze(False)
    cfg.update_args(TRAIN_ITEMS + ["TRAIN.PRECISION=bfloat16"])
    cfg = t_config.finalize_configs(True, cfg)
    trainer = Trainer(cfg, str(tmp_path), device="cpu")
    trainer.close()
    (start,) = [r for r in _rows(str(tmp_path))
                if r.get("event") == "run_start"]
    assert start["cudnn"] == compile_cache.policy_for("train", "bfloat16")
    assert start["cudnn"]["setting"] == _policy_table()[("train",
                                                          "bfloat16")]
    for precision in ("float32", "bfloat16"):
        scfg = t_config.config.clone()
        scfg.freeze(False)
        scfg.update_args(list(SMOKE_OVERRIDES)
                         + [f"TRAIN.PRECISION={precision}"])
        scfg = t_config.finalize_configs(False, scfg)
        engine = InferenceEngine(scfg, params=init_params(
            scfg, torch.Generator().manual_seed(0)), device="cpu")
        engine.close()
        assert engine.cudnn == compile_cache.policy_for("serve", precision)
        assert engine.cudnn["setting"] == _policy_table()[("serve",
                                                            precision)]
        assert torch.backends.cudnn.benchmark == engine.cudnn["benchmark"]


def _cudnn_assignments(source: str):
    """Targets ``torch.backends.cudnn.benchmark`` / ``benchmark_limit``
    (or ``cudnn.<same>``) assigned in ``source``, incl. ``setattr``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        targets = []
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "setattr" and len(node.args) >= 2
              and isinstance(node.args[1], ast.Constant)):
            if (node.args[1].value in ("benchmark", "benchmark_limit")
                    and "cudnn" in ast.unparse(node.args[0])):
                found.append(ast.unparse(node))
            continue
        for t in targets:
            if (isinstance(t, ast.Attribute)
                    and t.attr in ("benchmark", "benchmark_limit")
                    and "cudnn" in ast.unparse(t.value)):
                found.append(ast.unparse(t))
    return found


def test_only_compile_cache_sets_cudnns_autotune():
    paths = [os.path.join(REPO, "chip_smoke.py")] + glob.glob(
        os.path.join(REPO, "eksml_tpu_torch", "**", "*.py"), recursive=True)
    setters = {}
    for path in paths:
        with open(path) as f:
            got = _cudnn_assignments(f.read())
        if got:
            setters[os.path.relpath(path, REPO)] = got
    assert setters == {os.path.join("eksml_tpu_torch", "utils",
                                    "compile_cache.py"): [
        "torch.backends.cudnn.benchmark",
        "torch.backends.cudnn.benchmark_limit"]}
    # the check finds a planted one
    assert _cudnn_assignments("import torch\ntorch.backends.cudnn."
                              "benchmark = True\nsetattr(torch.backends."
                              "cudnn, 'benchmark_limit', 2)\n") == [
        "torch.backends.cudnn.benchmark",
        "setattr(torch.backends.cudnn, 'benchmark_limit', 2)"]


def _point(mode, precision, **settings):
    """An autotune point: per setting (start s, median ms, spread ms)."""
    return {"mode": mode, "precision": precision, "settings": {
        s: {"start_s": a, "median_ms": m, "spread_ms": q}
        for s, (a, m, q) in settings.items()}}


def test_the_autotune_rule():
    import chip_smoke

    # 1 % of 300 ms is 3 ms, above the 2 ms spread: 302.9 passes, 303.1
    # does not; a faster median always passes; the least start wins
    recs = {"autotune": {"start_s": 100.0, "median_ms": 300.0,
                         "spread_ms": 2.0},
            "autotune_limit_2": {"start_s": 90.0, "median_ms": 302.9,
                                 "spread_ms": 9.0},
            "heuristics": {"start_s": 3.0, "median_ms": 303.1,
                           "spread_ms": 0.1}}
    assert chip_smoke.autotune_verdict(recs)[:2] == (
        ["autotune", "autotune_limit_2"], "autotune_limit_2")
    # a spread above 1 % widens the bound
    recs["autotune"]["spread_ms"] = 3.5
    assert chip_smoke.autotune_verdict(recs) == (
        ["autotune", "autotune_limit_2", "heuristics"], "heuristics", 3.5)
    recs["heuristics"]["median_ms"] = 250.0
    assert chip_smoke.autotune_verdict(recs)[1] == "heuristics"
    # a row takes a setting only where it passes at every point
    points = {}
    for label, h_median in (("a", 100.5), ("b", 120.0)):
        p = _point("train", "bfloat16", autotune=(20.0, 100.0, 0.1),
                   autotune_limit_2=(19.0, 100.2, 0.1),
                   heuristics=(2.0, h_median, 0.1))
        p["passing"] = chip_smoke.autotune_verdict(p["settings"])[0]
        points[label] = p
    s = _point("serve", "float32", autotune=(10.0, 50.0, 0.1),
               autotune_limit_2=(9.0, 50.1, 0.1), heuristics=(1.0, 50.2, 0.1))
    s["passing"] = chip_smoke.autotune_verdict(s["settings"])[0]
    points["s"] = s
    assert chip_smoke.autotune_policy(points) == {
        ("train", "bfloat16"): "autotune_limit_2",
        ("serve", "float32"): "heuristics"}
    # the applied policy is held to a run's verdicts: at the held f32
    # point the rule must choose the full autotune, where that was
    # measured in a fresh process
    def held(limit_2, fresh=True):
        p = _point("train", "float32", autotune=(115.0, 314.0, 1.3),
                   autotune_limit_2=limit_2, heuristics=(1.7, 412.0, 2.1))
        for r in p["settings"].values():
            r["fresh"] = fresh
        p["passing"], p["chosen"], _ = chip_smoke.autotune_verdict(
            p["settings"])
        return {"train_f32_b4": p}

    chip_smoke.check_autotune_policy(held((5.1, 334.8, 4.6)))
    with pytest.raises(AssertionError):
        chip_smoke.check_autotune_policy(held((5.1, 316.0, 4.6)))
    chip_smoke.check_autotune_policy(held((5.1, 316.0, 4.6), fresh=False))
