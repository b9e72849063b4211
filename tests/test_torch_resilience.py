"""The port's resilience layer (``eksml_tpu_torch/resilience``) against
``eksml_tpu/resilience`` on the same inputs, and the trainer's use of it
on the CPU: divergence rollback, the skipped save of a non-finite state,
the rollback budget, and SIGTERM → forced checkpoint → exit 77 → resume
through ``python -m eksml_tpu_torch.train``.

The trainer runs at ``SMOKE_OVERRIDES`` widths on 128 px canvases,
batch 1, on synthetic data."""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

jax.config.update("jax_platforms", "cpu")

from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.parallel import topology as j_topology  # noqa: E402
from eksml_tpu.resilience import integrity as j_integrity  # noqa: E402
from eksml_tpu.resilience import preemption as j_preemption  # noqa: E402
from eksml_tpu.resilience import retry as j_retry  # noqa: E402
from eksml_tpu.resilience import sentinel as j_sentinel  # noqa: E402
from eksml_tpu.resilience import watchdog as j_watchdog  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.data import loader as t_loader  # noqa: E402
from eksml_tpu_torch.parallel import topology as t_topology  # noqa: E402
from eksml_tpu_torch.resilience import integrity as t_integrity  # noqa: E402
from eksml_tpu_torch.resilience import preemption as t_preemption  # noqa: E402
from eksml_tpu_torch.resilience import retry as t_retry  # noqa: E402
from eksml_tpu_torch.resilience import sentinel as t_sentinel  # noqa: E402
from eksml_tpu_torch.resilience import watchdog as t_watchdog  # noqa: E402

IMPLS = ("eksml_tpu", "eksml_tpu_torch")
INTEGRITY = dict(zip(IMPLS, (j_integrity, t_integrity)))
PREEMPTION = dict(zip(IMPLS, (j_preemption, t_preemption)))
WATCHDOG = dict(zip(IMPLS, (j_watchdog, t_watchdog)))
RETRY = dict(zip(IMPLS, (j_retry, t_retry)))

# the run-shape knobs of every trainer here
RUN = ("PREPROC.DEVICE_NORMALIZE=False", "TRAIN.BATCH_SIZE_PER_CHIP=1",
       "TRAIN.GRADIENT_CLIP=5.0", "TRAIN.BASE_LR=0.1",
       "TRAIN.WARMUP_STEPS=0", "TRAIN.STEPS_PER_EPOCH=2",
       "TRAIN.CHECKPOINT_PERIOD=1", "TRAIN.LOG_PERIOD=1",
       "TELEMETRY.PORT=0")


# ---------------------------------------------------------------------
# the copied modules, case for case
# ---------------------------------------------------------------------


LOSSES = [1.0, float("nan"), 2.0, float("inf"), float("nan"), 0.5,
          float("nan"), float("nan"), float("nan"), 1.0]


def _sentinel_trace(mod, patience, max_rollbacks):
    s = mod.DivergenceSentinel(patience=patience,
                               max_rollbacks=max_rollbacks)
    trace = []
    for step, loss in enumerate(LOSSES, 1):
        action = s.observe(step, loss)
        entry = [action, s.allows_save(), s.first_bad_step]
        if action == mod.ROLLBACK:
            try:
                s.register_rollback(step, step - 2)
                entry.append("ok")
            except mod.DivergenceError as e:
                entry.append(str(e))
        trace.append(entry)
    return trace, s.rollbacks


@pytest.mark.parametrize("patience,max_rollbacks", [(1, 5), (2, 1), (3, 0)])
def test_sentinel_actions_match_the_reference(patience, max_rollbacks):
    want = _sentinel_trace(j_sentinel, patience, max_rollbacks)
    got = _sentinel_trace(t_sentinel, patience, max_rollbacks)
    assert got == want
    assert any(e[0] == t_sentinel.ROLLBACK for e in got[0])


def _step_dirs(root):
    """Three committed steps with a few files each."""
    rng = np.random.RandomState(0)
    for step in (1, 2, 3):
        d = os.path.join(root, str(step), "sub")
        os.makedirs(d)
        for name in ("a.bin", "sub/b.bin"):
            with open(os.path.join(root, str(step), name), "wb") as f:
                f.write(rng.bytes(100 * step))


def _manifest_story(mod, root, digest):
    """Manifests of one directory and the verdicts on it, damaged in
    turn: truncated, missing, extra file; then quarantine and prune."""
    _step_dirs(root)
    out = {}
    for step in (1, 2, 3):
        mod.write_manifest(root, step, digest=digest)
        with open(mod.manifest_path(root, step)) as f:
            out[f"manifest{step}"] = json.load(f)
    out["listed"] = mod.list_manifest_steps(root)
    out["intact"] = mod.verify_step(root, 3)
    with open(os.path.join(root, "3", "extra.bin"), "wb") as f:
        f.write(b"x")
    out["extra"] = mod.verify_step(root, 3)
    with open(os.path.join(root, "3", "a.bin"), "r+b") as f:
        f.truncate(10)
    out["truncated"] = mod.verify_step(root, 3)
    if digest:
        with open(os.path.join(root, "2", "a.bin"), "r+b") as f:
            f.write(b"\0" * 5)          # same size, other bytes
        out["digest"] = mod.verify_step(root, 2)
    os.remove(os.path.join(root, "1", "sub", "b.bin"))
    out["missing"] = mod.verify_step(root, 1)
    os.remove(mod.manifest_path(root, 1))
    out["no_manifest"] = mod.verify_step(root, 1)
    out["readable"] = [mod.manifest_readable(root, s) for s in (1, 2, 3)]
    out["quarantined"] = os.path.basename(mod.quarantine_step(root, 3))
    out["after_quarantine"] = (sorted(os.listdir(root)),
                               mod.list_manifest_steps(root))
    mod.prune_manifests(root, [1])
    out["pruned"] = mod.list_manifest_steps(root)
    out["missing_dir"] = mod.verify_step(root, 9)
    return out


@pytest.mark.parametrize("digest", [False, True])
def test_integrity_manifests_match_the_reference(tmp_path, digest):
    stories = {}
    for impl, mod in INTEGRITY.items():
        root = str(tmp_path / impl)
        os.makedirs(root)
        stories[impl] = _manifest_story(mod, root, digest)
    assert stories["eksml_tpu_torch"] == stories["eksml_tpu"]
    story = stories["eksml_tpu_torch"]
    assert story["intact"][0] and story["extra"][0]
    assert not story["truncated"][0] and not story["missing"][0]
    assert story["no_manifest"][0]
    assert (not story["digest"][0]) if digest else True


def test_topology_descriptors_match_the_reference():
    """``describe``/``diff``/``compatible`` on descriptors with the
    reference's fields: the port adds ``device_kind``, which an old
    descriptor lacks and so never counts as a difference."""
    a = {"mesh_shape": [1, 8], "mesh_axes": ["data", "model"],
         "num_slices": 1, "strategy": "replicated", "fsdp_axis_size": 1,
         "model_axis_size": 1, "num_devices": 8, "process_count": 2}
    b = dict(a, num_devices=4, mesh_shape=[1, 4])
    for x, y in ((a, a), (a, b), (a, dict(a, num_slices=None))):
        assert t_topology.compatible(x, y) == j_topology.compatible(x, y)
        assert t_topology.diff(x, y) == j_topology.diff(x, y)
    assert t_topology.compatible(a, None) and j_topology.compatible(a, None)
    assert not t_topology.compatible(a, b)
    cur = t_topology.current_topology("cpu")
    assert t_topology.compatible(cur, cur)
    assert not t_topology.compatible(cur, dict(cur, device_kind="other"))
    assert "device_kind: cpu -> other" in t_topology.diff(
        cur, dict(cur, device_kind="other"))


@pytest.mark.parametrize("impl", IMPLS)
def test_preemption_flag_and_exit_code(impl):
    mod = PREEMPTION[impl]
    prev = signal.getsignal(signal.SIGTERM)
    h = mod.PreemptionHandler(exit_code=77).install()
    try:
        assert not h.requested and not h.should_checkpoint(5, 1)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not h.requested and time.monotonic() < deadline:
            time.sleep(0.01)
        assert h.requested and h.should_checkpoint(5, 1)
        assert h.signal_time is not None
        err = h.preempted(5)
        assert isinstance(err, SystemExit) and isinstance(err, mod.PreemptedError)
        assert (err.code, err.exit_code, err.step) == (77, 77, 5)
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev
    assert mod.DEFAULT_EXIT_CODE == 77


@pytest.mark.parametrize("impl", IMPLS)
def test_watchdog_reports_a_stall(impl, tmp_path):
    mod = WATCHDOG[impl]
    fired = []
    wd = mod.HangWatchdog(0.2, report_dir=str(tmp_path),
                          first_beat_factor=1.0, poll_sec=0.05,
                          on_hang=lambda n, phase: fired.append((n, phase)))
    wd.add_report_provider("data pipeline", lambda: "queue depth 0")
    wd.add_report_provider("broken", lambda: 1 / 0)
    with wd:
        wd.beat("train_step", 7)
        deadline = time.monotonic() + 10
        while not wd.reports and time.monotonic() < deadline:
            time.sleep(0.02)
    assert wd.fires >= 1 and fired[0] == (1, "train_step")
    text = open(wd.reports[0]).read()
    for want in ("stalled phase: train_step", "step: 7",
                 "deadline_sec: 0.2", "--- data pipeline ---",
                 "queue depth 0", "<report provider failed: ZeroDivision",
                 f"pid {os.getpid()}", "--- thread MainThread"):
        assert want in text, want


@pytest.mark.parametrize("impl", IMPLS)
def test_retry_call(impl):
    mod = RETRY[impl]
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    assert mod.retry_call(flaky, attempts=4, backoff_sec=0.5,
                          retry_on=(OSError,), sleep=sleeps.append) == "ok"
    assert sleeps == [0.5, 1.0]
    with pytest.raises(RuntimeError, match="after 2 attempt"):
        mod.retry_call(lambda: 1 / 0, attempts=2, sleep=sleeps.append)


# ---------------------------------------------------------------------
# the trainer: rollback, skipped saves, the budget
# ---------------------------------------------------------------------


def _cfg(*extra):
    cfg = t_config.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(SMOKE_OVERRIDES) + list(RUN) + list(extra))
    cfg.freeze()
    return cfg


def _batches(cfg, n, seed=0):
    ds = t_loader.SyntheticDataset(num_images=8, height=128, width=128,
                                   num_classes=cfg.DATA.NUM_CLASSES,
                                   seed=seed)
    loader = t_loader.DetectionLoader(ds.records(), cfg, 1, seed=seed,
                                      gt_mask_size=28)
    return list(loader.batches(n))


def _events(logdir):
    with open(os.path.join(logdir, "events-host0.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_rollback_restores_the_last_good_step(tmp_path):
    """NaN injected after step 3's update (patience 2): step 4's loss is
    the first non-finite one (logged, and its checkpoint skipped); step
    5's rolls back to step 2, and the run trains on to 6 on fresh
    batches with finite checkpoints at 4 and 6."""
    cfg = _cfg("RESILIENCE.FAULT_INJECT_NAN_STEP=3",
               "RESILIENCE.NAN_PATIENCE=2", "RESILIENCE.MAX_ROLLBACKS=1")
    logdir = str(tmp_path)
    trainer = t_train.Trainer(cfg, logdir, device="cpu")
    batches = _batches(cfg, 9)
    it = iter(batches)
    rows = trainer.fit(it, 6)
    trainer.close()
    assert next(it, None) is None            # 9 batches: 5 + 4 after
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 3, 4, 5, 6]
    assert [np.isfinite(r["total_loss"]) for r in rows] == \
        [True, True, True, False, True, True, True, True]
    kinds = [(e["kind"], e.get("step")) for e in _events(logdir)]
    assert ("checkpoint_skipped", 4) in kinds
    rollback = [e for e in _events(logdir) if e["kind"] == "rollback"]
    assert [(e["step"], e["to_step"], e["first_bad_step"])
            for e in rollback] == [(5, 2, 4)]
    assert trainer.ckpt.all_steps() == [2, 4, 6]
    for step in (2, 4, 6):
        state = trainer.ckpt.restore(step)
        assert state["step"] == step
        assert all(bool(torch.isfinite(t).all())
                   for t in state["model"].values()), step
        assert t_integrity.verify_step(trainer.ckpt.directory, step)[0]
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["event"] == "run_start"
    assert {"step": 2, "resilience/rollback_from": 5.0}.items() <= \
        next(r for r in lines if "resilience/rollback_from" in r).items()


@pytest.mark.parametrize("inject,max_rollbacks,match", [
    (3, 0, "MAX_ROLLBACKS=0"),
    (1, 2, "no restorable checkpoint"),
])
def test_divergence_error_past_the_budget(tmp_path, inject, max_rollbacks,
                                          match):
    cfg = _cfg(f"RESILIENCE.FAULT_INJECT_NAN_STEP={inject}",
               "RESILIENCE.NAN_PATIENCE=1",
               f"RESILIENCE.MAX_ROLLBACKS={max_rollbacks}")
    trainer = t_train.Trainer(cfg, str(tmp_path), device="cpu")
    with pytest.raises(t_sentinel.DivergenceError, match=match):
        trainer.fit(iter(_batches(cfg, 8)), 6)
    # nothing non-finite was ever committed
    for step in trainer.ckpt.all_steps():
        assert all(bool(torch.isfinite(t).all()) for t in
                   trainer.ckpt.restore(step)["model"].values())
    trainer.close()


# ---------------------------------------------------------------------
# SIGTERM → forced checkpoint → exit 77 → relaunch resumes
# ---------------------------------------------------------------------


def _launch(logdir, total_steps):
    return subprocess.Popen(
        [sys.executable, "-m", "eksml_tpu_torch.train", "--device", "cpu",
         "--synthetic", "--logdir", logdir, "--total-steps",
         str(total_steps), "--config", *SMOKE_OVERRIDES, *RUN,
         "TRAIN.STEPS_PER_EPOCH=1000"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _logged_steps(logdir):
    try:
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    except (OSError, ValueError):
        return []
    return [r["step"] for r in rows if "total_loss" in r]


def test_sigterm_exits_77_with_a_forced_checkpoint_and_resumes(tmp_path):
    logdir = str(tmp_path / "run")
    proc = _launch(logdir, 10_000)
    try:
        deadline = time.monotonic() + 240
        while (not _logged_steps(logdir) and proc.poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.2)
        assert proc.poll() is None, proc.stdout.read()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 77, out
    root = os.path.join(logdir, "checkpoints")
    steps = sorted(int(s) for s in os.listdir(root) if s.isdigit())
    assert len(steps) == 1, (steps, out)
    stopped = steps[0]
    assert stopped == max(_logged_steps(logdir))
    assert t_integrity.verify_step(root, stopped)[0]
    assert "forcing checkpoint at step" in out

    proc = _launch(logdir, stopped + 1)
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode == 0, out
    assert f"resuming from checkpoint step {stopped}" in out
    assert _logged_steps(logdir)[-1] == stopped + 1
    assert sorted(int(s) for s in os.listdir(root) if s.isdigit()) == \
        [stopped, stopped + 1]
