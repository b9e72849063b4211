"""The port's training ladder (``python -m eksml_tpu_torch.tools.bench``)
on the CPU at SMOKE widths: the rungs keep the reference's names and
geometry (``bench.py`` at the repository root), one rung prints every
field of its JSON line, ``mfu`` is the counted FLOPs without REMAT's
recompute per second over the named peak, an unknown rung raises, and
the default device of the ladder, ``eval_ckpt`` and ``perf_gate`` is
``cuda`` (raising without a card)."""

import json
import os
import sys

import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench as j_bench  # noqa: E402
from eksml_tpu_torch.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu_torch.profiling import predict as t_predict  # noqa: E402
from eksml_tpu_torch.tools import bench  # noqa: E402

FIELDS = ("operating_point", "value", "batch_size", "image_size",
          "precision", "remat", "param_dtype", "first_step_s",
          "step_time_ms", "tflops_per_step", "recompute_tflops", "mfu",
          "mfu_peak", "predicted_step_time_ms", "predicted_sections_ms",
          "predicted_components_ms", "predicted_peak_hbm_bytes",
          "measured_peak_bytes", "device_kind", "card")


def test_rungs_are_the_reference_ladder():
    assert [{k: v for k, v in r.items()} for r in bench.RUNGS] == \
        [dict(r) for r in j_bench.RUNGS]


def test_unknown_rung_raises():
    with pytest.raises(ValueError, match="unknown rung"):
        bench.main(["--device", "cpu", "--rungs", "512_b1,1344_b9"])
    with pytest.raises(ValueError, match="unknown rung"):
        bench.select_rungs(",")
    assert [r["name"] for r in bench.select_rungs("1344_b4,512_b1")] == [
        "512_b1", "1344_b4"]


def test_one_rung_on_the_cpu_prints_every_field(tmp_path, capsys):
    recs = bench.main(["--device", "cpu", "--rungs", "512_b1",
                       "--steps", "1", "--warmup", "2",
                       "--precision", "float32", "--out", str(tmp_path),
                       "--config", *SMOKE_OVERRIDES])
    (rec,) = recs
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    assert json.loads((tmp_path / "bench_rung_512_b1.json").read_text()) \
        == line
    for key in FIELDS:
        assert key in rec, key
    assert rec["operating_point"] == "512_b1"
    assert rec["image_size"] == [128, 128]      # SMOKE's canvas wins
    assert rec["first_step_s"] > 0 and rec["step_time_ms"] > 0
    assert rec["value"] == pytest.approx(1 / (rec["step_time_ms"] / 1e3))
    peak = t_predict.CHIP_SPECS["h100"]["peak_flops"]["float32"]
    assert rec["mfu_peak"]["flops_per_s"] == peak
    assert "float32" in rec["mfu_peak"]["name"]
    assert rec["mfu"] == pytest.approx(
        rec["tflops_per_step"] * 1e12 / (rec["step_time_ms"] / 1e3) / peak,
        rel=1e-12)
    assert rec["tflops_per_step"] > 0 and rec["recompute_tflops"] == 0
    assert rec["predicted_step_time_ms"] == pytest.approx(
        sum(rec["predicted_sections_ms"].values()), rel=1e-12)
    assert rec["predicted_peak_hbm_bytes"] > 0
    assert rec["measured_peak_bytes"] is None and rec["card"] is None


@pytest.mark.parametrize("module", ["bench", "eval_ckpt", "perf_gate",
                                    "perf_gate --serve"])
def test_tools_default_to_cuda_and_raise_without_it(module, tmp_path,
                                                    monkeypatch):
    from eksml_tpu_torch.tools import eval_ckpt, perf_gate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, args = {
        "bench": (bench.main, ["--rungs", "512_b1"]),
        "eval_ckpt": (eval_ckpt.main, ["--logdir", str(tmp_path),
                                       "--data", str(tmp_path)]),
        "perf_gate": (perf_gate.main, ["--rungs", "128_b1", "--strategies",
                                       "replicated", "--bank",
                                       str(tmp_path)]),
        "perf_gate --serve": (perf_gate.main, [
            "--serve", "--serve-rungs", "serve_128x128_b1", "--bank",
            str(tmp_path)]),
    }[module]
    with pytest.raises(RuntimeError,
                       match=r"torch.cuda.is_available\(\) is False"):
        main(args)


def test_chip_smoke_roofline_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s roofline phase at SMOKE widths on the CPU (the
    wrappers take their plain versions, counted here as the kernels
    would be): the ladder's bfloat16 + REMAT point with 3 / 2 / 8
    launches per step, and ``eval_ckpt`` on a run's checkpoint with the
    AP of ``run_evaluation`` on the same weights."""
    import chip_smoke

    import eksml_tpu_torch.device as t_device
    from eksml_tpu_torch import train as t_train
    from eksml_tpu_torch.config import config as t_cfg
    from eksml_tpu_torch.ops.cuda import roi_align_kernel
    from eksml_tpu_torch.ops.roi_align import KERNELS

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
    monkeypatch.setattr(chip_smoke, "VARIANT_BASE", (
        *SMOKE_OVERRIDES, "PREPROC.TEST_SHORT_EDGE_SIZE=128",
        "RPN.TEST_PRE_NMS_TOPK=64", "RPN.TEST_POST_NMS_TOPK=32",
        "TEST.EVAL_BATCH_SIZE=2", "TELEMETRY.PORT=0"))
    # the bf16 + REMAT point (the f32 path is the one-rung test's)
    monkeypatch.setattr(chip_smoke, "ROOFLINE_POINTS",
                        chip_smoke.ROOFLINE_POINTS[1:2])
    monkeypatch.setattr(chip_smoke, "ROOFLINE_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "ROOFLINE_EVAL_IMAGES", 2)
    monkeypatch.setattr(t_device, "resolve_device",
                        lambda device="cuda": torch.device("cpu"))
    run = str(tmp_path / "run")
    saved = t_cfg.to_dict()
    try:
        assert t_train.main([
            "--device", "cpu", "--synthetic", "--logdir", run,
            "--total-steps", "2", "--config", *chip_smoke.VARIANT_BASE,
            "TRAIN.BATCH_SIZE_PER_CHIP=1", "TRAIN.STEPS_PER_EPOCH=2",
            "TRAIN.CHECKPOINT_PERIOD=1"]) == 0
    finally:
        t_cfg.from_dict(saved)
    observed = {"attribution": {"component_pct": {"backbone": 40.0}},
                "bf16": {"component_pct": {"backbone": 50.0}}}
    out = chip_smoke.phase_roofline(KERNELS, 0, str(tmp_path), observed,
                                    {"run": run}, device="cpu")
    bf16 = out["points"]["bf16_remat"]
    assert bf16["precision"] == "bfloat16" and bf16["remat"]
    assert bf16["recompute_tflops"] > 0
    assert bf16["launches"] == {"roi_align_fwd": 12, "roi_align_bwd": 8,
                                "copy_to_global": 32}
    assert out["eval_ckpt"]["step"] == 2
    assert out["eval_ckpt"]["max_ap_diff"] <= chip_smoke.AP_TOL
