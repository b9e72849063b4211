"""``chip_smoke.py``'s model-variant phases (train_bf16, cascade,
variants_reference and the serve_bf16 phase's card-vs-CPU check),
rehearsed on the CPU at SMOKE widths: the launch counts and the checks
the phases make, with the wrappers' plain versions counted as the
kernels would be.  (No JAX: the phases compare the card with the CPU.)
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch import train as t_train  # noqa: E402
from eksml_tpu_torch.config import SMOKE_OVERRIDES  # noqa: E402


def test_chip_smoke_variant_phases_run_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s train_bf16, cascade and variants_reference
    phases and the serve_bf16 phase's card-vs-CPU check at SMOKE widths
    on a 128² canvas on the CPU (the wrappers take their plain versions,
    counted here as the kernels would be; the "card" runs are CPU runs):
    the launches per step (3 / 2 / 8; the cascade's 5 / 4 / 16 and 4 per
    predict forward), halved state bytes under bf16 storage, and the
    variants' card-vs-CPU steps equal."""
    import chip_smoke

    import eksml_tpu_torch.device as t_device
    from eksml_tpu_torch.ops.cuda import roi_align_kernel
    from eksml_tpu_torch.ops.roi_align import KERNELS

    monkeypatch.setattr(chip_smoke, "BATCH", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "CASCADE_STEPS", 2)
    # the cascade's code at SMOKE depth (R101's blocks are the same code)
    monkeypatch.setattr(chip_smoke, "CASCADE", ("MODE_CASCADE=True",))
    monkeypatch.setattr(chip_smoke, "VARIANT_BASE", tuple(SMOKE_OVERRIDES) + (
        "PREPROC.TEST_SHORT_EDGE_SIZE=128", "RPN.TEST_PRE_NMS_TOPK=64",
        "RPN.TEST_POST_NMS_TOPK=32", "TELEMETRY.PORT=0"))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    cpu = lambda device="cuda": torch.device("cpu")  # noqa: E731
    for mod in (t_device, t_train):
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
    names = [k.name for k in KERNELS]
    before = t_config.config.to_dict()
    bf16 = chip_smoke.phase_train_bf16(KERNELS, 0, str(tmp_path))
    assert bf16["launches"] == dict(zip(names, (6, 4, 16)))
    assert bf16["param_bf16"]["param_bytes"] * 2 == \
        bf16["remat"]["param_bytes"]
    assert set(bf16["memory"]) == {"remat", "no_remat"}
    casc = chip_smoke.phase_cascade(KERNELS, 0, str(tmp_path))
    assert casc["launches_per_step"] == dict(zip(names, (5, 4, 16)))
    assert casc["predict_launches"] == dict(zip(names, (4, 0, 0)))
    variants = chip_smoke.phase_variants_reference(0, img=128)
    assert set(variants) == {"bfloat16", "gn", "cascade", "remat"}
    for name, errs in variants.items():
        assert errs["losses"] == errs["gradients"] == 0.0, (name, errs)
    chip_smoke.serve_bf16_reference(0, img=128)
    # each phase configures a clone: the global config is as it was
    assert t_config.config.to_dict() == before
