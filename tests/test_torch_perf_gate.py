"""The port's gates (``eksml_tpu_torch/tools/perf_gate.py`` and
``bench_gate.py``) on the CPU:

- ``perf_gate`` counts the ``128_b1`` rung (replicated, float32, SMOKE
  widths) once, banks it into a temporary directory, and the same count
  gates PASS; the same count with the ``backbone-bwd`` work (FLOPs and
  bytes) raised 34 % FAILs naming that component, and a peak memory raised past the bound
  FAILs naming the live-at-peak component that grew; the committed
  ``artifacts/h100/`` entry of the rung gates PASS against this recount
  at the default ``--max-regress-pct``; the multi-node rungs price
  hierarchical below flat; ``tensor`` and ``2d`` are counted and priced
  over the reference's lowering mesh; ``--calibrate-only`` over seeded ladder lines is
  ``calibrate(calibration_points(...))``; the CLI banks and gates
  (``--device cpu``: it counts on the card unless asked,
  ``tests/test_torch_bench.py``); the seeded model leaves the caller's
  global RNG as it was;
- ``bench_gate``'s ``gate`` gives the reference's verdict
  (``tools/bench_gate.gate``) on the same seeded lines; a line of
  another card is never a baseline; a fresh line without a measurement
  FAILs; ``--predicted`` gates through ``perf_gate.gate_one``.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu_torch.fsio import atomic_write_json  # noqa: E402
from eksml_tpu_torch.profiling import predict  # noqa: E402
from eksml_tpu_torch.tools import bench_gate, perf_gate  # noqa: E402
from tools import bench_gate as ref_bench_gate  # noqa: E402

RUNG = "128_b1"
KEY = "128_b1_replicated_float32"


@pytest.fixture(scope="module")
def counted():
    return perf_gate.count_rung(RUNG, "float32", device="cpu")


@pytest.fixture(scope="module")
def fresh(counted):
    return perf_gate.predict_rung(RUNG, "replicated", "float32",
                                  counted=counted)


@pytest.fixture()
def bank(tmp_path, fresh):
    d = str(tmp_path / "bank")
    os.makedirs(d)
    atomic_write_json(perf_gate.baseline_path(d, KEY), fresh)
    return d


def test_the_record_is_keyed_and_priced_for_the_card(fresh):
    assert fresh["key"] == KEY and fresh["target"] == "h100"
    assert fresh["model_widths"] == "smoke" and fresh["counted_on"] == "cpu"
    assert fresh["geometry"]["image_size"] == 128
    assert fresh["predicted_step_time_ms"] == pytest.approx(
        sum(fresh["sections_ms"].values()))
    assert fresh["hbm"]["peak_hbm_bytes"] > 0
    json.dumps(fresh)


def test_the_same_count_regates_pass(fresh, bank):
    row = perf_gate.gate_one(fresh, bank, 10.0, False)
    assert row["gate"] == "PASS", row
    assert row["verdict"]["total_regress_pct"] == 0.0
    assert row["hbm"]["peak_regress_pct"] == 0.0


def test_the_seeded_model_leaves_the_global_rng_as_it_was():
    """The count's model is drawn from its own seed: the caller's global
    RNG, from which other code builds models, is the same after it."""
    import torch

    from eksml_tpu_torch.tools.bench import seeded_model

    cfg = perf_gate._rung_config(RUNG, "float32")
    before = torch.get_rng_state()
    a = seeded_model(cfg, "cpu", 0).state_dict()
    assert torch.equal(torch.get_rng_state(), before)
    torch.manual_seed(1)        # another global state, the same weights
    b = seeded_model(cfg, "cpu", 0).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    torch.set_rng_state(before)


def _raised(counted, component, factor):
    """The count with ``component``'s work (its FLOPs and its bytes)
    raised by ``factor``."""
    counts, cfg = counted
    ops = []
    for o in counts.ops:
        o = copy.copy(o)
        if o.component == component:
            o.flops = int(o.flops * factor)
            o.bytes = int(o.bytes * factor)
        ops.append(o)
    return predict.StepCounts(ops, counts.allocations, counts.resident,
                              counts.timeline, counts.meta), cfg


def test_a_component_regression_fails_by_its_name(counted, bank):
    """``backbone-bwd`` 34 % costlier FAILs by its name.  Its FLOPs and
    bytes are raised together: at this canvas most of its operations
    are priced by their bytes (``max(flops / peak, bytes / hbm)``), so
    34 % more FLOPs alone move its predicted time by less than the
    bound."""
    worse = perf_gate.predict_rung(RUNG, "replicated", "float32",
                                   counted=_raised(counted, "backbone-bwd",
                                                   1.34))
    row = perf_gate.gate_one(worse, bank, 10.0, False)
    assert row["gate"] == "FAIL"
    assert "component backbone-bwd predicted +34." in row["error"], \
        row["error"]
    comp = next(d for d in row["verdict"]["components"]
                if d["component"] == "backbone-bwd")
    assert comp["regress_pct"] == pytest.approx(34.0, abs=0.2)


def test_a_memory_regression_fails_naming_the_component(fresh, bank):
    worse = copy.deepcopy(fresh)
    live = worse["hbm"]["live_at_peak_by_component"]
    comp = max(live, key=live.get)
    grow = int(0.2 * worse["hbm"]["peak_hbm_bytes"])
    live[comp] += grow
    worse["hbm"]["peak_hbm_bytes"] += grow
    row = perf_gate.gate_one(worse, bank, 10.0, False)
    assert row["gate"] == "FAIL"
    assert row["error"].startswith("predicted peak HBM regressed +")
    assert f"worst component {comp}" in row["error"]


def test_the_committed_bank_passes_this_recount(fresh):
    path = perf_gate.baseline_path(perf_gate.DEFAULT_BANK, KEY)
    assert os.path.exists(path), path
    row = perf_gate.gate_one(fresh, perf_gate.DEFAULT_BANK, 10.0, False)
    assert row["gate"] == "PASS", row
    assert row["baseline_path"] == os.path.join(
        "artifacts", "h100", f"perf_pred_h100_{KEY}.json")


def test_the_multi_node_rungs_price_hierarchical_below_flat(counted):
    for rung, slices in (("128_b1_s2", 2), ("128_b1_s4", 4)):
        rec = perf_gate.predict_rung(rung, "fsdp", "float32",
                                     counted=counted)
        assert rec["mesh_shape"] == {"slice": slices, "data": 1,
                                     "fsdp": 2, "model": 1}
        assert rec["predicted_step_time_ms"] < \
            rec["flat_predicted_step_time_ms"]
        assert rec["comms_ms"]["dcn_ms"] > 0
        row = perf_gate.gate_one(rec, "/nonexistent", 10.0, True)
        assert row["gate"] == "PASS" and row["axis_widths"]["slices"] == \
            slices
        rec["flat_predicted_step_time_ms"] = rec["predicted_step_time_ms"]
        row = perf_gate.gate_one(rec, "/nonexistent", 10.0, True)
        assert row["gate"] == "FAIL" and "not strictly faster" in \
            row["error"]


@pytest.mark.parametrize("strategy", ["tensor", "2d"])
def test_unported_strategies_raise_naming_the_item(counted, strategy,
                                                    capsys):
    """The model-axis strategies are counted and priced: over the
    reference's lowering mesh, with the targets' all-gather and
    reduce-scatter over their shard group, and an unknown strategy is
    refused by name."""
    rec = perf_gate.predict_rung(RUNG, strategy, "float32", counted=counted)
    meta = counted[0].meta
    f = 2 if strategy == "2d" else 1
    assert rec["mesh_shape"] == {"data": 1, "fsdp": f, "model": 2}
    assert rec["key"] == f"{RUNG}_{strategy}_float32"
    rows = [(r["opcode"], r["bytes"], r["group_size"])
            for r in rec["collectives"]]
    tp, tg = meta["target_param_bytes"], meta["target_grad_bytes"]
    rest_p, rest_g = meta["param_bytes"] - tp, meta["grad_bytes"] - tg
    assert 0 < tp < meta["param_bytes"] and 0 < tg < meta["grad_bytes"]
    if strategy == "tensor":
        # the targets over model, the other gradients over every rank
        assert rows == [("all-gather", tp, 2), ("reduce-scatter", tg, 2),
                        ("all-reduce", rest_g, 2)]
    else:
        # the targets over fsdp x model, the rest over fsdp, whose shards
        # are then all-reduced over the model axis' replicas
        assert rows == [("all-gather", tp, 4), ("reduce-scatter", tg, 4),
                        ("all-gather", rest_p, 2),
                        ("reduce-scatter", rest_g, 2),
                        ("all-reduce", rest_g // 2, 4)]
    with pytest.raises(SystemExit):
        perf_gate.main(["--strategies", "replicated,pipeline",
                        "--device", "cpu"])
    assert "pipeline" in capsys.readouterr().err


def test_storage_per_device_gates_2d_below_replicated(counted):
    """Every training record carries the bytes a device stores under its
    plan; only ``replicated``'s carries the count's liveness peak (one
    replica's whole step), and the cross-gate holds ``2d``'s storage
    strictly below ``replicated``'s at the same rung."""
    counts, _ = counted
    recs = {s: perf_gate.predict_rung(RUNG, s, "float32", counted=counted)
            for s in ("replicated", "fsdp", "tensor", "2d")}
    rep = recs["replicated"]["storage_per_device"]
    # replicated stores the count's resident parameters and buffers whole
    assert rep["params_bytes"] + rep["buffers_bytes"] == \
        counts.resident["params"]
    assert 0 < rep["optimizer_bytes"] < rep["params_bytes"]
    assert "hbm" in recs["replicated"]
    for s in ("fsdp", "tensor", "2d"):
        got = recs[s]["storage_per_device"]
        assert "hbm" not in recs[s], s
        assert got["buffers_bytes"] == rep["buffers_bytes"], s
        assert got["total_bytes"] < rep["total_bytes"], s
        assert got["total_bytes"] == (got["params_bytes"]
                                      + got["optimizer_bytes"]
                                      + got["buffers_bytes"]), s
    # the model axis splits only the targets: tensor stores their share
    meta = counts.meta
    tp = meta["target_param_bytes"]
    assert rep["params_bytes"] - recs["tensor"]["storage_per_device"][
        "params_bytes"] == tp // 2
    rows = perf_gate.storage_cross_rows(list(recs.values()))
    assert [(r["key"], r["gate"]) for r in rows] == [
        (f"{RUNG}_storage_cross_strategy", "PASS")]
    two_d = copy.deepcopy(recs["2d"])
    two_d["storage_per_device"]["total_bytes"] = rep["total_bytes"]
    rows = perf_gate.storage_cross_rows([recs["replicated"], two_d])
    assert rows[0]["gate"] == "FAIL"
    assert "not strictly below" in rows[0]["error"]
    assert perf_gate.storage_cross_rows([recs["2d"]]) == []


def _ladder_line(rng, rung, precision, kind="NVIDIA H100 80GB HBM3",
                 **extra):
    step = float(rng.uniform(100, 300))
    line = {"metric": "maskrcnn_r50fpn_train_throughput",
            "operating_point": rung, "value": 4 / (step / 1e3),
            "unit": "images/sec/gpu", "precision": precision,
            "step_time_ms": step, "device_kind": kind,
            "predicted_step_time_ms": float(step / rng.uniform(1.5, 2.5))}
    line.update(extra)
    return line


def test_calibrate_only_is_the_roofline_calibration(tmp_path):
    rng = np.random.RandomState(3)
    art = str(tmp_path / "ladder")
    os.makedirs(art)
    for name, rung, prec in (("f32", "1344_b4", "float32"),
                             ("bf16_remat", "1344_b4", "bfloat16"),
                             ("1344_b8_remat", "1344_b8_remat",
                              "bfloat16")):
        atomic_write_json(os.path.join(art, f"bench_rung_{name}.json"),
                          _ladder_line(rng, rung, prec))
    out = str(tmp_path / "verdict.json")
    assert perf_gate.main(["--calibrate-only", "--artifacts", art,
                           "--out", out]) == 0
    with open(out) as f:
        got = json.load(f)["calibration"]
    want = predict.calibrate(predict.calibration_points(art))
    assert got == want and got["n_points"] == 3


def test_the_cli_banks_then_gates(tmp_path, capsys):
    bank = str(tmp_path / "bank")
    assert perf_gate.main(["--rungs", RUNG, "--strategies", "replicated",
                           "--bank", bank, "--update-baseline",
                           "--device", "cpu"]) == 0
    banked = json.loads(capsys.readouterr().out)
    assert [r["gate"] for r in banked["results"]] == ["BANKED"]
    assert os.listdir(bank) == [f"perf_pred_h100_{KEY}.json"]
    assert perf_gate.main(["--rungs", RUNG, "--strategies", "replicated",
                           "--bank", bank, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["gate"] == "PASS"


# ---------------------------------------------------------------------
# bench_gate
# ---------------------------------------------------------------------


def _write_lines(path, lines):
    with open(path, "w") as f:
        f.write("ladder log\n" + "".join(json.dumps(x) + "\n"
                                         for x in lines))


@pytest.mark.parametrize("seed", range(4))
def test_gate_gives_the_reference_verdict(seed):
    rng = np.random.RandomState(seed)
    bank = [(f"b{i}", _ladder_line(rng, "1344_b4", "float32"))
            for i in range(3)]
    for fresh in (_ladder_line(rng, "1344_b4", "float32"),
                  dict(bank[-1][1], step_time_ms=bank[-1][1][
                      "step_time_ms"] * 1.2),
                  dict(bank[-1][1], value=0.0)):
        for b in (bank, []):
            assert bench_gate.gate(fresh, b, 10.0, True) == \
                ref_bench_gate.gate(fresh, b, 10.0, True)
    text = "log\n" + "\n".join(json.dumps(x) for _, x in bank) + "\n{torn"
    assert bench_gate.extract_metric_line(text) == \
        ref_bench_gate.extract_metric_line(text) == bank[-1][1]
    for line in (bank[0][1], dict(bank[0][1], status="error"),
                 dict(bank[0][1], value=0.0, last_good=bank[1][1]), None):
        assert bench_gate.usable_measurement(line) == \
            ref_bench_gate.usable_measurement(line)


def test_lines_pair_by_rung_precision_and_card(tmp_path, capsys):
    rng = np.random.RandomState(0)
    h100 = _ladder_line(rng, "1344_b4", "float32")
    other = dict(h100, device_kind="NVIDIA A100-SXM4-80GB",
                 step_time_ms=h100["step_time_ms"] / 2)
    bf16 = dict(h100, precision="bfloat16",
                step_time_ms=h100["step_time_ms"] / 3)
    bank = str(tmp_path / "bench_rung_bank.json")
    _write_lines(bank, [h100, other, bf16])
    fresh = str(tmp_path / "fresh.json")
    atomic_write_json(fresh, dict(h100, step_time_ms=h100[
        "step_time_ms"] * 1.05))
    assert bench_gate.main(["--fresh", fresh, "--bank", bank]) == 0
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["evidence_source"] == "measured"
    (row,) = verdict["results"]
    assert row["baseline"]["step_time_ms"] == h100["step_time_ms"]
    # a line of another card alone is never a baseline
    only_other = str(tmp_path / "other.json")
    _write_lines(only_other, [other])
    assert bench_gate.main(["--fresh", fresh, "--bank", only_other]) == 1
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["results"][0]["note"] == "no usable banked baseline"


def test_a_fresh_line_without_a_measurement_fails(tmp_path, capsys):
    rng = np.random.RandomState(1)
    line = _ladder_line(rng, "512_b1", "float32")
    bank = str(tmp_path / "bank.json")
    _write_lines(bank, [line])
    fresh = str(tmp_path / "fresh.json")
    _write_lines(fresh, [dict(line, status="error", value=0.0)])
    assert bench_gate.main(["--fresh", fresh, "--bank", bank]) == 1
    verdict = json.loads(capsys.readouterr().out)
    assert "no usable measurement" in verdict["results"][0]["error"]
    empty = str(tmp_path / "empty.json")
    _write_lines(empty, [])
    assert bench_gate.main(["--fresh", empty, "--bank", bank]) == 1


def test_predicted_gates_through_perf_gate(tmp_path, fresh, bank, capsys):
    fresh_dir = str(tmp_path / "fresh")
    os.makedirs(fresh_dir)
    atomic_write_json(perf_gate.baseline_path(fresh_dir, KEY),
                      dict(fresh, banked_at=perf_gate._utcnow()))
    empty = str(tmp_path / "no_card.txt")
    _write_lines(empty, [])
    argv = ["--fresh", empty, "--bank", empty, "--predicted",
            "--pred-fresh", os.path.join(fresh_dir, "perf_pred_*.json"),
            "--pred-bank", bank]
    assert bench_gate.main(argv) == 0
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["evidence_source"] == "predicted"
    assert [r["key"] for r in verdict["results"]] == [KEY]
    assert verdict["results"][0]["verdict"]["total_regress_pct"] == 0.0
    atomic_write_json(perf_gate.baseline_path(fresh_dir, KEY),
                      dict(fresh, banked_at="2000-01-01T00:00:00Z"))
    assert bench_gate.main(argv) == 1
    assert "old (limit 24.0h)" in json.loads(
        capsys.readouterr().out)["results"][0]["error"]
