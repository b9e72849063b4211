"""The port's reports on a run (``eksml_tpu_torch/tools/run_report.py``,
``goodput_report.py``, ``trace_summary.py``) on the CPU, against the
reference tools (``tools/run_report.py``, ``tools/trace_summary.py``):

- one seeded logdir in the banks' shared formats (two ``run_start``
  segments, events of two trainer hosts, a resharded restore, a
  non-finite row, goodput snapshots, two hosts' span traces, an
  attribution artifact, the operator's decision trail and the serving
  fleet's and promotion controller's events): every section that reads
  no prediction and no lint renders equal, line for line, to the
  reference's; ``merge_host_traces`` equals the reference's exactly;
- ``effective_mfu`` against a hand-computed value on an h100 record, and
  a note (never a number) for a TPU prediction;
- a report of an empty logdir names nothing of the repository's
  ``artifacts/``;
- ``trace_summary.summarize`` on a hand-written capture with device
  events: device time by component through ``TraceAttribution``, the
  same ``component_pct`` through the capture's banked attribution
  artifact; ``--hlo`` is refused;
- one SMOKE ``train.main`` on the CPU (3 steps, tracing, goodput and a
  one-step capture): every section whose artifact the run wrote renders
  from it, the goodput ratio equals ``build_ledger``'s, and the CLI
  writes the report.
"""

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu_torch.profiling.attribution import (  # noqa: E402
    write_attribution_artifact)
from eksml_tpu_torch.telemetry.goodput import BUCKETS  # noqa: E402
from eksml_tpu_torch.telemetry.goodput import build_ledger  # noqa: E402
from eksml_tpu_torch.tools import goodput_report  # noqa: E402
from eksml_tpu_torch.tools import run_report  # noqa: E402
from eksml_tpu_torch.tools import trace_summary  # noqa: E402
from tools import run_report as ref_report  # noqa: E402
from tools import trace_summary as ref_trace  # noqa: E402

T0 = 1_700_000_000.0

#: sections that read no prediction and no lint: equal to the reference
#: line for line (the goodput section up to its effective-MFU line)
SHARED_SECTIONS = ("Run segments", "Incident timeline (flight recorder)",
                   "Elastic resume (topology changes)",
                   "Goodput (whole-run wall-clock ledger)",
                   "Autoscaling (operator decision trail)",
                   "Deployments (serving hot-reload / canary)",
                   "Slow steps (span tracing)",
                   "Modeled cost by component (profile attribution)")


def _jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _spans(rng, host, skew_us, steps):
    """One host's span trace: per step the fit loop's data_wait,
    globalize_batch, train_step and host_metrics spans, a clock skew of
    ``skew_us``; host 1 waits ~400 ms for the third step's batch."""
    events, ts = [], T0 * 1e6 + skew_us
    for step in steps:
        for name, mean in (("data_wait", 4e3), ("globalize_batch", 5e2),
                           ("train_step", 2e5), ("host_metrics", 1e3)):
            dur = float(mean * rng.uniform(0.5, 1.5)
                        * (100 if (name == "data_wait" and host == 1
                                   and step == steps[2]) else 1))
            events.append({"ph": "X", "name": name, "pid": host,
                           "tid": 1, "ts": round(ts, 3), "dur": dur,
                           "args": {"step": step}})
            ts += dur
    return {"traceEvents": events}


def seeded_logdir(path, seed=0):
    """A run in the banks' shared formats: the trainer's two segments
    on two hosts (the second a resharded restore with a non-finite
    step), its goodput bank and span traces, a capture's attribution,
    the operator's trail and the serving fleet's events."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(path, "profile"), exist_ok=True)
    rows = [{"event": "run_start", "time": T0, "git_sha": "abc123",
             "config_digest": "cafe01", "host_count": 2, "pid": 11,
             "argv": ["python", "-m", "eksml_tpu_torch.train"]}]
    for step in range(1, 6):
        st = float(200 + 20 * rng.rand())
        rows.append({"step": step, "time": T0 + step,
                     "total_loss": float(5 / step + rng.rand()),
                     "images_per_sec": float(4000 / st),
                     "step_time_ms": st,
                     "hosts/step_time_ms_min": st,
                     "hosts/step_time_ms_mean": st + 5,
                     "hosts/step_time_ms_max": st + 10,
                     "hosts/count": 2,
                     "hosts/lagging": int(rng.randint(2))})
    rows.append({"step": 5, "time": T0 + 5.5,
                 "checkpoint_save_ms": float(100 + rng.rand())})
    rows.append({"event": "run_start", "time": T0 + 100,
                 "git_sha": "abc123", "config_digest": "cafe02",
                 "host_count": 2, "pid": 12})
    for step in range(6, 9):
        loss = None if step == 7 else float(1 + rng.rand())
        row = {"step": step, "time": T0 + 100 + step,
               "total_loss": loss, "images_per_sec": 19.5}
        if loss is None:
            row["total_loss_raw_repr"] = "nan"
        rows.append(row)
    _jsonl(os.path.join(path, "metrics.jsonl"), rows)
    for host, dt in ((0, 0.0), (1, 0.05)):
        _jsonl(os.path.join(path, f"events-host{host}.jsonl"), [
            {"time": T0 + dt, "host": host, "kind": "run_start",
             "pid": 11},
            {"time": T0 + 5.5 + dt, "host": host,
             "kind": "checkpoint_save", "step": 5, "forced": False,
             "save_ms": 120.0},
            {"time": T0 + 100 + dt, "host": host, "kind": "run_start",
             "pid": 12},
            {"time": T0 + 101 + dt, "host": host,
             "kind": "checkpoint_restore", "step": 5,
             "restore_ms": 300.0},
            {"time": T0 + 101.5 + dt, "host": host,
             "kind": "checkpoint_resharded", "step": 5,
             "saved": "mesh [1, 2, 1] over ['data', 'fsdp', 'model']",
             "current": "mesh [1, 1, 1] over ['data', 'fsdp', 'model']",
             "diff": "fsdp_axis_size: 2 -> 1"},
            {"time": T0 + 107 + dt, "host": host, "kind": "nan_observed",
             "step": 7, "loss": "nan"}])

    def snap(start, t, steps, final=False):
        buckets = {b: round(float(rng.uniform(0, 2)), 3) for b in BUCKETS}
        buckets["downtime"] = 0.0
        buckets["train_step"] = round(float(t - start - 3), 3)
        out = {"time": t, "segment_start": start,
               "elapsed_s": round(t - start, 3),
               "wall_s": round(t - start, 3), "mode": "spans",
               "buckets": buckets,
               "goodput_ratio": round(buckets["train_step"]
                                      / (t - start), 6),
               "steps": steps}
        if final:
            out["final"] = True
        return out

    _jsonl(os.path.join(path, "goodput-host0.jsonl"), [
        snap(T0, T0 + 4, 3), snap(T0, T0 + 6, 5, True),
        snap(T0 + 100, T0 + 109, 3, True)])
    for host, skew in ((0, 0.0), (1, 1.5e6)):
        with open(os.path.join(path, f"trace-host{host}.json"), "w") as f:
            json.dump(_spans(rng, host, skew, [1, 2, 3, 4, 5]), f)
    with open(os.path.join(path, "profile", "attribution.json"), "w") as f:
        json.dump({"map": {"sgemm_kernel": {"backbone": 1.5}},
                   "component_table": {"component_pct": {
                       "backbone-bwd": 41.5, "backbone": 30.25,
                       "roi-fwd": 0.4, "other": 9.0}}}, f)
    _jsonl(os.path.join(path, "autoscale-host0.jsonl"), [
        {"time": T0 + 20, "kind": "decision", "action": "hold",
         "target": "1x1", "target_chips": 1, "reason": "steady"},
        {"time": T0 + 40, "kind": "decision", "action": "grow",
         "target": "1x2", "target_chips": 2, "reason": "capacity 2"},
        {"time": T0 + 60, "kind": "relaunch", "action": "grow",
         "target": "1x2", "target_chips": 2, "exit_code": 77,
         "relaunch_gap_s": 12.5},
        {"time": T0 + 80, "kind": "decision", "action": "shrink",
         "target": "1x1", "target_chips": 1, "reason": "capacity 1"},
        {"time": T0 + 95, "kind": "relaunch", "action": "shrink",
         "target": "1x1", "target_chips": 1, "exit_code": 77,
         "relaunch_gap_s": 9.25}])
    _jsonl(os.path.join(path, "events-hostop.jsonl"), [
        {"time": T0 + 40.5, "host": "op", "kind": "autoscale_transition",
         "action": "grow", "from_chips": 1, "to_chips": 2}])
    _jsonl(os.path.join(path, "canary-host0.jsonl"), [
        {"time": T0 + 150, "verdict": "promote", "p99_ratio": 1.01}])
    _jsonl(os.path.join(path, "events-hoststable.jsonl"), [
        {"time": T0 + 120, "host": "stable", "kind": "serve_reload",
         "step": 5, "previous_step": 3, "duration_ms": 812.5,
         "verification": "digest"},
        {"time": T0 + 125, "host": "stable",
         "kind": "serve_reload_rejected", "step": 6,
         "reason": "integrity", "detail": "digest mismatch on state.pt"}])
    _jsonl(os.path.join(path, "events-hostcanary.jsonl"), [
        {"time": T0 + 130, "host": "canary", "kind": "serve_reload",
         "step": 8, "previous_step": 5, "duration_ms": 790.0,
         "verification": "digest"}])
    _jsonl(os.path.join(path, "events-hostcd.jsonl"), [
        {"time": T0 + 140, "host": "cd", "kind": "canary_score",
         "verdict": "hold", "incumbent_step": 5, "canary_step": 8,
         "p99_ratio": 1.02, "error_rate": 0.0, "drift": 0.01},
        {"time": T0 + 150, "host": "cd", "kind": "canary_score",
         "verdict": "promote", "incumbent_step": 5, "canary_step": 8,
         "p99_ratio": 1.01, "error_rate": 0.0, "drift": 0.012},
        {"time": T0 + 151, "host": "cd", "kind": "canary_promote",
         "step": 8, "previous_step": 5, "streak": 2, "reload_ok": True},
        {"time": T0 + 160, "host": "cd", "kind": "canary_rollback",
         "from_step": 8, "to_step": 5, "reload_ok": True}])
    return path


def sections(report):
    """{section title: its lines} of a rendered report."""
    out = {}
    for chunk in report.split("\n## ")[1:]:
        title, _, body = chunk.partition("\n")
        out[title] = body.rstrip("\n").splitlines()
    return out


@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    return seeded_logdir(str(tmp_path_factory.mktemp("seeded") / "run"))


@pytest.mark.parametrize("title", SHARED_SECTIONS)
def test_sections_equal_the_reference_line_for_line(logdir, title):
    got = sections(run_report.render_report(logdir))[title]
    # a line that names a source file names the port's package
    want = [line.replace("eksml_tpu/", "eksml_tpu_torch/") for line in
            sections(ref_report.render_report(logdir))[title]]
    if title.startswith("Goodput"):
        # the effective-MFU line reads a prediction (the reference's
        # default is the repository's TPU bank)
        assert got[-1].startswith("Effective MFU:")
        got, want = got[:-1], want[:-1]
    assert got == want
    assert len(got) > 2 and not any("No " in line[:3] for line in got)


def test_every_section_of_the_seeded_logdir_renders_from_its_artifact(
        logdir):
    rep = sections(run_report.render_report(logdir))
    assert "### Segment 2 — started" in "\n".join(rep["Run segments"])
    assert "**non-finite scalar rows: 1**" in "\n".join(rep["Run segments"])
    assert "| 2 (resharded) |" in "\n".join(
        rep["Goodput (whole-run wall-clock ledger)"])
    assert "2 relaunch(es), 2 via the forced-checkpoint path" in "\n".join(
        rep["Autoscaling (operator decision trail)"])
    assert "1 promotion(s), 1 rollback(s) actuated." in "\n".join(
        rep["Deployments (serving hot-reload / canary)"])
    slow = "\n".join(rep["Slow steps (span tracing)"])
    assert "5 step(s) traced across 2 host(s)" in slow
    assert "| 3 | 1 |" in slow and "| data_wait |" in slow


def test_merge_host_traces_equals_the_reference(logdir):
    assert trace_summary.merge_host_traces(logdir) == \
        ref_trace.merge_host_traces(logdir)


def _hang_report(path, frame):
    with open(os.path.join(path, "hang_report_11_1.txt"), "w") as f:
        f.write("stalled phase: train_step\n--- thread MainThread\n"
                '  File "/x/eksml_tpu_torch/train.py", line 900, in fit\n'
                + frame)


def test_hang_reports_point_at_the_lint_item(tmp_path):
    """With a hang report the cross-links name the report, its stalled
    phase and frames, and match them to the port's eksml-lint findings:
    over the clean port tree neither section has a finding to match
    (the hang is not the statically-checkable class); over a tree with a
    seeded ``collective-order`` finding, a stalled frame in a function
    on the finding's chain is a **yes** row.  Without a report there is
    nothing to cross-link, as the reference says."""
    path = str(tmp_path / "run")
    os.makedirs(path)
    _hang_report(path, '  File "/x/torch/distributed/c10d.py", line 12, '
                       "in all_reduce\n")
    rep = sections(run_report.render_report(path))
    spmd = "\n".join(rep["Static SPMD cross-link (watchdog ↔ eksml-lint)"])
    conc = "\n".join(rep["Concurrency cross-link (watchdog ↔ "
                         "eksml-lint v3)"])
    assert "stalled in phase `train_step`" in spmd
    assert "carries 2 stalled stack frame(s)" in conc
    assert "`all_reduce` (c10d.py:12)" in conc
    assert "No static `collective-order` findings in the tree — this " \
        "hang is not the statically-checkable divergence class" in spmd
    assert "No static `lock-order`/`blocking-under-lock` findings in " \
        "the tree — this hang is not the statically-checkable " \
        "thread-topology class" in conc

    tree = tmp_path / "tree" / "eksml_tpu_torch"
    tree.mkdir(parents=True)
    (tree / "__init__.py").write_text("")
    (tree / "comm.py").write_text(
        "import torch.distributed as dist\n\n\n"
        "def gather_all(x):\n"
        "    dist.all_reduce(x)\n"
        "    return x\n\n\n"
        "def log_step(x):\n"
        "    if dist.get_rank() == 0:\n"
        "        return gather_all(x)\n"
        "    return x\n")
    stalled = str(tmp_path / "stalled")
    os.makedirs(stalled)
    _hang_report(stalled, '  File "/x/eksml_tpu_torch/comm.py", line 5, '
                          "in gather_all\n")
    rep = sections(run_report.render_report(
        stalled, lint_root=str(tmp_path / "tree")))
    spmd = rep["Static SPMD cross-link (watchdog ↔ eksml-lint)"]
    assert ("| eksml_tpu_torch/comm.py:11 | eksml_tpu_torch/comm.py:11 "
            "gather_all → eksml_tpu_torch/comm.py:5 all_reduce "
            "| **yes** |") in spmd
    other = str(tmp_path / "other")
    os.makedirs(other)
    _hang_report(other, '  File "/x/eksml_tpu_torch/data/loader.py", '
                        "line 40, in _produce\n")
    rep = sections(run_report.render_report(
        other, lint_root=str(tmp_path / "tree")))
    assert rep["Static SPMD cross-link (watchdog ↔ eksml-lint)"][-1] \
        .endswith("| no |")
    empty = sections(run_report.render_report(str(tmp_path / "none")))
    assert empty["Static SPMD cross-link (watchdog ↔ eksml-lint)"][1] \
        .startswith("No watchdog hang reports in this logdir")


def test_effective_mfu_by_hand_and_a_tpu_prediction_is_a_note(tmp_path):
    art = tmp_path / "art"
    art.mkdir()
    with open(art / "perf_pred_h100_128_b1_replicated_float32.json",
              "w") as f:
        json.dump({"target": "h100", "precision": "float32",
                   "predicted_step_time_ms": 2.0,
                   "totals": {"flops": 26.8e9}}, f)
    got = goodput_report.effective_mfu(0.5, str(art))
    # 26.8e9 FLOP / 2 ms / 67e12 FLOP/s (H100 float32) = 0.2
    assert got["ideal_mfu"] == pytest.approx(0.2)
    assert got["effective_mfu"] == pytest.approx(0.1)
    assert got["prediction"] == \
        "perf_pred_h100_128_b1_replicated_float32.json"
    tpu = tmp_path / "tpu"
    tpu.mkdir()
    shutil.copy(os.path.join(REPO, "artifacts",
                             "perf_pred_128_b1_replicated_bfloat16.json"),
                tpu)
    note = goodput_report.effective_mfu(0.5, str(tpu))
    assert set(note) == {"note"}
    assert "perf_pred_128_b1_replicated_bfloat16.json (v5e)" in \
        note["note"]


def test_an_empty_logdir_names_nothing_of_the_repository_artifacts(
        tmp_path, capsys):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    report = run_report.render_report(empty)
    assert os.path.join(REPO, "artifacts") not in report
    art = os.path.join(REPO, "artifacts")
    for name in os.listdir(art):
        if os.path.isfile(os.path.join(art, name)):
            assert name not in report, name
    assert "No `perf_pred_h100_*.json` prediction and no ladder line" \
        in report
    assert goodput_report.main([empty]) == 0
    assert "no perf_pred_*.json for ['h100'] under " + empty in \
        capsys.readouterr().out


# ---------------------------------------------------------------------
# trace_summary on a capture with device events
# ---------------------------------------------------------------------


def _capture():
    """A hand-written torch.profiler capture: host ranges (the model's
    scopes), their ops, the runtime calls and the kernels they launch."""
    def ev(cat, name, ts, dur, tid=10, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
                "ts": ts, "dur": dur, "args": args}

    def kernel(name, corr, dur, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 1,
                "tid": 7, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    return {"traceEvents": [
        ev("user_annotation", "backbone", 0, 100),
        ev("cpu_op", "aten::convolution", 1, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        ev("user_annotation", "roi_align", 30, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=2),
        ev("user_annotation", "rpn_nms", 60, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 62, 1, correlation=4),
        kernel("implicit_gemm_conv_kernel", 1, 60.0, 200),
        kernel("roi_align_fwd_footprint_kernel", 2, 10.0, 300),
        kernel("nms_kernel", 3, 25.0, 400),
        kernel("implicit_gemm_conv_kernel", 4, 5.0, 500)]}


def test_trace_summary_by_component_from_the_capture_and_its_artifact(
        tmp_path):
    prof = tmp_path / "profile"
    prof.mkdir()
    trace = str(prof / "trace-step2-host0.json")
    with open(trace, "w") as f:
        json.dump(_capture(), f)
    got = trace_summary.summarize(str(prof))
    assert got["total_device_us"] == 100.0
    assert got["component_pct"] == {"backbone": 60.0, "rpn-nms": 30.0,
                                    "roi-fwd": 10.0}
    assert got["family_pct"] == {"conv": 65.0, "nms": 25.0,
                                 "roi_align_fwd": 10.0}
    assert got["top_ops"][0] == {"name": "implicit_gemm_conv_kernel",
                                 "us": 65.0, "pct": 65.0,
                                 "component": "backbone"}
    art = str(prof / "attribution.json")
    write_attribution_artifact(trace, art)
    via = trace_summary.summarize(
        str(prof), component_map=trace_summary.load_component_map(art))
    assert via["component_source"] == "attribution"
    assert via["component_pct"] == got["component_pct"]
    assert trace_summary.main([str(prof), "--hlo", "x.txt"]) == 2
    assert trace_summary.main([str(tmp_path / "nothing")]) == 1


# ---------------------------------------------------------------------
# a real port logdir
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """3 SMOKE steps of ``train.main`` on the CPU with tracing, goodput
    and a one-step capture: ``{"run": its logdir, "prediction": its
    trainer's first-step roofline}``, as ``chip_smoke.observe_main``
    returns them."""
    import chip_smoke
    from eksml_tpu_torch import train
    from eksml_tpu_torch.config import SMOKE_OVERRIDES, config

    run = str(tmp_path_factory.mktemp("port") / "run")
    saved = config.to_dict()
    seen = {}
    try:
        with chip_smoke.keep_prediction(seen):
            rc = train.main([
                "--device", "cpu", "--synthetic", "--logdir", run,
                "--total-steps", "3", "--profile", "1", "--config",
                *SMOKE_OVERRIDES, "TRAIN.BATCH_SIZE_PER_CHIP=1",
                "TRAIN.STEPS_PER_EPOCH=3", "TRAIN.LOG_PERIOD=1",
                "TELEMETRY.PORT=0", "TELEMETRY.TRACING.ENABLED=True",
                "TELEMETRY.GOODPUT.ENABLED=True"])
    finally:
        config.freeze(False)
        config.from_dict(saved)
        config.freeze()
    assert rc == 0 and seen.get("prediction")
    return {"run": run, "prediction": seen["prediction"]}


def test_a_port_run_renders_every_section_from_its_artifacts(port_run,
                                                             tmp_path):
    port_run = port_run["run"]
    for name in ("metrics.jsonl", "events-host0.jsonl",
                 "goodput-host0.jsonl", "trace-host0.json",
                 os.path.join("profile", "attribution.json")):
        assert os.path.exists(os.path.join(port_run, name)), name
    out = str(tmp_path / "report.md")
    assert run_report.main([port_run, "--out", out]) == 0
    with open(out) as f:
        rep = sections(f.read())
    seg = "\n".join(rep["Run segments"])
    assert "### Segment 1" in seg and "step 1 → 3" in seg
    assert "No events-host" not in "\n".join(
        rep["Incident timeline (flight recorder)"])
    slow = "\n".join(rep["Slow steps (span tracing)"])
    assert "3 step(s) traced across 1 host(s)" in slow
    assert "| component | modeled % |" in rep[
        "Modeled cost by component (profile attribution)"]
    goodput = rep["Goodput (whole-run wall-clock ledger)"]
    ledger = build_ledger(port_run)
    ratio = re.search(r"goodput ratio \*\*([0-9.e-]+)\*\*",
                      "\n".join(goodput)).group(1)
    assert float(ratio) == ledger["goodput_ratio"] > 0
    assert goodput[-1].startswith("Effective MFU: no perf_pred_*.json")


def test_chip_smoke_reports_phase_runs_on_the_cpu(port_run, logdir,
                                                  tmp_path):
    """``chip_smoke.phase_reports`` rehearsed on the CPU: perf_gate's rung
    counted here (the plain versions count no launch) and gated against
    the committed bank, then the reports over the port run (its CLI), the
    seeded logdir as the operator's and the fleet's, with seeded ladder
    lines: every section with an artifact renders from it."""
    import chip_smoke
    from eksml_tpu_torch.fsio import atomic_write_json
    from eksml_tpu_torch.ops.roi_align import KERNELS
    from eksml_tpu_torch.profiling.predict import chip_spec

    ladder = str(tmp_path / "ladder")
    os.makedirs(ladder)
    rng = np.random.RandomState(5)
    for label, rung, prec in (("f32", "1344_b4", "float32"),
                              ("bf16_remat", "1344_b4", "bfloat16")):
        step = float(rng.uniform(100, 300))
        atomic_write_json(os.path.join(ladder, f"bench_rung_{label}.json"), {
            "metric": "maskrcnn_r50fpn_train_throughput",
            "operating_point": rung, "precision": prec,
            "value": 4e3 / step, "step_time_ms": step,
            "predicted_step_time_ms": step / 2, "device_kind": "cpu"})
    out = chip_smoke.phase_reports(KERNELS, str(tmp_path), port_run,
                                   [logdir], logdir, ladder, device="cpu")
    assert out["gate"] == "PASS" and out["flops_differ"] == {}
    assert out["calibration"]["n_points"] == 2
    # the run's own roofline, not the gate's 128_b1 record
    pred = port_run["prediction"]
    mfu = out["effective_mfu"]
    assert mfu["prediction"] == "perf_pred_h100_observe_float32.json"
    assert mfu["ideal_mfu"] == round(
        pred["totals"]["flops"] / (pred["predicted_step_time_ms"] / 1e3)
        / chip_spec("h100")["peak_flops"]["float32"], 4)
    assert "Predicted vs measured step time (perf gate)" in \
        out["reports"]["observe"]["sections"]
    for tag in ("operator (run)", "fleet"):
        assert {"Autoscaling (operator decision trail)",
                "Deployments (serving hot-reload / canary)",
                "Communication (predicted per-collective ledger)"} <= set(
            out["reports"][tag]["sections"]), out["reports"][tag]
