"""The port's profile attribution (``eksml_tpu_torch/profiling``) held to
the JAX package's (``eksml_tpu/profiling``): the scope rules and their
resolution on the same op paths, the scope names each package opens,
the attribution of a hand-written ``torch.profiler`` Chrome trace
(launch joins, the backward through the autograd sequence numbers,
NCCL, the ``other`` bucket) and the live memory gauges.
"""

import ast
import json
import os
import sys

import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu.profiling import attribution as j_attr  # noqa: E402
from eksml_tpu.profiling import memory as j_memory  # noqa: E402
from eksml_tpu_torch import telemetry  # noqa: E402
from eksml_tpu_torch.profiling import attribution as t_attr  # noqa: E402
from eksml_tpu_torch.profiling import memory as t_memory  # noqa: E402
from eksml_tpu_torch.profiling import named_scope  # noqa: E402
from eksml_tpu_torch.telemetry.registry import MetricRegistry  # noqa: E402

# the reference's spellings (flax module paths, transform labels) and
# the port's (record_function paths, transpose(...) for the backward)
OP_PATHS = (
    "jit(train_step)/jit(main)/jvp(MaskRCNN)/backbone/group0/conv",
    "jit(train_step)/jit(main)/transpose(jvp(MaskRCNN))/backbone/group0/conv",
    "jit(x)/jvp(MaskRCNN)/roi_align/gather",
    "jit(x)/transpose(jvp(MaskRCNN))/roi_align/scatter",
    "jit(t)/jvp(MaskRCNN)/MaskRCNN._proposals/vmap(rpn_nms)/vmap(nms)/sub",
    "jit(t)/transpose(jvp(MaskRCNN))/fpn/posthoc_2/conv",
    "jit(t)/jvp(MaskRCNN)/maskrcnn/fcn0/conv",
    "jit(t)/optimizer/add",
    "unknown/thing",
    "",
    "backbone", "transpose(backbone)", "fpn", "transpose(fpn)",
    "rpn", "transpose(rpn)", "rpn_nms/nms", "matching", "sampling",
    "rpn_loss", "transpose(rpn_loss)", "frcnn_loss", "mask_loss",
    "input_norm", "mask_targets/roi_align", "transpose(roi_align)",
    "fastrcnn", "transpose(fastrcnn)", "cascade0", "transpose(cascade2)",
    "maskrcnn", "transpose(maskrcnn)", "optimizer", "transpose()",
    "Optimizer.step#SGD.step", "roi_align_x", "backbones/fpnx",
)


def test_scope_rules_are_the_reference():
    assert t_attr.SCOPE_RULES == j_attr.SCOPE_RULES
    for op in sorted(j_attr._COLLECTIVE_OPS) + ["add", "convolution", ""]:
        assert t_attr.is_collective_opcode(op) == \
            j_attr.is_collective_opcode(op), op


@pytest.mark.parametrize("path", OP_PATHS)
def test_resolve_component_equals_the_reference(path):
    assert t_attr.resolve_component(path) == j_attr.resolve_component(path)
    assert t_attr.resolve_component(path, "all-reduce") == \
        j_attr.resolve_component(path, "all-reduce") == "allreduce"


def _scope_names(package: str, call: str):
    """Every literal name passed to ``<call>(...)`` in a package (an
    f-string's placeholders read as 0: ``cascade{i}`` → ``cascade0``)."""
    names = set()
    for root, _, files in os.walk(os.path.join(REPO, package)):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(root, fn)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                func = node.func
                name = (func.attr if isinstance(func, ast.Attribute)
                        else getattr(func, "id", None))
                if name != call:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    names.add(arg.value)
                elif isinstance(arg, ast.JoinedStr):
                    names.add("".join(
                        v.value if isinstance(v, ast.Constant) else "0"
                        for v in arg.values))
    return names


def test_every_scope_the_port_opens_resolves_as_the_reference():
    """The port opens every ``jax.named_scope`` name of the reference and
    one range per top-level module under its flax name; each resolves to
    a component under ``SCOPE_RULES``."""
    ported = _scope_names("eksml_tpu_torch", "named_scope")
    reference = _scope_names("eksml_tpu", "named_scope")
    assert reference <= ported, reference - ported
    modules = {"backbone", "fpn", "rpn", "fastrcnn", "cascade0", "maskrcnn"}
    assert ported == reference | modules, ported ^ (reference | modules)
    for name in sorted(ported):
        comp = t_attr.resolve_component(name)
        assert comp is not None and comp == j_attr.resolve_component(name), \
            name


def _ev(cat, name, ts, dur, tid=10, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": float(ts), "dur": float(dur), "args": args}


def _launch(ts, corr, tid=10, driver=False):
    return _ev("cuda_driver" if driver else "cuda_runtime",
               "cuLaunchKernel" if driver else "cudaLaunchKernel", ts, 2,
               tid=tid, correlation=corr)


def _kernel(name, corr, dur, ext=None):
    args = {"correlation": corr}
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": 1000.0 + corr, "dur": float(dur), "args": args}


BWD = t_attr.BACKWARD_OP_PREFIX
TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "x"}},
    # forward, main thread 10
    _ev("user_annotation", "backbone", 0, 100, **{"External id": 1}),
    _ev("cpu_op", "aten::conv2d", 10, 40, **{"Sequence number": 5,
                                             "Fwd thread id": 0}),
    _ev("cpu_op", "aten::convolution", 12, 30),
    _launch(20, 100),
    _ev("user_annotation", "roi_align", 110, 40),
    _ev("cpu_op", "RoiAlignFunction", 115, 25, **{"Sequence number": 6,
                                                  "Fwd thread id": 0}),
    _launch(120, 101, driver=True),
    _ev("user_annotation", "mask_targets", 160, 40),
    _ev("user_annotation", "roi_align", 165, 30),
    _launch(170, 102),
    _ev("user_annotation", "optimizer", 500, 50, **{"External id": 9}),
    # backward, the autograd engine's thread 20
    _ev("cpu_op", f"{BWD} ConvolutionBackward0", 300, 100, tid=20,
        **{"Sequence number": 5, "Fwd thread id": 1}),
    _ev("cpu_op", "ConvolutionBackward0", 301, 98, tid=20,
        **{"Sequence number": 5, "Fwd thread id": 1}),
    _launch(310, 103, tid=20),
    _ev("cpu_op", f"{BWD} RoiAlignFunctionBackward", 410, 40, tid=20,
        **{"Sequence number": 6, "Fwd thread id": 1}),
    _launch(415, 104, tid=20),
    _launch(420, 105, tid=20),
    # a recompute inside the backward reuses number 5 on its own
    # thread's counter: never a forward candidate
    _ev("cpu_op", f"{BWD} ReluBackward0", 455, 30, tid=20,
        **{"Sequence number": 7, "Fwd thread id": 1}),
    _ev("cpu_op", "aten::conv2d", 460, 10, tid=20,
        **{"Sequence number": 5, "Fwd thread id": 0}),
    _launch(462, 106, tid=20),
    # device side
    _kernel("implicit_gemm", 100, 30.0),
    _kernel("roi_align_fwd_footprint_kernel", 101, 10.0),
    _kernel("roi_align_fwd_footprint_kernel", 102, 2.0),
    _kernel("dgrad_kernel", 103, 40.0),
    _kernel("roi_align_bwd_footprint_kernel", 104, 8.0),
    _kernel("copy_bulk_kernel", 105, 6.0),
    _kernel("recompute_kernel", 106, 4.0),
    _kernel("sgd_kernel", 900, 5.0, ext=9),          # External id only
    _kernel("ncclDevKernel_AllReduce_Sum_f32", 901, 20.0),
    _kernel("orphan_kernel", 902, 25.0),              # no join at all
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
     "tid": 7, "ts": 5.0, "dur": 0.0, "args": {"correlation": 100}},
]}


def test_trace_attribution_of_a_hand_written_capture(tmp_path):
    attr = t_attr.TraceAttribution(TRACE)
    assert attr.kernel_map() == {
        "implicit_gemm": {"backbone": 0.03},
        "roi_align_fwd_footprint_kernel": {"roi-fwd": 0.012},
        "dgrad_kernel": {"backbone-bwd": 0.04},
        "roi_align_bwd_footprint_kernel": {"roi-bwd": 0.008},
        "copy_bulk_kernel": {"roi-bwd": 0.006},
        # the recompute runs inside ReluBackward0, whose forward op
        # (number 7) the capture does not hold
        "recompute_kernel": {"other": 0.004},
        "sgd_kernel": {"optimizer": 0.005},
        "ncclDevKernel_AllReduce_Sum_f32": {"allreduce": 0.02},
        "orphan_kernel": {"other": 0.025},
        "Memcpy HtoD": {"backbone": 0.0},
    }
    table = attr.component_table(top_n=3)
    assert table["basis"] == "device"
    assert table["device_total_ms"] == pytest.approx(0.15)
    assert table["other_pct"] == pytest.approx(100 * 0.029 / 0.15, abs=0.01)
    assert table["unlinked_device_events"] == 1
    assert [k["name"] for k in table["top_kernels"]] == [
        "dgrad_kernel", "implicit_gemm", "orphan_kernel"]
    assert table["host"]["component_pct"]["backbone"] > 0
    # the artifact: written whole, the trace read back from its path
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump(TRACE, f)
    out = str(tmp_path / "attribution.json")
    payload = t_attr.write_attribution_artifact(path, out,
                                                extra={"steps": [2, 3]})
    assert not os.path.exists(out + ".tmp")
    with open(out) as f:
        assert json.load(f) == payload
    assert payload["steps"] == [2, 3]
    assert payload["map"] == attr.kernel_map()


def test_cpu_capture_names_backward_ops_by_their_forward_scope():
    """A real CPU capture: forward ops under their ranges, backward ops
    (the autograd engine's, on the same thread here) on ``-bwd`` through
    their sequence numbers, decorated ranges reentrant."""
    from torch.profiler import profile

    @named_scope("nms")
    def nested(x, depth):
        return x if depth == 0 else nested(x * 2, depth - 1)

    conv = torch.nn.Conv2d(3, 4, 3)
    x = torch.randn(1, 3, 8, 8)
    with profile() as prof:
        with named_scope("backbone"):
            y = torch.relu(conv(x))
        with torch.no_grad(), named_scope("rpn_nms"):
            nested(y, 2)
        with named_scope("rpn_loss"):
            loss = y.square().mean()
        loss.backward()
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        attr = t_attr.TraceAttribution(path)
    host = attr.host_ms()
    for comp in ("backbone", "backbone-bwd", "rpn-nms", "loss"):
        assert host.get(comp, 0) > 0, (comp, host)
    names = [h.name for h in attr.hosts if h.cat == "user_annotation"]
    assert names.count("nms") == 3
    bwd = [h for h in attr.hosts if h.backward]
    assert {attr.component_of(h) for h in bwd
            if "Convolution" in h.name} == {"backbone-bwd"}


def test_hbm_gauges_as_the_reference(monkeypatch):
    assert (t_memory.HBM_IN_USE_GAUGE, t_memory.HBM_PEAK_GAUGE) == \
        (j_memory.HBM_IN_USE_GAUGE, j_memory.HBM_PEAK_GAUGE)
    reg = MetricRegistry()
    assert t_memory.publish_hbm_gauges("cpu", reg) is None
    assert not reg.collect()
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {
        "allocated_bytes.all.current": 123, "allocated_bytes.all.peak": 456})
    assert t_memory.publish_hbm_gauges("cuda:0", reg) == {
        "bytes_in_use": 123, "peak_bytes": 456}
    text = telemetry.render_openmetrics(reg)
    assert "eksml_train_hbm_bytes_in_use 123" in text
    assert "eksml_train_hbm_peak_bytes 456" in text

    def broken(d):
        raise RuntimeError("no allocator")

    monkeypatch.setattr(torch.cuda, "memory_stats", broken)
    assert t_memory.publish_hbm_gauges("cuda:0", reg) is None
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {})
    assert t_memory.publish_hbm_gauges("cuda:0", reg) is None
