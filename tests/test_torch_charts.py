"""The port's GPU charts (``charts/{maskrcnn,serve,autoscaler}-gpu``) as the
port's renderer (``eksml_tpu_torch.tools.render_charts``) renders them.

The committed goldens are the render byte for byte; no manifest names the
TPU, the JAX env or the JAX package; the JobSet's layout follows ``gpus``
and ``gpus_per_node``; and every rendered command parses through the
port's own parsers, with its ``--config`` items through
``config.update_args`` and ``finalize_configs`` (the port's
values-config-sync, over both training overlays).
"""

import os
import re

import pytest
import yaml

from eksml_tpu_torch import config as t_config
from eksml_tpu_torch import launch as t_launch
from eksml_tpu_torch import train as t_train
from eksml_tpu_torch.serve import __main__ as t_serve
from eksml_tpu_torch.tools import eksml_operator as t_op
from eksml_tpu_torch.tools import render_charts as rc

TRAIN_CHART = "charts/maskrcnn-gpu"
OVERLAYS = ((), ("values-optimized.yaml",), ("values-cascade-r101.yaml",))
TPU_ONLY = ("google.com/tpu", "LIBTPU_INIT_ARGS", "XLA_FLAGS",
            "TPU_STDERR_LOG_LEVEL", "JAX_COMPILATION_CACHE_DIR", "gke-tpu")


def docs_of(text):
    return [d for d in yaml.safe_load_all(text) if d]


def pod_specs(docs):
    """(kind, pod spec) of every workload in ``docs``."""
    out = []
    for d in docs:
        if d["kind"] == "JobSet":
            for job in d["spec"]["replicatedJobs"]:
                out.append((d, job["template"]["spec"]["template"]["spec"]))
        elif d["kind"] == "Deployment":
            out.append((d, d["spec"]["template"]["spec"]))
    return out


def jobset(docs):
    (js,) = [d for d in docs if d["kind"] == "JobSet"]
    return js


def container(spec):
    (c,) = spec["containers"]
    return c


@pytest.fixture
def fresh_config():
    """The global config, restored after the test."""
    cfg = t_config.config
    saved = cfg.to_dict()
    cfg.freeze(False)
    yield cfg
    cfg.freeze(False)
    cfg.from_dict(saved)
    cfg.freeze()


def finalize(cfg, items, training):
    cfg.freeze(False)
    cfg.from_dict(SAVED_DEFAULTS)
    cfg.update_args(items)
    return t_config.finalize_configs(is_training=training, cfg=cfg)


SAVED_DEFAULTS = t_config.config.to_dict()


@pytest.mark.parametrize("name", sorted(rc.GOLDENS))
def test_goldens_equal_the_render(name):
    chart, files = rc.GOLDENS[name]
    text = rc.render(chart, files)
    with open(os.path.join(rc.REPO, rc.GOLDEN_DIR, name)) as f:
        assert f.read() == text
    docs = docs_of(text)
    assert docs and all("kind" in d and "apiVersion" in d for d in docs)
    for token in TPU_ONLY:
        assert token not in text, token
    assert not re.search(r"\bTPU\.", text)
    assert not re.search(r"\beksml_tpu\b", text)     # eksml_tpu_torch only
    assert "eksml_tpu_torch." in text
    for _, spec in pod_specs(docs):
        # a pod on GPU nodes tolerates their taint; the operator owns none
        if "nvidia.com/gpu" in container(spec).get("resources", {}).get(
                "limits", {}):
            assert {"key": "nvidia.com/gpu", "operator": "Exists",
                    "effect": "NoSchedule"} in spec["tolerations"]


@pytest.mark.parametrize("gpus,per", [(16, 8), (8, 8), (32, 8), (1, 1),
                                      (4, 2)])
def test_the_jobset_layout_follows_gpus_and_gpus_per_node(gpus, per):
    docs = docs_of(rc.render(TRAIN_CHART, overrides={
        "maskrcnn.gpus": gpus, "maskrcnn.gpus_per_node": per}))
    js = jobset(docs)
    (job,) = js["spec"]["replicatedJobs"]
    spec = job["template"]["spec"]
    assert spec["parallelism"] == spec["completions"] == gpus // per
    pod = spec["template"]["spec"]
    c = container(pod)
    for side in ("requests", "limits"):
        assert c["resources"][side] == {"nvidia.com/gpu": per}
    env = {e["name"]: e.get("value") for e in c["env"]}
    assert env["NUM_PROCESSES"] == str(gpus // per)
    assert env["COORDINATOR_ADDRESS"].startswith(
        f"{js['metadata']['name']}-node-0-0.")
    assert env["NCCL_MIN_NCHANNELS"] == "8" and env["NCCL_DEBUG"] == "INFO"
    cmd = c["command"]
    assert cmd[:3] == ["python3", "-m", "eksml_tpu_torch.launch"]
    args = t_launch.parse_args(cmd[3:])
    assert args.nproc_per_node == per and args.module == "eksml_tpu_torch.train"
    assert args.stop_budget < pod["terminationGracePeriodSeconds"]
    assert args.preempt_exit_code == 77 == \
        spec["podFailurePolicy"]["rules"][0]["onExitCodes"]["values"][0]
    items = t_train.parse_args(args.args).config
    assert f"TRAIN.NUM_CHIPS={gpus}" in items
    assert f"TRAIN.CHIPS_PER_HOST={per}" in items
    assert {"name": "dshm", "emptyDir": {"medium": "Memory"}} in \
        pod["volumes"]


@pytest.mark.parametrize("gpus,per", [(12, 8), (4, 8), (8, 0)])
def test_uneven_layouts_fail_the_render(gpus, per):
    with pytest.raises(rc.RenderError, match="gpus"):
        rc.render(TRAIN_CHART, overrides={"maskrcnn.gpus": gpus,
                                          "maskrcnn.gpus_per_node": per})


@pytest.mark.parametrize("files", OVERLAYS, ids=lambda f: f[0] if f else
                         "values.yaml")
def test_the_training_argv_parses_and_finalizes(files, fresh_config):
    docs = docs_of(rc.render(TRAIN_CHART, files))
    cmd = container(pod_specs(docs)[0][1])["command"]
    args = t_train.parse_args(t_launch.parse_args(cmd[3:]).args)
    assert args.logdir.startswith("/efs/") and args.device == "cuda"
    cfg = finalize(fresh_config, args.config, training=True)
    assert not any(k.startswith("TPU.") for k in
                   (i.split("=", 1)[0] for i in args.config))
    assert cfg.TRAIN.NUM_CHIPS == 16 and cfg.DATA.TRAIN == ["train2017"]
    assert cfg.TRAIN.STEPS_PER_EPOCH == 120000 // (
        16 * cfg.TRAIN.BATCH_SIZE_PER_CHIP)
    if files == ("values-optimized.yaml",):
        assert (cfg.TRAIN.PRECISION, cfg.TRAIN.BATCH_SIZE_PER_CHIP,
                cfg.TRAIN.REMAT, cfg.TRAIN.GRADIENT_CLIP) == (
            "bfloat16", 4, True, 0.36)
        assert len(cfg.PREPROC.BUCKETS) == 3
    if files == ("values-cascade-r101.yaml",):
        assert cfg.MODE_CASCADE and \
            tuple(cfg.BACKBONE.RESNET_NUM_BLOCKS) == (3, 4, 23, 3)


def test_the_serve_argv_parses_and_finalizes(fresh_config):
    docs = docs_of(rc.render("charts/serve-gpu"))
    tracks = {}
    for d, spec in pod_specs(docs):
        c = container(spec)
        assert c["resources"]["limits"] == {"nvidia.com/gpu": 1}
        assert "nodeSelector" not in spec
        cmd = c["command"]
        assert cmd[:3] == ["python3", "-m", "eksml_tpu_torch.serve"]
        args = t_serve.build_parser().parse_args(cmd[3:])
        cfg = finalize(fresh_config, args.config, training=False)
        assert cfg.TRAIN.PRECISION == "bfloat16"
        tracks[args.serve_id] = cfg.SERVE.RELOAD_POLL_SEC
    assert tracks == {"stable": 0, "canary": 30}
    (hpa,) = [d for d in docs if d["kind"] == "HorizontalPodAutoscaler"]
    assert hpa["spec"]["metrics"][0]["pods"]["metric"]["name"] == \
        "eksml_serve_queue_depth"


def test_the_operator_argv_parses_and_scales_the_training_jobset(
        fresh_config):
    docs = docs_of(rc.render("charts/autoscaler-gpu"))
    (dep,) = [d for d in docs if d["kind"] == "Deployment"]
    cmd = container(dep["spec"]["template"]["spec"])["command"]
    assert cmd[:3] == ["python3", "-m", "eksml_tpu_torch.tools.eksml_operator"]
    args = t_op.build_parser().parse_args(cmd[3:])
    assert args.mode == "kubectl"
    assert args.capacity_resource == "nvidia.com/gpu"
    cfg = finalize(fresh_config, args.config, training=True)
    train = jobset(docs_of(rc.render(TRAIN_CHART)))
    assert args.jobset == train["metadata"]["name"]
    assert args.namespace == train["metadata"]["namespace"] == \
        dep["metadata"]["namespace"]
    per = rc.chart_values(TRAIN_CHART)["maskrcnn"]["gpus_per_node"]
    options = tuple(cfg.RESILIENCE.AUTOSCALE.CHIP_OPTIONS)
    assert options == (8, 16) and all(n % per == 0 for n in options)
    kinds = {d["kind"] for d in docs}
    assert {"ServiceAccount", "ClusterRole", "Role", "RoleBinding"} <= kinds


def test_set_values_types_like_helm():
    vals = rc.set_values({"a": {"b": 1, "c": "x"}},
                         {"a.b": "8", "a.d.e": "true", "a.c": ""})
    assert vals == {"a": {"b": 8, "c": "", "d": {"e": True}}}
