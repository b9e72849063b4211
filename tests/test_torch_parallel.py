"""The port's multi-GPU layer, pure functions against the JAX package on
the CPU (no process group): ``plan_mesh`` over a table of strategies,
exchanges, slice and device counts, explicit meshes and each error (the
same ``(shape, axes)``, or the same exception and message);
``_rank_from_env`` and ``config_from_env`` over the JobSet env forms;
``stats_from_matrix``; ``current_topology`` for the same plan;
``param_fingerprint`` component 0 on converted seeded Flax weights
(within 1e-6 relative: both sum in other orders, the port in float64);
the loader's per-slice restride; and the port's own rank arithmetic,
mesh checks and backend rule.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

jax.config.update("jax_platforms", "cpu")

from eksml_tpu import config as j_config  # noqa: E402
from eksml_tpu.config import SMOKE_OVERRIDES  # noqa: E402
from eksml_tpu.data import loader as j_loader  # noqa: E402
from eksml_tpu.models import MaskRCNN as FlaxMaskRCNN  # noqa: E402
from eksml_tpu.parallel import collectives as j_coll  # noqa: E402
from eksml_tpu.parallel import distributed as j_dist  # noqa: E402
from eksml_tpu.parallel import native as j_native  # noqa: E402
from eksml_tpu.parallel import sharding as j_sharding  # noqa: E402
from eksml_tpu.parallel import topology as j_topology  # noqa: E402
from eksml_tpu.parallel.mesh import build_mesh as j_build_mesh  # noqa: E402
from eksml_tpu.telemetry import aggregate as j_aggregate  # noqa: E402
from eksml_tpu_torch import config as t_config  # noqa: E402
from eksml_tpu_torch.convert import from_flax  # noqa: E402
from eksml_tpu_torch.data import loader as t_loader  # noqa: E402
from eksml_tpu_torch.models import MaskRCNN  # noqa: E402
from eksml_tpu_torch.parallel import collectives as t_coll  # noqa: E402
from eksml_tpu_torch.parallel import distributed as t_dist  # noqa: E402
from eksml_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from eksml_tpu_torch.parallel import sharding as t_sharding  # noqa: E402
from eksml_tpu_torch.parallel import topology as t_topology  # noqa: E402
from eksml_tpu_torch.telemetry import aggregate as t_aggregate  # noqa: E402


def _cfg(config_mod, overrides):
    cfg = config_mod.config.clone()
    cfg.freeze(False)
    cfg.update_args(list(overrides) + ["TELEMETRY.PORT=0"])
    cfg.freeze()
    return cfg


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------
# plan_mesh
# ---------------------------------------------------------------------

_PLAN_CASES = [
    (strategy, exchange, slices, n, ())
    for strategy in ("replicated", "fsdp", "tensor", "2d")
    for exchange in ("flat", "hierarchical")
    for slices in (1, 2)
    for n in (1, 2, 4, 8)
] + [
    ("2d", "flat", 1, 8, ("TRAIN.SHARDING.MODEL_AXIS_SIZE=2",)),
    ("2d", "hierarchical", 2, 8, ("TRAIN.SHARDING.MODEL_AXIS_SIZE=2",)),
    ("2d", "flat", 1, 8, ("TRAIN.SHARDING.MODEL_AXIS_SIZE=2",
                          "TRAIN.SHARDING.FSDP_AXIS_SIZE=4")),
    ("fsdp", "flat", 1, 8, ("TRAIN.SHARDING.FSDP_AXIS_SIZE=2",)),
    ("fsdp", "hierarchical", 2, 8, ("TRAIN.SHARDING.FSDP_AXIS_SIZE=2",)),
    ("fsdp", "flat", 1, 8, ("TRAIN.SHARDING.FSDP_AXIS_SIZE=3",)),
    ("tensor", "flat", 1, 8, ("TRAIN.SHARDING.MODEL_AXIS_SIZE=3",)),
    ("replicated", "flat", 1, 4, ("TPU.MESH_SHAPE=(4,1)",)),
    ("fsdp", "flat", 1, 4, ("TPU.MESH_SHAPE=(2,2)",)),
    ("tensor", "flat", 1, 4, ("TPU.MESH_SHAPE=(2,2)",
                              "TPU.MESH_AXES=('data','fsdp')")),
    ("fsdp", "flat", 1, 4, ("TPU.MESH_SHAPE=(1,4,1)",
                            "TPU.MESH_AXES=('data','fsdp','model')")),
    ("bogus", "flat", 1, 4, ()),
    ("fsdp", "ring", 1, 4, ()),
]


@pytest.mark.parametrize("strategy,exchange,slices,n,extra", _PLAN_CASES)
def test_plan_mesh_matches_jax(strategy, exchange, slices, n, extra):
    overrides = [f"TRAIN.SHARDING.STRATEGY={strategy}",
                 f"TRAIN.SHARDING.EXCHANGE={exchange}",
                 f"TPU.NUM_SLICES={slices}", *extra]
    want = _outcome(lambda: j_sharding.plan_mesh(
        _cfg(j_config, overrides), n_devices=n))
    got = _outcome(lambda: t_sharding.plan_mesh(
        _cfg(t_config, overrides), n_devices=n))
    assert got == want


def test_plan_mesh_cases_cover_results_and_errors():
    kinds = {_outcome(lambda c=c: t_sharding.plan_mesh(_cfg(t_config, [
        f"TRAIN.SHARDING.STRATEGY={c[0]}",
        f"TRAIN.SHARDING.EXCHANGE={c[1]}", f"TPU.NUM_SLICES={c[2]}",
        *c[4]]), n_devices=c[3]))[0] for c in _PLAN_CASES}
    assert kinds == {"ok", "ValueError"}


# ---------------------------------------------------------------------
# the JobSet env
# ---------------------------------------------------------------------

_ENVS = [
    {},
    {"PROCESS_ID": "3"},
    {"JOB_COMPLETION_INDEX": "2"},
    {"SLICE_INDEX": "1", "PROCS_PER_SLICE": "4", "JOB_COMPLETION_INDEX": "2"},
    {"SLICE_INDEX": "1", "PROCS_PER_SLICE": "4"},
    {"PROCESS_ID": "5", "SLICE_INDEX": "1"},
    {"SLICE_INDEX": "1", "JOB_COMPLETION_INDEX": "2"},
]


@pytest.mark.parametrize("env", _ENVS)
def test_rank_from_env_matches_jax(env):
    got = _outcome(lambda: t_dist._rank_from_env(env))
    assert got == _outcome(lambda: j_dist._rank_from_env(env))


@pytest.mark.parametrize("env", [e for e in _ENVS if "PROCS_PER_SLICE" in e
                                 or "SLICE_INDEX" not in e])
def test_config_from_env_matches_jax(env, monkeypatch):
    for k in ("PROCESS_ID", "SLICE_INDEX", "PROCS_PER_SLICE",
              "JOB_COMPLETION_INDEX", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "EKSML_DEFAULT_PRECISION", "EKSML_DEFAULT_BATCH_PER_CHIP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(env, COORDINATOR_ADDRESS="maskrcnn-0.svc:1234",
                     NUM_PROCESSES="8").items():
        monkeypatch.setenv(k, v)
    from eksml_tpu.config import config_from_env as j_from_env

    want = j_from_env(j_config.config.clone()).TPU
    got = t_config.config_from_env(t_config.config.clone()).TPU
    for key in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("env,want", [
    ({}, (4, 2)),
    ({"LOCAL_WORLD_SIZE": "8", "LOCAL_RANK": "3"}, (32, 19)),
    ({"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "2"}, ValueError),
])
def test_world_and_rank_compose_host_and_local_rank(env, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="LOCAL_RANK=2"):
            t_dist.world_and_rank(4, 2, env)
    else:
        assert t_dist.world_and_rank(4, 2, env) == want


def test_no_group_without_a_multi_rank_env(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert t_dist.initialize_from_env(device="cpu") is False
    monkeypatch.setenv("NUM_PROCESSES", "2")      # no coordinator address
    assert t_dist.initialize_from_env(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (t_dist.process_count(), t_dist.process_index(),
            t_dist.is_coordinator()) == (1, 0, True)


def test_backend_follows_the_device_and_never_falls_back():
    assert t_dist.backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs the NCCL backend"):
            t_dist.backend_for("cuda")


# ---------------------------------------------------------------------
# mesh, topology, aggregation, combine threshold
# ---------------------------------------------------------------------


def test_mesh_checks_and_slice_groups():
    assert t_mesh.divisors(8) == [1, 2, 4, 8]
    assert t_mesh.mesh_shape_for((), ("data", "model"), 8) == (
        (8, 1), ("data", "model"))
    with pytest.raises(ValueError, match="must equal the world size"):
        t_mesh.mesh_shape_for((4, 1), ("data", "model"), 8)
    with pytest.raises(ValueError, match="same length"):
        t_mesh.mesh_shape_for((8,), ("data", "model"), 8)
    with pytest.raises(ValueError, match="does not split over 2 slices"):
        t_mesh.mesh_shape_for((3, 2), ("data", "model"), 6, num_slices=2)
    with pytest.raises(ValueError, match="must equal the slice count"):
        t_mesh.mesh_shape_for((4, 2, 1), ("slice", "fsdp", "model"), 8,
                              num_slices=2)
    assert t_mesh.slice_groups(8, 1) is None
    assert t_mesh.slice_groups(8, 2) == {0: [0, 1, 2, 3], 1: [4, 5, 6, 7]}
    with pytest.raises(ValueError, match="names a TPU slice"):
        t_mesh.check_topology("v5e-8")


@pytest.mark.parametrize("strategy,exchange,slices,n", [
    ("replicated", "flat", 1, 1), ("replicated", "flat", 1, 8),
    ("fsdp", "flat", 1, 8), ("fsdp", "flat", 2, 8),
    ("fsdp", "hierarchical", 2, 8), ("fsdp", "flat", 1, 1)])
def test_current_topology_matches_jax(strategy, exchange, slices, n):
    overrides = [f"TRAIN.SHARDING.STRATEGY={strategy}",
                 f"TRAIN.SHARDING.EXCHANGE={exchange}",
                 f"TPU.NUM_SLICES={slices}"]
    shape, axes = j_sharding.plan_mesh(_cfg(j_config, overrides),
                                       n_devices=n)
    mesh = j_build_mesh(shape, axes, devices=jax.devices()[:n],
                        num_slices=slices)
    want = j_topology.current_topology(
        mesh, j_sharding.ShardingPlan(strategy, mesh, exchange=exchange),
        num_slices=slices)
    tshape, taxes = t_mesh.mesh_shape_for(*t_sharding.plan_mesh(
        _cfg(t_config, overrides), n_devices=n), n, slices)
    plan = t_sharding.ShardingPlan(strategy, None, tshape, taxes,
                                   exchange=exchange)
    got = t_topology.current_topology("cpu", plan, None, slices)
    assert {k: got[k] for k in want} == want
    assert got["device_kind"] == "cpu"


def test_stats_from_matrix_matches_jax():
    rng = np.random.RandomState(0)
    m = rng.rand(3, len(j_aggregate.HOST_AGG_KEYS)) * 100
    assert t_aggregate.HOST_AGG_KEYS == j_aggregate.HOST_AGG_KEYS
    assert t_aggregate.stats_from_matrix(m) == j_aggregate.stats_from_matrix(m)
    values = {"step_time_ms": 3.5, "quarantined": 2}
    np.testing.assert_array_equal(t_aggregate.host_vector(values),
                                  j_aggregate.host_vector(values))
    # without a group the aggregate is this rank's own row
    row = t_aggregate.aggregate_host_scalars(values)
    assert row == j_aggregate.stats_from_matrix(
        j_aggregate.host_vector(values)[None])


@pytest.mark.parametrize("param_bytes,chips", [
    (180 << 20, 1), (180 << 20, 512), (1 << 20, 8), (4 << 30, 8)])
def test_recommend_combine_threshold_matches_jax(param_bytes, chips):
    assert t_coll.recommend_combine_threshold(param_bytes, chips) == \
        j_native.recommend_combine_threshold(param_bytes, chips)


# ---------------------------------------------------------------------
# the replica fingerprint
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def flax_params():
    cfg = _cfg(j_config, list(SMOKE_OVERRIDES) + [
        "PREPROC.DEVICE_NORMALIZE=False"])
    batch = j_loader.make_synthetic_batch(cfg, batch_size=1, image_size=128,
                                          seed=7, gt_mask_size=28)
    batch = {k: jnp.asarray(v) for k, v in batch.items()
             if k not in ("image_scale", "image_id")}
    model = FlaxMaskRCNN.from_config(cfg)
    key = jax.random.PRNGKey(3)
    return jax.device_get(
        jax.jit(lambda r, b: model.init(r, b, r))(key, batch)["params"])


def test_param_fingerprint_matches_jax(flax_params):
    want = float(j_coll.param_fingerprint(flax_params)[0])
    sd = from_flax(flax_params)
    model = MaskRCNN.from_config(_cfg(t_config, SMOKE_OVERRIDES))
    model.load_state_dict(sd)
    assert set(model.state_dict()) == set(sd)
    for state in (sd, model.state_dict()):
        got = float(t_coll.param_fingerprint(state)[0])
        assert got == pytest.approx(want, rel=1e-6)
    # position-sensitive: swapping two values of one leaf moves it
    swapped = dict(sd)
    w = sd["fpn.lateral_2.weight"].contiguous().clone()
    w.view(-1)[[0, 1]] = w.view(-1)[[1, 0]]
    swapped["fpn.lateral_2.weight"] = w
    assert float(t_coll.param_fingerprint(swapped)[0]) != got


def test_param_fingerprint_carries_the_generator_state_exactly(flax_params):
    sd = from_flax(flax_params)
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    fp = t_coll.param_fingerprint(sd, state)
    words = state.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert fp.numel() == 1 + 2 * words.numel()
    halves = fp[1:].to(torch.int64).reshape(2, -1)
    assert torch.equal(halves[0] * 65536 + halves[1], words)
    gen.manual_seed(12)
    assert not torch.equal(t_coll.param_fingerprint(sd, gen.get_state()), fp)
    # without a group the check passes on its own state
    assert t_coll.assert_replicas_in_sync(sd, state) is True
    assert t_coll.cross_host_sum({"a": 2.0})["a"] == 2.0


# ---------------------------------------------------------------------
# the loader's shard of the records
# ---------------------------------------------------------------------


@pytest.mark.parametrize("num_hosts,num_slices", [(4, 1), (4, 2), (8, 2),
                                                  (6, 4)])
def test_loader_shards_match_jax(num_hosts, num_slices):
    cfg_j = _cfg(j_config, SMOKE_OVERRIDES)
    cfg_t = _cfg(t_config, SMOKE_OVERRIDES)
    records = t_loader.SyntheticDataset(num_images=24, height=32, width=32,
                                        num_classes=5).records()
    seen = []
    for host in range(num_hosts):
        want = j_loader.DetectionLoader(
            records, cfg_j, 1, num_hosts=num_hosts, host_id=host,
            num_slices=num_slices, prefetch=1).records
        got = t_loader.DetectionLoader(
            records, cfg_t, 1, num_hosts=num_hosts, host_id=host,
            num_slices=num_slices).records
        assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
        seen += [r["image_id"] for r in got]
    assert sorted(seen) == list(range(24))


# ---------------------------------------------------------------------
# the entry point as two gloo ranks
# ---------------------------------------------------------------------


def test_entry_point_two_ranks_agree_on_sigterm(tmp_path):
    """``python -m eksml_tpu_torch.train --device cpu`` as two ranks of
    one host (``LOCAL_WORLD_SIZE``/``LOCAL_RANK``) under ``fsdp``: SIGTERM
    to rank 1 alone makes both ranks commit one forced checkpoint and
    exit 77 at the same step, with the same losses logged before."""
    import re
    import signal
    import socket
    import subprocess
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    run = tmp_path / "run"
    argv = [sys.executable, "-m", "eksml_tpu_torch.train", "--device", "cpu",
            "--synthetic", "--logdir", str(run), "--total-steps", "200",
            "--config", *SMOKE_OVERRIDES, "TELEMETRY.PORT=0",
            "TRAIN.NUM_CHIPS=2",
            "TRAIN.BATCH_SIZE_PER_CHIP=1", "TRAIN.STEPS_PER_EPOCH=200",
            "TRAIN.CHECKPOINT_PERIOD=1", "TRAIN.LOG_PERIOD=1",
            "RESILIENCE.PREEMPT_SYNC_PERIOD=1",
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
        deadline = time.monotonic() + 240
        while "step 2/200" not in logs[1].read_text():
            assert time.monotonic() < deadline, logs[1].read_text()[-3000:]
            assert procs[1].poll() is None, logs[1].read_text()[-3000:]
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [path.read_text() for path in logs]
    assert codes == [77, 77], [t[-3000:] for t in texts]
    stops = [int(re.search(r"preempted at step (\d+)", t).group(1))
             for t in texts]
    assert stops[0] == stops[1] >= 2
    losses = [re.findall(r"step (\d+)/200 loss=(\S+)", t) for t in texts]
    assert losses[0] == losses[1] and len(losses[0]) == stops[0]
    ckpts = sorted(n for n in os.listdir(run / "checkpoints") if n.isdigit())
    assert ckpts[-1] == str(stops[0])
    assert {"events-host0.jsonl", "events-host1.jsonl",
            "metrics.jsonl"} <= set(os.listdir(run))


def test_plan_without_a_group_runs_the_plain_model():
    """No process group: the plan wraps nothing, describes the reference's
    strings and explains every tensor as replicated."""
    cfg = _cfg(t_config, list(SMOKE_OVERRIDES) + [
        "TRAIN.SHARDING.STRATEGY=fsdp"])
    plan = t_sharding.ShardingPlan.from_config(cfg)
    assert plan.mesh is None
    assert (plan.mesh_shape, plan.mesh_axes) == ((1, 1, 1),
                                                 ("data", "fsdp", "model"))
    assert plan.describe() == "fsdp(axis=1, rules=1)"
    model = MaskRCNN.from_config(cfg)
    assert plan.wrap(model) is model
    # the gradients stay whole, so the global norm sums them on no group
    assert not any(hasattr(p, "to_local") for p in model.parameters())
    text = plan.explain(model)
    assert text.count("replicated") == len(model.state_dict())
    assert t_sharding.tree_bytes_per_device(model.state_dict()) == sum(
        t.numel() * 4 for t in model.state_dict().values())


def test_chip_smoke_dist_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s train and dist phases at SMOKE widths on the
    CPU (a gloo group of one rank; the wrappers take their plain
    versions, counted here as the kernels would be): the same launches
    per step under DDP, FSDP2, ``tensor`` and ``2d``, step-1 losses equal
    to the plain phase's, the FSDP2 checkpoint restored bitwise without a
    group."""
    import chip_smoke

    import eksml_tpu_torch.device as t_device
    import eksml_tpu_torch.train as t_train
    from eksml_tpu_torch.ops.cuda import roi_align_kernel
    from eksml_tpu_torch.ops.roi_align import KERNELS

    monkeypatch.setattr(chip_smoke, "BATCH", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 2)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cpu = lambda device="cuda": torch.device("cpu")  # noqa: E731
    monkeypatch.setattr(t_device, "resolve_device", cpu)
    monkeypatch.setattr(t_train, "resolve_device", cpu)

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
    cfg = _cfg(t_config, list(SMOKE_OVERRIDES) + [
        "TRAIN.LOG_PERIOD=1", "TRAIN.BATCH_SIZE_PER_CHIP=2"])
    trainer, _, train = chip_smoke.phase_train(cfg, KERNELS, 0,
                                               str(tmp_path / "train"))
    trainer.close()
    out = chip_smoke.phase_dist(cfg, KERNELS, 0, train, str(tmp_path),
                                device="cpu")
    assert not torch.distributed.is_initialized()
    for strategy, _ in chip_smoke.DIST_STRATEGIES:
        rec = out[strategy]
        assert rec["loss_rel_diff_step1"] == 0.0
        assert rec["launches"] == {"roi_align_fwd": 6, "roi_align_bwd": 4,
                                   "copy_to_global": 16}
    assert [s for s, _ in chip_smoke.DIST_STRATEGIES] == [
        "replicated", "fsdp", "tensor", "2d"]
    assert out["fsdp"]["plan"] == "fsdp(axis=1, rules=1)"
    assert out["tensor"]["plan"] == "tensor(model=1, rules=2)"
    assert out["2d"]["plan"] == "2d(fsdp=1, model=1, rules=2)"
