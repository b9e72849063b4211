"""Configuration tree with dotted KEY=VALUE overrides.

The port's own copy of ``eksml_tpu/config.py``: the same keys, defaults
and ``finalize_configs`` checks, so one override list configures both
packages.  It differs in two places: the sharding-strategy inventory is a
local tuple (the JAX package keeps it in its sharding module), and
``config_from_env`` composes the host rank with the port's own
``parallel/distributed._rank_from_env``.


Re-creates the config UX of the reference stack: TensorPack's
``train.py --config KEY=VALUE`` dotted-path override system, which the
Helm charts render into argv (reference:
charts/maskrcnn/templates/maskrcnn.yaml:60-72, run.sh:33-45) and the viz
notebooks mutate in-process (container-viz/notebooks/
mask-rcnn-tensorpack-viz.ipynb cell 9).  The default key names below are
kept compatible with the ones the reference charts set (MODE_MASK,
MODE_FPN, DATA.*, BACKBONE.*, TRAIN.*, TRAINER) so a values.yaml written
for the reference maps 1:1, while TPU-specific knobs live under ``TPU.*``
(mesh shape, XLA collective-combine thresholds — the analogue of the
HOROVOD_FUSION_THRESHOLD / NCCL_MIN_NRINGS env tuning at
charts/maskrcnn/values.yaml:24-28).

Design is TPU-first: everything that shapes a compiled program (image
size, proposal counts, batch size) is a *static* config value, because
XLA traces once — there is no dynamic-shape escape hatch like the
reference's variable-size dataflow.
"""

from __future__ import annotations

import ast
import copy
import json
import os
import pprint
from typing import Any, Iterable, List


class AttrDict:
    """Nested attribute dictionary with freeze semantics.

    Access creates nested nodes on the fly until :meth:`freeze` is
    called; afterwards unknown keys raise.  This mirrors the behavior of
    the reference's config object so ``--config`` typos fail loudly.
    """

    _frozen = False

    def __getattr__(self, name: str) -> Any:
        if self._frozen:
            raise AttributeError(f"unknown config key: {name}")
        if name.startswith("_"):
            raise AttributeError(name)
        node = AttrDict()
        object.__setattr__(self, name, node)
        return node

    def __setattr__(self, name: str, value: Any) -> None:
        if self._frozen and name not in self.__dict__ and not name.startswith("_"):
            raise AttributeError(f"cannot add config key after freeze: {name}")
        object.__setattr__(self, name, value)

    # -- tree utilities ------------------------------------------------

    def freeze(self, frozen: bool = True) -> None:
        object.__setattr__(self, "_frozen", frozen)
        for v in self.__dict__.values():
            if isinstance(v, AttrDict):
                v.freeze(frozen)

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, AttrDict) else v
            for k, v in self.__dict__.items()
            if not k.startswith("_")
        }

    def from_dict(self, d: dict) -> None:
        for k, v in d.items():
            if isinstance(v, dict):
                getattr(self, k).from_dict(v)
            else:
                setattr(self, k, v)

    def clone(self) -> "AttrDict":
        return copy.deepcopy(self)

    def __repr__(self) -> str:
        return pprint.pformat(self.to_dict())

    # -- dotted-path overrides ----------------------------------------

    def get_path(self, path: str) -> Any:
        node: Any = self
        for part in path.split("."):
            node = getattr(node, part)
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            node = getattr(node, part)
        setattr(node, parts[-1], value)

    def update_args(self, args: Iterable[str]) -> None:
        """Apply ``KEY=VALUE`` strings (the ``--config`` override UX).

        Values are parsed as Python literals when possible (so
        ``TRAIN.LR_SCHEDULE=[240000,320000,360000]`` and
        ``MODE_MASK=True`` work, matching the argv rendered at
        reference charts/maskrcnn/templates/maskrcnn.yaml:60-72);
        otherwise kept as strings (paths like ``DATA.BASEDIR=/efs/data``).
        """
        for arg in args:
            if "=" not in arg:
                raise ValueError(f"config override must be KEY=VALUE, got: {arg}")
            key, value = arg.split("=", 1)
            key = key.strip()
            try:
                existing = self.get_path(key)
                if isinstance(existing, AttrDict):
                    raise KeyError(key)
            except (AttributeError, KeyError) as e:
                raise KeyError(f"unknown config key: {key}") from e
            self.set_path(key, _parse_value(value, existing))


def _parse_value(text: str, existing: Any) -> Any:
    text = text.strip()
    try:
        value = ast.literal_eval(text)
    except (ValueError, SyntaxError):
        value = text  # bare string (paths, names)
    # Keep tuple-vs-list flexibility but respect existing bool/str types.
    if isinstance(existing, bool) and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(existing, str) and not isinstance(value, str):
        return str(value)
    return value


def knobs_with_defaults(node, defaults: dict) -> dict:
    """Config-node values over canonical defaults, for callers handed
    a config tree predating the knobs — ONE implementation of the
    fallback merge every subsystem uses (loader ``_data_knobs``,
    sharding, trainer telemetry/tracing/goodput, serve engine).  The
    ``to_dict`` guard keeps an unfrozen AttrDict's materialized empty
    sub-nodes from shadowing a scalar default."""
    out = dict(defaults)
    if node is not None:
        for k in out:
            v = getattr(node, k, None)
            if v is not None and not hasattr(v, "to_dict"):
                out[k] = v
    return out


config = AttrDict()
_C = config  # shorthand used below, TensorPack-style


# Data-ingest robustness knobs (eksml_tpu/data/robust.py) — ONE source
# of truth: _define_defaults installs these under RESILIENCE.DATA, and
# the loader's fallback for pre-robustness config trees imports the
# same dict.
#
# - IO_*: transient I/O errors (EIO/ESTALE/timeout — shared-filesystem
#   blips) retry with bounded exponential backoff; decode errors and
#   missing files are permanent and quarantine immediately.
# - MAX_QUARANTINE_FRAC: circuit breaker — abort (naming the
#   quarantine ledger) once MORE than this fraction of distinct
#   records is quarantined; a vanished mount must fail loudly, not
#   train on substitutes.
# - MAX_POOL_REBUILDS: BrokenProcessPool (decode worker OOM-killed)
#   pool rebuilds before degrading to in-thread decode.
# - STARVATION_TIMEOUT_SEC: consumer-side q.get timeout; each expiry
#   checks the producer thread is alive (a dead producer raises a
#   diagnostic DataStarvationError instead of blocking forever).
#   0 = wait forever (the legacy deadlock — only for debugging).
# - VALIDATE: preflight dataset validation in CocoDataset — "off" |
#   "warn" (log issues, drop bad annotations) | "strict" (raise);
#   VALIDATE_SAMPLE sizes the file-existence probe.
# - FAULT_INJECT_EIO_*: chaos hook — first COUNT reads of any image
#   path containing the substring raise EIO (then succeed); the
#   injected-transient rung of the chaos ladder.  "" = off.
RESILIENCE_DATA_DEFAULTS = dict(
    IO_RETRIES=3,              # extra attempts, transient errors only
    IO_BACKOFF_SEC=0.5,
    IO_BACKOFF_FACTOR=2.0,
    IO_MAX_BACKOFF_SEC=10.0,
    MAX_QUARANTINE_FRAC=0.05,
    MAX_POOL_REBUILDS=1,
    STARVATION_TIMEOUT_SEC=120.0,
    VALIDATE="warn",
    VALIDATE_SAMPLE=64,
    FAULT_INJECT_EIO_PATH="",
    FAULT_INJECT_EIO_COUNT=1,
)

# Telemetry knobs (eksml_tpu/telemetry/) — ONE source of truth, same
# pattern as RESILIENCE_DATA_DEFAULTS: _define_defaults installs these
# under TELEMETRY, and train._telemetry_knobs imports the same dict as
# the fallback for pre-telemetry config trees.
#
# - ENABLED: master switch for the whole layer — False runs neither
#   the exporter, the flight recorder, nor the cross-host aggregation
#   collective (the debugging guarantee: "off" means off the
#   collective path too).
# - PORT: per-pod /metrics + /healthz HTTP port (charts annotate
#   prometheus.io/scrape with the same value — keep them in lockstep).
#   0 = bind an ephemeral port and publish it to
#   <logdir>/telemetry-host<i>.port (the smoke-test contract).  A bind
#   failure disables the exporter with a warning, never the run.
# - AGGREGATE_HOSTS: cross-host min/max/mean + straggler attribution
#   at each log interval (telemetry/aggregate.py HOST_AGG_KEYS).
#   Host-side allgather outside jit, zero RNG — losses stay
#   bit-identical; False skips the collective (and the hosts/*
#   columns).
# - FLIGHT_RECORDER_EVENTS: in-memory ring capacity; events also
#   mirror to <logdir>/events-host<i>.jsonl (telemetry/recorder.py).
# - HEALTHZ_STALE_SEC: liveness semantics for /healthz — once the
#   reported seconds_since_last_step exceeds this bound the endpoint
#   answers 503 "stale" so a k8s livenessProbe restarts the wedged
#   pod.  0 = legacy always-200.  Size it to cover the first-step XLA
#   compile (minutes), not just steady-state steps — the charts'
#   probe initialDelay rides the same value.
# - PREDICTED_STEP_TIME: the first step of each fit runs under the
#   step counter (eksml_tpu_torch/profiling/predict.py), which records
#   every operation's FLOPs, bytes, component and allocations; the step
#   is priced on the card's roofline and published as the
#   eksml_train_predicted_step_time_ms gauge (with the predicted
#   liveness peak in the log) — the measured-vs-predicted pair every
#   scrape can alert on.  Costs one counted first step (host-side
#   bookkeeping per operation), never a later one; the losses are the
#   same bits as with the knob off.
TELEMETRY_DEFAULTS = dict(
    ENABLED=True,
    PORT=9090,
    AGGREGATE_HOSTS=True,
    FLIGHT_RECORDER_EVENTS=256,
    HEALTHZ_STALE_SEC=0.0,
    PREDICTED_STEP_TIME=True,
)

# Sharding-plan knobs (eksml_tpu/parallel/sharding.py) — ONE source
# of truth, same pattern as RESILIENCE_DATA_DEFAULTS: installed under
# TRAIN.SHARDING, and sharding.sharding_knobs imports the same dict as
# the fallback for pre-sharding config trees.
#
# - STRATEGY: how params + optimizer state lay out across the mesh.
#   "replicated" = one full copy per chip (the reference's only
#   strategy; today's default — compiled program unchanged).  "fsdp" =
#   shard both over the fsdp mesh axis (ZeRO-style), gathered
#   just-in-time inside the step via sharding constraints — the
#   memory plan for R101/cascade at batch/image sizes the replicated
#   layout can't fit.  "tensor" = shard the big FPN/head weights'
#   output features over the model mesh axis (the rest replicated),
#   gathered/scattered by the same constraint pair on the model
#   axis.  "2d" = the fsdp x tensor composition: the tensor targets
#   place (fsdp, model) jointly and everything else falls through to
#   fsdp — per-device state tracks the axis PRODUCT.
# - FSDP_AXIS_SIZE: devices on the fsdp axis (0 = every device of one
#   slice; under "2d", the rest of the slice after the model axis).
#   Must divide the per-slice device count — param all-gathers are
#   per-step traffic and must stay on ICI, never DCN.
# - MODEL_AXIS_SIZE: devices on the model axis for "tensor"/"2d"
#   (0 = every device of one slice under "tensor"; "2d" needs it set
#   explicitly).  Same ICI-only divisibility contract; under "2d" the
#   fsdp x model product must divide the per-slice device count.
# - RULES: ordered ((regex, action), ...) partition rules matched
#   against /-joined param-tree paths; action is "fsdp" (auto-place
#   the axis on the largest divisible dim), "tensor" (model axis on
#   the output-feature/last dim), "2d" (both), "replicated", or a
#   literal PartitionSpec tuple.  MUST end with a catch-all.  () =
#   the strategy's defaults (sharding.DEFAULT_RULES).
# - EXCHANGE: how gradients cross slices when TPU.NUM_SLICES > 1.
#   "flat" = one ring over every replica (the legacy layout — the
#   whole all-reduce is bounded by the slowest link, DCN once it
#   spans slices).  "hierarchical" = plan_mesh emits an explicit
#   leading "slice" mesh axis and storage_grads stages the exchange:
#   reduce-scatter on ICI within each slice, all-reduce of the
#   1/per-slice partials over DCN, all-gather back on ICI — only one
#   slice-reduced copy of the gradients ever rides the thin DCN NIC.
#   No effect at NUM_SLICES=1 (single slice has no DCN hop).
SHARDING_DEFAULTS = dict(
    STRATEGY="replicated",
    FSDP_AXIS_SIZE=0,
    MODEL_AXIS_SIZE=0,
    RULES=(),
    EXCHANGE="flat",
)

# Span tracing + on-demand profiling knobs (telemetry/tracing.py),
# installed under TELEMETRY.TRACING; train._tracing_knobs imports the
# same dict as the fallback for pre-tracing config trees.
#
# - ENABLED: install the per-host span tracer (context-manager spans
#   through the hot path → bounded ring → Chrome-trace JSON at
#   <logdir>/trace-host<i>.json).  Off = the span API is a true no-op
#   (shared null context manager, no allocation).
# - RING_EVENTS: span ring capacity (memory bound; oldest spans drop).
# - PROFILE_STEPS: steps per on-demand/anomaly capture when the
#   /debugz/profile request doesn't name its own count.
# - PROFILE_COOLDOWN_SEC / MAX_CAPTURES_PER_RUN: the ProfileTrigger
#   guard rails — a flapping alert or curious operator cannot chain
#   captures back to back or fill the shared fs with trace dumps.
# - ANOMALY_TRIGGER: fire the same capture automatically when the
#   detector below sees a persistent anomaly (the incident's trace
#   exists before anyone is paged).
# - ANOMALY_INTERVALS: consecutive anomalous log intervals required
#   (one blip is noise; K in a row is an incident).
# - ANOMALY_P95_FACTOR: interval step time > factor × rolling p95 of
#   healthy intervals = anomalous.
# - ANOMALY_SPREAD_FACTOR: hosts/step_time_ms max/mean ratio gate for
#   the persistent-straggler signal (argmax over near-identical hosts
#   is a random index without it).
TELEMETRY_TRACING_DEFAULTS = dict(
    ENABLED=False,
    RING_EVENTS=4096,
    PROFILE_STEPS=3,
    PROFILE_COOLDOWN_SEC=300.0,
    MAX_CAPTURES_PER_RUN=3,
    ANOMALY_TRIGGER=True,
    ANOMALY_INTERVALS=3,
    ANOMALY_P95_FACTOR=1.5,
    ANOMALY_SPREAD_FACTOR=1.5,
)

# Goodput-ledger knobs (telemetry/goodput.py), installed under
# TELEMETRY.GOODPUT; train._goodput_knobs imports the same dict as
# the fallback for pre-goodput config trees.
#
# - ENABLED: classify run wall-clock into goodput/badput buckets (fed
#   by the span sink + flight-recorder sink — no new hot-path
#   instrumentation) and publish eksml_goodput_ratio +
#   eksml_badput_seconds_total{bucket=} via the exporter.  Rides the
#   TELEMETRY.ENABLED master switch: off means off.
# - BANK: append per-segment ledger snapshots to
#   <logdir>/goodput-host<i>.jsonl at each log interval — the
#   artifact tools/goodput_report.py merges ACROSS restarts (the
#   in-process meter dies with the process; the bank is what makes
#   the ledger whole-run).
TELEMETRY_GOODPUT_DEFAULTS = dict(
    ENABLED=True,
    BANK=True,
)

# Elastic-autoscaling knobs (eksml_tpu/resilience/autoscale.py +
# tools/eksml_operator.py) — ONE source of truth, same pattern as
# RESILIENCE_DATA_DEFAULTS: installed under RESILIENCE.AUTOSCALE, and
# the operator imports the same dict as the fallback for config trees
# predating the operator.  The decision policy itself is pure
# (autoscale.decide) — these knobs parameterize it and the actuator
# loop; charts/autoscaler renders each as --config argv so the
# values-config-sync lint pins chart ↔ config drift.
#
# - INTERVAL_SEC: actuator tick period (capacity read + /metrics
#   scrape + one decide()).
# - COOLDOWN_SEC: minimum seconds between GROW relaunches — a grow is
#   two compiles and a resharded restore, so oscillating capacity
#   must not thrash them.  Shrinks ignore the cooldown: when chips
#   are being reclaimed, holding the larger shape means dying by
#   SIGKILL instead of checkpointing.
# - GROW_PATIENCE / SHRINK_PATIENCE: consecutive observations a
#   grow/shrink candidate must survive before actuation (hysteresis
#   against a flapping capacity signal).
# - FORECAST_HOLD: preemption-forecast score at or above which growth
#   is vetoed (the new chips are about to vanish).
# - MIN_GOODPUT_FOR_GROW: goodput ratio below which growth is vetoed
#   (a relaunch only adds badput); 0 disables the health veto.
# - CHIP_OPTIONS: the chip counts the topology ladder is built over,
#   e.g. (4, 8, 16); () = the operator requires an explicit ladder.
#   Counts plan_mesh would reject (per-slice divisibility) yield no
#   rung.
# - SERVE_*: the ACTIVE half of the serving HPA (charts/serve): the
#   operator computes desired replicas from the scraped
#   eksml_serve_queue_depth with the same averageValue math and
#   clamps to [SERVE_MIN_REPLICAS, SERVE_MAX_REPLICAS];
#   SERVE_TARGET_QUEUE_DEPTH=0 disables serve scaling.
# - CANARY_*: the promotion controller's SLO gate (the canary half of
#   the serving continuous-deployment loop, tools/eksml_operator.py
#   --promote): a shadow-scored canary checkpoint is rolled back when
#   its replayed p99 exceeds CANARY_P99_RATIO_MAX x the incumbent's,
#   its error rate exceeds CANARY_ERROR_RATE_MAX, or its
#   detection-output drift exceeds CANARY_DRIFT_MAX; it is promoted
#   only after CANARY_PROMOTE_STREAK consecutive in-SLO scores over at
#   least CANARY_MIN_REQUESTS replayed requests each (rollback is
#   immediate, promotion is patient — the rollout asymmetry).
RESILIENCE_AUTOSCALE_DEFAULTS = dict(
    INTERVAL_SEC=30.0,
    COOLDOWN_SEC=300.0,
    GROW_PATIENCE=2,
    SHRINK_PATIENCE=1,
    FORECAST_HOLD=0.5,
    MIN_GOODPUT_FOR_GROW=0.0,
    CHIP_OPTIONS=(),
    SERVE_TARGET_QUEUE_DEPTH=0.0,
    SERVE_MIN_REPLICAS=2,
    SERVE_MAX_REPLICAS=16,
    CANARY_P99_RATIO_MAX=1.5,
    CANARY_ERROR_RATE_MAX=0.02,
    CANARY_DRIFT_MAX=0.25,
    CANARY_MIN_REQUESTS=20,
    CANARY_PROMOTE_STREAK=2,
)

# Online-serving knobs (eksml_tpu/serve/) — ONE source of truth, same
# pattern as RESILIENCE_DATA_DEFAULTS: installed under SERVE, and
# serve.engine/serve.batcher import the same dict as the fallback for
# pre-serving config trees.
#
# - PORT: the serving HTTP port (POST /v1/predict + /healthz +
#   /metrics on one listener); charts/serve renders the containerPort,
#   the probes AND the --config SERVE.PORT argv from one values key.
#   0 = bind an ephemeral port and publish it to --port-file (the
#   load-test discovery contract, same as TELEMETRY.PORT=0).
# - MAX_BATCH_SIZE: requests per micro-batch ceiling.  The dispatcher
#   closes a batch at this size even before the delay window expires.
# - MAX_BATCH_DELAY_MS: how long the dispatcher holds an open batch
#   waiting for same-bucket requests.  0 = pass-through mode: every
#   request dispatches alone, immediately (the latency-floor
#   configuration; throughput configurations trade a few ms here for
#   batch occupancy).
# - MAX_QUEUE: bounded request queue; a full queue answers 429 (load
#   shedding at admission, never unbounded memory).
# - BATCH_SIZES: the executable batch rungs warmed at startup; every
#   dispatched batch pads up to the smallest rung that holds it so
#   the (bucket, batch) pair always hits the AOT cache.  () = (1,
#   MAX_BATCH_SIZE) deduped.  Every rung must be <= MAX_BATCH_SIZE.
# - BUCKETS: (H, W) canvases for request padding (assign_bucket's
#   schedule, dims divisible by the coarsest FPN stride).  () = fall
#   back to PREPROC.BUCKETS, else the square (MAX_SIZE, MAX_SIZE).
# - RESULT_MASKS: include RLE instance masks in /v1/predict responses
#   by default (per-request `masks` field still overrides); mask
#   pasting is host-side postprocess cost, so the default is off.
# - RELOAD_POLL_SEC: the checkpoint hot-reload watcher's poll period
#   over <checkpoint-dir>/checkpoints.  0 disables the watcher (the
#   /admin/reload endpoint still works when a checkpoint dir was
#   given).  Each candidate is verified against its integrity +
#   topology manifests, restored OFF the request path, and swapped
#   between micro-batches — in-flight requests finish on the old
#   params and the AOT bucket cache is reused (zero request-path
#   compiles across the swap).
# - RELOAD_DIGEST: verify sha256 digests during reload validation when
#   the manifest carries them (RESILIENCE.CHECKPOINT_DIGEST saves
#   them); size-only checking is cheaper on huge checkpoints.
# Sharding strategies TRAIN.SHARDING.STRATEGY may name (the JAX
# package's parallel/sharding.py STRATEGIES).
STRATEGIES = ("replicated", "fsdp", "tensor", "2d")

SERVE_DEFAULTS = dict(
    PORT=8081,
    MAX_BATCH_SIZE=4,
    MAX_BATCH_DELAY_MS=5.0,
    MAX_QUEUE=256,
    BATCH_SIZES=(),
    BUCKETS=(),
    RESULT_MASKS=False,
    RELOAD_POLL_SEC=0.0,
    RELOAD_DIGEST=True,
)


def _define_defaults() -> None:
    # ---- mode flags (reference templates/maskrcnn.yaml:61-62) -------
    _C.MODE_MASK = True
    _C.MODE_FPN = True
    _C.MODE_CASCADE = False        # Cascade R-CNN stretch config

    # ---- trainer selection ------------------------------------------
    # Reference sets TRAINER=horovod (templates/maskrcnn.yaml:71); here
    # the only value is the SPMD mesh trainer.
    _C.TRAINER = "spmd"

    # ---- data (reference values.yaml:12-22, stage-data contract) ----
    _C.DATA.BASEDIR = "/efs/data"
    _C.DATA.TRAIN = ("train2017",)
    _C.DATA.VAL = "val2017"
    _C.DATA.NUM_CLASSES = 81       # 80 COCO categories + background
    _C.DATA.MAX_GT_BOXES = 100     # static padding for ragged GT
    _C.DATA.SYNTHETIC = False      # tests/bench: generated data, no disk
    # decode/augment worker threads per host (≙ TensorPack's
    # multiprocess dataflow prefetch); 0 = inline in the producer
    _C.DATA.NUM_WORKERS = 8
    # JPEG-decode worker PROCESSES (0 = decode on the threads above).
    # PIL decode holds the GIL, so on a many-core host feeding 4 chips
    # of 1344px images the thread pool alone can't scale decode —
    # TensorPack's dataflow was multiprocess for exactly this reason
    # (reference container/Dockerfile:16-19).  Resize/augment stay on
    # the thread pipeline either way (native GIL-released resize).
    _C.DATA.WORKER_PROCESSES = 0

    # ---- preprocessing (static shapes are load-bearing on TPU) ------
    _C.PREPROC.TRAIN_SHORT_EDGE_SIZE = (800, 800)
    _C.PREPROC.TEST_SHORT_EDGE_SIZE = 800
    _C.PREPROC.MAX_SIZE = 1344     # multiple of 128: pad target H=W
    # aspect-ratio bucketed padding: (H, W) canvases; each train image
    # pads to the smallest bucket that holds it and every batch is
    # bucket-homogeneous (one XLA program per bucket).  () = legacy
    # square (MAX_SIZE, MAX_SIZE).  Dims must divide the coarsest FPN
    # stride.  E.g. ((832, 1344), (1344, 832), (1344, 1344)) halves the
    # padded-pixel count on typical landscape/portrait COCO images.
    _C.PREPROC.BUCKETS = ()
    _C.PREPROC.PIXEL_MEAN = (123.675, 116.28, 103.53)
    _C.PREPROC.PIXEL_STD = (58.395, 57.12, 57.375)
    # ship uint8 images host->device and fold (x-mean)/std into the
    # compiled program: 4x less H2D bandwidth per batch (f32 1344^2x3 is
    # ~21.7 MB/image), and XLA fuses the normalize into the first conv.
    # False = legacy host-side f32 normalization (golden fixtures).
    _C.PREPROC.DEVICE_NORMALIZE = True

    # ---- backbone (reference values.yaml:21-22, run.sh:16,43-44) ----
    _C.BACKBONE.WEIGHTS = ""       # path to ImageNet-R50-AlignPadding.npz
    _C.BACKBONE.RESNET_NUM_BLOCKS = (3, 4, 6, 3)  # R50; (3,4,23,3) = R101
    _C.BACKBONE.NORM = "FreezeBN"  # FreezeBN | GN
    _C.BACKBONE.FREEZE_AT = 2      # freeze conv1 + res2, TensorPack default

    # ---- FPN --------------------------------------------------------
    _C.FPN.NUM_CHANNEL = 256
    _C.FPN.ANCHOR_STRIDES = (4, 8, 16, 32, 64)
    _C.FPN.PROPOSAL_MODE = "level"
    _C.FPN.FRCNN_FC_HEAD_DIM = 1024

    # ---- anchors / RPN ----------------------------------------------
    _C.RPN.ANCHOR_SIZES = (32, 64, 128, 256, 512)
    _C.RPN.ANCHOR_RATIOS = (0.5, 1.0, 2.0)
    _C.RPN.POSITIVE_ANCHOR_THRESH = 0.7
    _C.RPN.NEGATIVE_ANCHOR_THRESH = 0.3
    _C.RPN.BATCH_PER_IM = 256      # sampled anchors for the RPN loss
    _C.RPN.FG_RATIO = 0.5
    _C.RPN.MIN_SIZE = 0.0
    _C.RPN.PROPOSAL_NMS_THRESH = 0.7
    # static per-level topk before NMS and fixed post-NMS counts:
    _C.RPN.TRAIN_PRE_NMS_TOPK = 2000
    _C.RPN.TRAIN_POST_NMS_TOPK = 1000
    _C.RPN.TEST_PRE_NMS_TOPK = 1000
    _C.RPN.TEST_POST_NMS_TOPK = 1000

    # ---- RCNN heads -------------------------------------------------
    _C.FRCNN.BATCH_PER_IM = 512    # sampled proposals for the head loss
    _C.FRCNN.FG_THRESH = 0.5
    _C.FRCNN.FG_RATIO = 0.25
    _C.FRCNN.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    _C.MRCNN.HEAD_DIM = 256
    _C.MRCNN.RESOLUTION = 28

    # ---- cascade (stretch; BASELINE.json configs[4]) ----------------
    _C.CASCADE.IOUS = (0.5, 0.6, 0.7)
    _C.CASCADE.BBOX_REG_WEIGHTS = ((10., 10., 5., 5.), (20., 20., 10., 10.),
                                   (30., 30., 15., 15.))

    # ---- test-time --------------------------------------------------
    _C.TEST.FRCNN_NMS_THRESH = 0.5
    _C.TEST.RESULT_SCORE_THRESH = 0.05
    _C.TEST.RESULTS_PER_IM = 100
    # images per jitted predict call during periodic eval; the
    # reference's single-rank eval is effectively batch 1 — batching is
    # required to keep EVAL_PERIOD=1 epochs from dominating wall-clock
    _C.TEST.EVAL_BATCH_SIZE = 4

    # ---- training schedule (reference values.yaml:14-16,29) ---------
    _C.TRAIN.NUM_CHIPS = 1         # ≙ gpus in values.yaml:8
    _C.TRAIN.CHIPS_PER_HOST = 4    # ≙ gpus_per_node (v5e host = 4 chips)
    _C.TRAIN.BATCH_SIZE_PER_CHIP = 1   # ≙ TRAIN.BATCH_SIZE_PER_GPU
    _C.TRAIN.BASE_LR = 0.01        # per 8-image global batch, linearly scaled
    _C.TRAIN.WARMUP_STEPS = 500
    _C.TRAIN.WARMUP_INIT_FACTOR = 0.33
    _C.TRAIN.WEIGHT_DECAY = 1e-4
    _C.TRAIN.MOMENTUM = 0.9
    _C.TRAIN.GRADIENT_CLIP = 0.0   # optimized chart uses 0.36 (values.yaml:32)
    _C.TRAIN.STEPS_PER_EPOCH = 120000  # "must equal 120000/chips" values.yaml:14
    _C.TRAIN.LR_SCHEDULE = (240000, 320000, 360000)
    _C.TRAIN.LR_EPOCH_SCHEDULE = ()    # optimized: ((16,0.1),(20,0.01),(24,None))
    _C.TRAIN.MAX_EPOCHS = 24
    _C.TRAIN.EVAL_PERIOD = 1       # epochs (values.yaml:16)
    _C.TRAIN.CHECKPOINT_PERIOD = 2 # epochs (values.yaml:29 extra_config)
    _C.TRAIN.LOG_PERIOD = 20       # steps between metric writes
    # debug mode (SURVEY.md §5.2): every N steps assert all data-parallel
    # replicas hold identical params — the silent-divergence failure the
    # reference's Horovod stack cannot detect.  0 = off.
    _C.TRAIN.SYNC_CHECK_PERIOD = 0
    _C.TRAIN.SEED = 0
    _C.TRAIN.PRECISION = "float32" # "bfloat16" ≙ TENSORPACK_FP16/--fp16
    # rematerialize backbone+FPN activations in the backward pass —
    # trades FLOPs for HBM, the lever that buys batch-4/chip at 1344px
    # (no reference equivalent; V100s just had the memory)
    _C.TRAIN.REMAT = False
    # param + optimizer-state STORAGE dtype ("bfloat16" halves the
    # ~360 MB of f32 state HBM at R50-FPN scale — with REMAT, the
    # memory plan that fits batch-8/chip at 1344px).  Compute precision
    # stays TRAIN.PRECISION; losses/updates tolerate bf16 state to the
    # dtype's resolution (dryrun parity pinned in tests)
    _C.TRAIN.PARAM_DTYPE = "float32"
    # overlap the next batch's host-shard -> device_put with the
    # current step's compute (data/loader.py DevicePrefetcher).  Batch
    # order is unchanged, so losses are bit-identical ON or OFF; the
    # step loop's residual blocking rides the metric stream as
    # data/prefetch_wait_ms.  False = legacy synchronous transfer.
    _C.TRAIN.PREFETCH_TO_DEVICE = True
    _C.TRAIN.LOGDIR = "/tmp/eksml_tpu/train_log/maskrcnn"
    # sharding plan (eksml_tpu/parallel/sharding.py) — per-knob docs
    # on SHARDING_DEFAULTS above
    for k, v in SHARDING_DEFAULTS.items():
        setattr(_C.TRAIN.SHARDING, k, v)

    # ---- TPU / comm layer (≙ HOROVOD_*/NCCL_* env, values.yaml:24-28)
    _C.TPU.MESH_SHAPE = ()         # () → (num_devices, 1)
    _C.TPU.MESH_AXES = ("data", "model")
    _C.TPU.TOPOLOGY = ""           # e.g. "v5e-32"; validated like the CRD schema
    # 0 = auto-size from model scale via the native shim
    # (parallel/native.py recommend_combine_threshold)
    _C.TPU.ALLREDUCE_COMBINE_THRESHOLD_BYTES = 64 * 1024 * 1024
    # ≙ §5.1: jax.profiler trace server port (0 = off); the NCCL_DEBUG
    # analogue for perf visibility
    _C.TPU.PROFILER_PORT = 0
    _C.TPU.COORDINATOR_ADDRESS = ""   # JobSet headless-service DNS
    _C.TPU.NUM_PROCESSES = 1
    _C.TPU.PROCESS_ID = 0
    # Multi-slice (Multislice/DCN) data parallelism: number of v5e
    # slices the data axis spans.  1 = single slice (parity scope —
    # the reference's 2-node NCCL-over-TCP layout is ONE slice's ICI
    # here); >1 orders the mesh slice-major so gradient all-reduce
    # decomposes into ICI within each slice + one DCN hop between
    # slices (parallel/mesh.py build_mesh).  Auto-detected from
    # device.slice_index on real multi-slice deployments.
    _C.TPU.NUM_SLICES = 1

    # ---- resilience (eksml_tpu/resilience/) -------------------------
    # The in-process half of the fault story; the orchestration half is
    # the chart's failurePolicy/podFailurePolicy (SURVEY.md §5.3: the
    # reference has restartPolicy Never and rerun-by-hand, nothing else).
    # SIGTERM grace window → forced checkpoint at the next step boundary,
    # then exit PREEMPT_EXIT_CODE ("preempted, resumable") — the charts'
    # podFailurePolicy maps exactly this code to restart-not-fail, so
    # the two MUST stay in sync (tests/test_orchestration.py pins
    # values.yaml preempt_exit_code to this default).
    _C.RESILIENCE.GRACEFUL_SHUTDOWN = True
    _C.RESILIENCE.PREEMPT_EXIT_CODE = 77
    # steps between the cross-host "anyone preempted?" agreement
    # collective.  Multi-host only (single-process checks its local
    # flag every step for free); the poll is a host-blocking allgather,
    # so per-step polling would break the async-dispatch pipelining.
    # 0 = piggyback on LOG_PERIOD; an explicit N bounds the
    # SIGTERM→forced-checkpoint latency to N steps (keep
    # N·step_time well inside terminationGracePeriodSeconds)
    _C.RESILIENCE.PREEMPT_SYNC_PERIOD = 0
    # per-file sha256 in the post-commit integrity manifest (sizes are
    # always recorded; digests re-read every checkpoint byte at save)
    _C.RESILIENCE.CHECKPOINT_DIGEST = False
    # elastic topology (parallel/topology.py + utils/checkpoint.py):
    # every checkpoint step records the topology it was saved on (mesh
    # shape/axes, TPU.NUM_SLICES, sharding strategy, fsdp axis size,
    # device/process counts) next to its integrity manifest.  True =
    # a relaunch at a DIFFERENT topology reshards the restore onto
    # the current mesh (grow or shrink: v5e-32 -> v5e-8 and back,
    # fsdp axis resize, slice-count change) and emits the
    # checkpoint_resharded event + counter with a saved->current
    # diff.  False = a topology-mismatched restore fails fast with an
    # actionable error naming this knob — for fleets where a topology
    # change is only ever operator error.
    _C.RESILIENCE.ELASTIC_RESUME = True
    # consecutive non-finite total_loss observations before rolling
    # back to the last good checkpoint
    _C.RESILIENCE.NAN_PATIENCE = 3
    # 0 = observe the loss only where the loop materializes it anyway
    # (LOG_PERIOD + checkpoint boundaries: zero extra device syncs);
    # N>0 = force a host read every N steps for a tighter guard
    _C.RESILIENCE.NAN_CHECK_PERIOD = 0
    # divergence rollbacks before aborting with a diagnostic
    _C.RESILIENCE.MAX_ROLLBACKS = 2
    # hang watchdog: 0 = off; otherwise seconds a step may run before
    # an all-thread stack report lands in the logdir.  First deadline
    # is stretched ×WATCHDOG_COMPILE_FACTOR (step 1 includes the XLA
    # compile, which is slow but not hung).
    _C.RESILIENCE.WATCHDOG_TIMEOUT_SEC = 0.0
    _C.RESILIENCE.WATCHDOG_COMPILE_FACTOR = 20.0
    # bounded retry/backoff around jax.distributed.initialize — JobSet
    # pods start in arbitrary order and the coordinator may not be
    # listening yet.  NOTE: counts TOTAL connection attempts (1 = no
    # retry), unlike RESILIENCE.DATA.IO_RETRIES which counts EXTRA
    # attempts after the first; both are pinned by tests
    _C.RESILIENCE.INIT_RETRIES = 5
    _C.RESILIENCE.INIT_BACKOFF_SEC = 2.0
    # chaos-ladder hook (tests/test_fault_tolerance.py): at this step,
    # multiply the params by NaN once — a faithful stand-in for real
    # divergence (every later loss is non-finite until rollback). 0=off.
    _C.RESILIENCE.FAULT_INJECT_NAN_STEP = 0

    # ---- data-ingest robustness (eksml_tpu/data/robust.py) ----------
    for k, v in RESILIENCE_DATA_DEFAULTS.items():
        setattr(_C.RESILIENCE.DATA, k, v)

    # ---- elastic autoscaling (resilience/autoscale.py + operator) ---
    for k, v in RESILIENCE_AUTOSCALE_DEFAULTS.items():
        setattr(_C.RESILIENCE.AUTOSCALE, k, v)

    # ---- telemetry (eksml_tpu/telemetry/) ---------------------------
    # Registry → cross-host aggregation → OpenMetrics exporter /
    # flight recorder; per-knob docs on TELEMETRY_DEFAULTS above.
    for k, v in TELEMETRY_DEFAULTS.items():
        setattr(_C.TELEMETRY, k, v)
    # span tracing + on-demand profiling (telemetry/tracing.py)
    for k, v in TELEMETRY_TRACING_DEFAULTS.items():
        setattr(_C.TELEMETRY.TRACING, k, v)
    # goodput/badput wall-clock ledger (telemetry/goodput.py)
    for k, v in TELEMETRY_GOODPUT_DEFAULTS.items():
        setattr(_C.TELEMETRY.GOODPUT, k, v)

    # ---- online serving (eksml_tpu/serve/) --------------------------
    # Dynamic micro-batching inference server; per-knob docs on
    # SERVE_DEFAULTS above.
    for k, v in SERVE_DEFAULTS.items():
        setattr(_C.SERVE, k, v)

    _C.freeze()


_define_defaults()


def finalize_configs(is_training: bool, cfg: AttrDict = None) -> AttrDict:
    """Validate + derive dependent values; returns the frozen config
    (``cfg``, a clone of the global config, or the global config).

    Mirrors TensorPack's ``finalize_configs`` call the notebooks re-run
    before inference (viz notebook cell 9).
    """
    _C = config if cfg is None else cfg
    _C.freeze(False)

    assert _C.BACKBONE.NORM in ("FreezeBN", "GN"), _C.BACKBONE.NORM
    assert _C.TRAIN.PRECISION in ("float32", "bfloat16"), _C.TRAIN.PRECISION
    assert _C.TRAIN.PARAM_DTYPE in ("float32", "bfloat16"), (
        _C.TRAIN.PARAM_DTYPE)
    assert _C.RESILIENCE.DATA.VALIDATE in ("off", "warn", "strict"), (
        _C.RESILIENCE.DATA.VALIDATE)
    assert _C.TRAIN.SHARDING.STRATEGY in STRATEGIES, (
        _C.TRAIN.SHARDING.STRATEGY)
    assert int(_C.TRAIN.SHARDING.FSDP_AXIS_SIZE) >= 0, (
        _C.TRAIN.SHARDING.FSDP_AXIS_SIZE)
    assert int(getattr(_C.TRAIN.SHARDING, "MODEL_AXIS_SIZE", 0)) >= 0, (
        _C.TRAIN.SHARDING.MODEL_AXIS_SIZE)
    assert len(_C.FPN.ANCHOR_STRIDES) == len(_C.RPN.ANCHOR_SIZES)
    assert _C.PREPROC.MAX_SIZE % max(_C.FPN.ANCHOR_STRIDES) == 0, (
        "padded image size must be divisible by the coarsest FPN stride")
    buckets = _C.PREPROC.BUCKETS or ()
    if (len(buckets) == 2
            and all(isinstance(b, int) for b in buckets)):
        # PREPROC.BUCKETS=((832,1344)) parses as a flat 2-int tuple —
        # the operator meant a single bucket
        buckets = (tuple(buckets),)
        _C.PREPROC.BUCKETS = buckets
    for b in buckets:
        assert isinstance(b, (tuple, list)) and len(b) == 2 and all(
            int(d) % max(_C.FPN.ANCHOR_STRIDES) == 0 for d in b), (
            f"bucket {b!r}: must be an (H, W) pair with dims divisible "
            "by the coarsest FPN stride")
    if buckets:
        # A bucket set whose largest canvas cannot hold the worst-case
        # standard resize (short edge at max(TRAIN_SHORT_EDGE_SIZE),
        # long edge up to MAX_SIZE) silently force-fit shrinks those
        # images below the configured training resolution
        # (assign_bucket's fallback).  Warn loudly instead of letting
        # resolution quietly degrade.
        import logging
        smax = max(_C.PREPROC.TRAIN_SHORT_EDGE_SIZE)
        lmax = _C.PREPROC.MAX_SIZE
        bh, bw = max(buckets, key=lambda b: b[0] * b[1])
        for (need_h, need_w), orient in (((smax, lmax), "landscape"),
                                         ((lmax, smax), "portrait")):
            if not any(b[0] >= need_h and b[1] >= need_w
                       for b in buckets):
                logging.getLogger(__name__).warning(
                    "PREPROC.BUCKETS: no bucket holds a worst-case %s "
                    "resize (%dx%d at TRAIN_SHORT_EDGE_SIZE=%d / "
                    "MAX_SIZE=%d); such images will force-fit into the "
                    "largest bucket (%dx%d) BELOW the configured "
                    "resolution", orient, need_h, need_w, smax, lmax,
                    bh, bw)
    if isinstance(_C.DATA.TRAIN, str):
        _C.DATA.TRAIN = (_C.DATA.TRAIN,)

    # ---- serving (eksml_tpu/serve/) ---------------------------------
    serve_buckets = _C.SERVE.BUCKETS or ()
    if (len(serve_buckets) == 2
            and all(isinstance(b, int) for b in serve_buckets)):
        # SERVE.BUCKETS=((832,1344)) parses as a flat 2-int tuple —
        # same operator-intent fixup as PREPROC.BUCKETS above
        serve_buckets = (tuple(serve_buckets),)
        _C.SERVE.BUCKETS = serve_buckets
    for b in serve_buckets:
        assert isinstance(b, (tuple, list)) and len(b) == 2 and all(
            int(d) % max(_C.FPN.ANCHOR_STRIDES) == 0 for d in b), (
            f"SERVE bucket {b!r}: must be an (H, W) pair with dims "
            "divisible by the coarsest FPN stride")
    assert int(_C.SERVE.MAX_BATCH_SIZE) >= 1, _C.SERVE.MAX_BATCH_SIZE
    if isinstance(_C.SERVE.BATCH_SIZES, int):
        # SERVE.BATCH_SIZES=(4) parses as a bare int — the operator
        # meant a single rung
        _C.SERVE.BATCH_SIZES = (_C.SERVE.BATCH_SIZES,)
    for bs in (_C.SERVE.BATCH_SIZES or ()):
        assert 1 <= int(bs) <= int(_C.SERVE.MAX_BATCH_SIZE), (
            f"SERVE.BATCH_SIZES rung {bs} must lie in "
            f"[1, SERVE.MAX_BATCH_SIZE={_C.SERVE.MAX_BATCH_SIZE}]")

    if is_training:
        # Reference couples steps/epoch to world size: 120000/N at batch
        # 1 (values.yaml:14, run.sh:15); the optimized chart divides by
        # the global batch (--images_per_epoch 120000 at batch 4,
        # charts/maskrcnn-optimized/templates/maskrcnn.yaml:64,72).
        # Recompute only when the caller left the single-chip default.
        global_batch = _C.TRAIN.NUM_CHIPS * _C.TRAIN.BATCH_SIZE_PER_CHIP
        if _C.TRAIN.STEPS_PER_EPOCH == 120000 and global_batch > 1:
            _C.TRAIN.STEPS_PER_EPOCH = 120000 // global_batch
        if _C.TRAIN.LR_EPOCH_SCHEDULE:
            # optimized-chart form [(16,0.1),(20,0.01),(24,None)]
            # (charts/maskrcnn-optimized/values.yaml:18) → boundaries in
            # LR_SCHEDULE's batch-8-convention steps (lr_schedule in
            # train.py rescales by 8/global_batch, so express epochs in
            # those units to survive the round trip at any batch).
            sched = []
            for epoch, mult in _C.TRAIN.LR_EPOCH_SCHEDULE:
                if mult is None:
                    _C.TRAIN.MAX_EPOCHS = epoch
                else:
                    sched.append(max(1, round(
                        epoch * _C.TRAIN.STEPS_PER_EPOCH
                        * global_batch / 8)))
            _C.TRAIN.LR_SCHEDULE = tuple(sched)

    _C.freeze()
    return _C


# CPU-feasible shrunk-model KEY=VALUE overrides (compiles in ~1-4 min
# on one core; full model takes 2h+).  Single source for the test
# suite's subprocess drives and bench_sweep --quick so the two can't
# drift onto different shapes.  Run-shape knobs (steps/epochs/periods/
# image size) intentionally stay with each consumer.
SMOKE_OVERRIDES = (
    "DATA.NUM_CLASSES=5", "PREPROC.MAX_SIZE=128",
    "PREPROC.TRAIN_SHORT_EDGE_SIZE=(128,128)", "DATA.MAX_GT_BOXES=8",
    "RPN.TRAIN_PRE_NMS_TOPK=64", "RPN.TRAIN_POST_NMS_TOPK=32",
    "FRCNN.BATCH_PER_IM=16", "FPN.NUM_CHANNEL=32",
    "FPN.FRCNN_FC_HEAD_DIM=64", "MRCNN.HEAD_DIM=16",
    "BACKBONE.RESNET_NUM_BLOCKS=(1,1,1,1)", "TEST.RESULTS_PER_IM=8",
)


def dump_config(cfg: AttrDict = None) -> str:
    return json.dumps((cfg or _C).to_dict(), indent=2, default=str)


def config_from_env(cfg: AttrDict = None) -> AttrDict:
    """Fill comm-layer settings from JobSet downward-API env vars
    (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and the host rank; the
    per-host ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` are read by
    ``parallel/distributed.initialize_from_env`` itself)."""
    cfg = cfg or _C
    cfg.freeze(False)
    # optimized-image baked defaults (container-optimized/Dockerfile);
    # explicit --config overrides still win because they are applied
    # after config_from_env in train.main
    if os.environ.get("EKSML_DEFAULT_PRECISION"):
        cfg.TRAIN.PRECISION = os.environ["EKSML_DEFAULT_PRECISION"]
    if os.environ.get("EKSML_DEFAULT_BATCH_PER_CHIP"):
        cfg.TRAIN.BATCH_SIZE_PER_CHIP = int(
            os.environ["EKSML_DEFAULT_BATCH_PER_CHIP"])
    cfg.TPU.COORDINATOR_ADDRESS = os.environ.get(
        "COORDINATOR_ADDRESS", cfg.TPU.COORDINATOR_ADDRESS)
    cfg.TPU.NUM_PROCESSES = int(os.environ.get(
        "NUM_PROCESSES", cfg.TPU.NUM_PROCESSES))
    if any(k in os.environ for k in ("PROCESS_ID", "SLICE_INDEX",
                                     "JOB_COMPLETION_INDEX")):
        from eksml_tpu_torch.parallel.distributed import _rank_from_env

        cfg.TPU.PROCESS_ID = _rank_from_env(os.environ)
    cfg.freeze()
    return cfg
