"""Telemetry of the port (``eksml_tpu/telemetry``): the metric registry,
cross-rank aggregation, the OpenMetrics exporter with ``/healthz`` and
``/debugz``, the flight recorder, span tracing with profiler captures on
request, and the goodput ledger.

Subsystems publish to the :class:`MetricRegistry`, which the exporter
serves on ``/metrics``; resilience transitions go through ``event()`` to
the :class:`FlightRecorder` (``events-host<i>.jsonl``); the fit loop
times its phases with ``span()`` into the :class:`Tracer`
(``trace-host<i>.json``).  The :class:`GoodputMeter` reads both streams
through ``install_span_sink`` and ``add_event_sink`` and publishes
``eksml_goodput_ratio`` and ``eksml_badput_seconds_total{bucket=}``,
banked to ``goodput-host<i>.jsonl``.  The knobs live under
``config.TELEMETRY`` (``TRACING``, ``GOODPUT``).
"""

from eksml_tpu_torch.telemetry.aggregate import (HOST_AGG_KEYS,  # noqa: F401
                                                 aggregate_host_scalars,
                                                 publish_aggregates,
                                                 stats_from_matrix)
from eksml_tpu_torch.telemetry.exporter import (TelemetryExporter,  # noqa: F401
                                                render_openmetrics)
from eksml_tpu_torch.telemetry.goodput import \
    BUCKETS as GOODPUT_BUCKETS  # noqa: F401
from eksml_tpu_torch.telemetry.goodput import (GoodputMeter,  # noqa: F401
                                               build_ledger,
                                               goodput_path_for,
                                               recover_downtime)
from eksml_tpu_torch.telemetry.recorder import (FlightRecorder,  # noqa: F401
                                                add_event_sink, event,
                                                events_path_for, get,
                                                install, remove_event_sink)
from eksml_tpu_torch.telemetry.registry import (MetricRegistry,  # noqa: F401
                                                default_registry)
from eksml_tpu_torch.telemetry.tracing import (AnomalyDetector,  # noqa: F401
                                               ProfileTrigger, Tracer,
                                               complete_span, get_tracer,
                                               install_span_sink,
                                               install_tracer, span,
                                               trace_path_for, traced)
