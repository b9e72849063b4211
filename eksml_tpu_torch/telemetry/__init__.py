"""Telemetry: the metric registry, its OpenMetrics exposition, request
spans and the flight recorder (the subset of ``eksml_tpu/telemetry``
the serving path and the trainer use)."""

from eksml_tpu_torch.telemetry.aggregate import (HOST_AGG_KEYS,  # noqa: F401
                                                 aggregate_host_scalars,
                                                 publish_aggregates)

from eksml_tpu_torch.telemetry.exporter import render_openmetrics  # noqa: F401
from eksml_tpu_torch.telemetry.registry import (MetricRegistry,  # noqa: F401
                                                default_registry)
from eksml_tpu_torch.telemetry.tracing import (Tracer,  # noqa: F401
                                               complete_span,
                                               install_tracer)
from eksml_tpu_torch.telemetry.recorder import (FlightRecorder,  # noqa: F401
                                                event, events_path_for,
                                                install)
