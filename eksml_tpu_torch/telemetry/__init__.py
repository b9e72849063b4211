"""Serving telemetry: the metric registry, its OpenMetrics exposition
and request spans (the subset of ``eksml_tpu/telemetry`` the serving
path uses)."""

from eksml_tpu_torch.telemetry.exporter import render_openmetrics  # noqa: F401
from eksml_tpu_torch.telemetry.registry import (MetricRegistry,  # noqa: F401
                                                default_registry)
from eksml_tpu_torch.telemetry.tracing import (Tracer,  # noqa: F401
                                               complete_span,
                                               install_tracer)
