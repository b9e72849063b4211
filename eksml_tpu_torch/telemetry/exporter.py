"""OpenMetrics text exposition of a :class:`MetricRegistry` (the
``render_openmetrics`` of ``eksml_tpu/telemetry/exporter.py``); the
serving front-end answers ``GET /metrics`` with it."""

from __future__ import annotations

import math
from typing import Dict, Optional

from eksml_tpu_torch.telemetry.registry import (COUNTER, GAUGE, HISTOGRAM,
                                                MetricRegistry,
                                                default_registry)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(labels, extra: Optional[Dict[str, str]] = None) -> str:
    pairs = list(labels) + sorted((extra or {}).items())
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + body + "}"


def render_openmetrics(registry: Optional[MetricRegistry] = None) -> str:
    """The registry as an OpenMetrics text exposition (ends ``# EOF``)."""
    registry = registry or default_registry()
    out = []
    for fam in registry.collect():
        out.append(f"# TYPE {fam.name} {fam.kind}")
        if fam.help:
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        for key in sorted(fam.series):
            s = fam.series[key]
            if fam.kind == COUNTER:
                out.append(f"{fam.name}_total{_labels_str(key)} "
                           f"{_fmt(s.value)}")
            elif fam.kind == GAUGE:
                out.append(f"{fam.name}{_labels_str(key)} "
                           f"{_fmt(s.value)}")
            elif fam.kind == HISTOGRAM:
                cum, total_sum, count = s.snapshot()
                bounds = [_fmt(b) for b in s.buckets] + ["+Inf"]
                for bound, c in zip(bounds, cum):
                    ls = _labels_str(key, {"le": bound})
                    out.append(f"{fam.name}_bucket{ls} {c}")
                out.append(f"{fam.name}_count{_labels_str(key)} {count}")
                out.append(f"{fam.name}_sum{_labels_str(key)} "
                           f"{_fmt(total_sum)}")
    out.append("# EOF")
    return "\n".join(out) + "\n"
