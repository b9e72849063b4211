"""Profile attribution of the port: ``torch.profiler`` captures named by
model component (``attribution.py``), the scope ranges that name them
(``scopes.py``) and the live device-memory gauges (``memory.py``)."""

from eksml_tpu_torch.profiling.attribution import (  # noqa: F401
    SCOPE_RULES, TraceAttribution, component_table, is_collective_kernel,
    is_collective_opcode, resolve_component, write_attribution_artifact)
from eksml_tpu_torch.profiling.memory import publish_hbm_gauges  # noqa: F401
from eksml_tpu_torch.profiling.scopes import named_scope  # noqa: F401

__all__ = [
    "SCOPE_RULES", "TraceAttribution", "component_table",
    "is_collective_kernel", "is_collective_opcode", "named_scope",
    "publish_hbm_gauges", "resolve_component",
    "write_attribution_artifact",
]
