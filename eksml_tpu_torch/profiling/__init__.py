"""Profile attribution of the port: ``torch.profiler`` captures named by
model component (``attribution.py``), the scope ranges that name them
(``scopes.py``), the live device-memory gauges and the liveness peak of
a counted step (``memory.py``), and the step's roofline on the card
(``predict.py``: every operation of one real step counted by FLOPs,
bytes and component, priced on the H100's peaks)."""

from eksml_tpu_torch.profiling.attribution import (  # noqa: F401
    SCOPE_RULES, TraceAttribution, component_table, is_collective_kernel,
    is_collective_opcode, resolve_component, write_attribution_artifact)
from eksml_tpu_torch.profiling.memory import (  # noqa: F401
    analyze_memory, publish_hbm_gauges)
from eksml_tpu_torch.profiling.scopes import named_scope  # noqa: F401

__all__ = [
    "SCOPE_RULES", "TraceAttribution", "analyze_memory", "component_table",
    "is_collective_kernel", "is_collective_opcode", "named_scope",
    "publish_hbm_gauges", "resolve_component",
    "write_attribution_artifact",
]
