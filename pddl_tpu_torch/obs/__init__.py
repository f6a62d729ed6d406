"""Host-side observability of the port: the per-step telemetry ring
(``ring.py``) and per-request tracing (``trace.py``: the no-op
:data:`NULL_TRACER` the engine installs by default, and
:class:`RequestTracer`)."""

from pddl_tpu_torch.obs.ring import TelemetryRing
from pddl_tpu_torch.obs.trace import (
    NULL_TRACER,
    SCHEMA_VERSION,
    NullTracer,
    RequestTracer,
    Span,
)

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "RequestTracer",
    "SCHEMA_VERSION",
    "Span",
    "TelemetryRing",
]
