"""Observability of the port (the port's own copy of :mod:`pddl_tpu.obs`).

`trace.py` — per-request spans (queue → admission → prefix match →
prefill chunks → decode ticks → retries/replays → finish), free when
disabled through the no-op :class:`NullTracer`. `ring.py` — the engine's
fixed-capacity per-tick telemetry ring. `export.py` — dependency-free
exporters: the atomic-append JSONL event log, the Prometheus text
exposition over ``ServeMetrics``, the engine, the fleet and the CUDA
allocator's device memory, and an optional stdlib ``/metrics`` endpoint.

Fleet-wide distributed tracing: `propagate.py` — wire trace contexts,
the worker span shipper and the router-side :class:`TraceCollector`;
`assemble.py` — stitching, gap checking and TTFT critical-path
attribution (CLI: ``python -m pddl_tpu_torch.obs.assemble``);
`flightrec.py` — the SIGKILL-surviving per-worker flight recorder
(imported directly, not re-exported here: it depends on the fleet
journal's file shim, and `obs` stays importable without the serving
stack).
"""

from pddl_tpu_torch.obs.export import (
    FLEET_COUNTER_KEYS,
    SERVE_COUNTER_KEYS,
    TOKEN_LATENCY_BUCKETS_S,
    TRAIN_COUNTER_KEYS,
    TTFT_BUCKETS_S,
    JsonlEventLog,
    MetricsHTTPServer,
    device_memory_gauges,
    engine_gauges,
    fleet_exposition,
    parse_prometheus_text,
    read_jsonl,
    render_prometheus,
    reservoir_histogram,
    serve_exposition,
    train_exposition,
)
from pddl_tpu_torch.obs.assemble import (
    TRACE_EVENTS,
    TRACE_SEGMENTS,
    Trace,
    stitch,
)
from pddl_tpu_torch.obs.propagate import (
    ClockAligner,
    SpanShipper,
    TraceCollector,
    estimate_offset,
)
from pddl_tpu_torch.obs.ring import TelemetryRing
from pddl_tpu_torch.obs.trace import (  # noqa: F401 - SCHEMA_VERSION too
    NULL_TRACER,
    SCHEMA_VERSION,
    NullTracer,
    RequestTracer,
    Span,
)

__all__ = [
    "ClockAligner",
    "FLEET_COUNTER_KEYS",
    "JsonlEventLog",
    "MetricsHTTPServer",
    "NULL_TRACER",
    "NullTracer",
    "RequestTracer",
    "SERVE_COUNTER_KEYS",
    "Span",
    "SpanShipper",
    "TRACE_EVENTS",
    "TRACE_SEGMENTS",
    "Trace",
    "TraceCollector",
    "estimate_offset",
    "stitch",
    "TelemetryRing",
    "device_memory_gauges",
    "engine_gauges",
    "fleet_exposition",
    "parse_prometheus_text",
    "read_jsonl",
    "render_prometheus",
    "reservoir_histogram",
    "serve_exposition",
    "TOKEN_LATENCY_BUCKETS_S",
    "TTFT_BUCKETS_S",
    "train_exposition",
    "TRAIN_COUNTER_KEYS",
]
