"""Good twin: counter typing paired with
``ServeMetrics.snapshot`` by path."""

SERVE_COUNTER_KEYS = frozenset({"requests_finished"})
