"""Good twin: route labels the journal must classify."""

ROUTE_LABELS = ("affinity", "least_loaded")
