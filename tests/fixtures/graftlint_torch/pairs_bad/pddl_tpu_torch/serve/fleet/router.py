"""Bad twin: route labels the journal must classify."""

ROUTE_LABELS = ("affinity", "hedge")
