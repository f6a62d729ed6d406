"""Host-side observability of the port (the per-step telemetry ring)."""
