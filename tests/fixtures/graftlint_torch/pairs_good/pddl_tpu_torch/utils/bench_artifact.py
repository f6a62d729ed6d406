"""The bench-artifact direction vocabulary."""

_HIGHER_BETTER = ("tokens_per_s", "speedup")
_LOWER_BETTER = ("_ms",)
_NEVER = ("samples",)
