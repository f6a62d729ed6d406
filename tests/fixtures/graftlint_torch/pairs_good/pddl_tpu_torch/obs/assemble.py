"""Good twin: the assembler's vocabulary, paired with
``pddl_tpu_torch/obs/trace.py`` by path."""

TRACE_EVENTS = ("queued", "finish")
