"""Bad twin: an emitter the trace-vocab rule reaches only
through its pair — it mints a typo'd event, and 'finish' goes stale."""


class Tracer:
    def on_queue(self, span, now):
        span.event(now, "queued")

    def on_finish(self, span, now):
        span.event(now, "finsh")
