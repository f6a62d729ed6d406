"""Per-request tracing for the serving stack, Dapper-style spans (the
port's own copy of :mod:`pddl_tpu.obs.trace`, framework-free).

`ServeMetrics` answers "how is the engine doing" in aggregate; a span
answers "what happened to THIS request": its queue wait, its prefix
match, the prefill chunks it cost, the tick each token came from, its
retries, replays, preemptions and finish. One span per request from
submit to finish, every lifecycle transition a timestamped EVENT;
engine-level events (faults, retries, degraded flips) carry the same
``(step, site)`` coordinates the fault plan (`serve/faults.py`) fires
at, so an injection and its observed recovery line up one for one.

Cost discipline:

- **Disabled is free.** The engine's default tracer is
  :data:`NULL_TRACER`, whose every hook is a no-op method: no per-tick
  allocation, no branch beyond the call itself (the tests pin zero
  ``tracemalloc`` blocks from this module over an engine run).
- **Never a device sync.** Hooks receive host scalars the engine
  already has (wall times from ``perf_counter`` around a call, token
  ids the streaming path already copied to the host); no hook touches
  a device tensor.

Export: finished span records go to an optional ``sink`` (anything with
a ``write(record: dict)``, or a plain callable) and stay on
:attr:`RequestTracer.finished` for in-process readers; engine-level
events are ``kind="engine_event"`` records on
:attr:`RequestTracer.engine_events`. The hook surface is the JAX
package's, the fleet's and the trainer's hooks included, so a tracer
written for one package runs in the other.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

SCHEMA_VERSION = 1


class Span:
    """One request's timeline: trace/span ids, monotonic start/end, and
    an ordered list of timestamped events. Events past
    ``max_events`` are counted (``events_dropped``) instead of stored,
    so one million-token stream cannot balloon the tracer."""

    __slots__ = ("trace_id", "span_id", "name", "request_id", "start_s",
                 "end_s", "finish_reason", "attrs", "events",
                 "events_dropped", "_max_events", "last_requeue_s",
                 "decode_events")

    def __init__(self, trace_id: str, span_id: str, name: str,
                 request_id: int, start_s: float,
                 max_events: int = 4096):
        self.trace_id = trace_id
        self.span_id = span_id
        self.name = name
        self.request_id = request_id
        self.start_s = start_s
        self.end_s: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.attrs: Dict[str, object] = {}
        self.events: List[Dict[str, object]] = []
        self.events_dropped = 0
        self._max_events = max_events
        # Stamped by each replay requeue so the NEXT admission's
        # queue_wait_s measures time since the requeue, not since the
        # original submit (which would read as scheduler backlog).
        self.last_requeue_s: Optional[float] = None
        # High-frequency decode events get their OWN budget (tracked by
        # the tracer) so a long stream can never crowd the rare
        # lifecycle events (replay, re-admission, deadline_shed) out of
        # the overall cap.
        self.decode_events = 0

    def event(self, t_s: float, name: str, **attrs) -> None:
        if len(self.events) >= self._max_events:
            self.events_dropped += 1
            return
        ev: Dict[str, object] = {"t_s": t_s, "name": name}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def finish(self, t_s: float, reason: str) -> None:
        self.end_s = t_s
        self.finish_reason = reason

    def to_record(self) -> Dict[str, object]:
        """The schema-versioned record a sink receives (one JSONL line)."""
        return {
            "schema": SCHEMA_VERSION,
            "kind": "span",
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "name": self.name,
            "request_id": self.request_id,
            "start_s": self.start_s,
            "end_s": self.end_s,
            "duration_s": (None if self.end_s is None
                           else self.end_s - self.start_s),
            "finish_reason": self.finish_reason,
            "attrs": dict(self.attrs),
            "events": list(self.events),
            "events_dropped": self.events_dropped,
        }


class NullTracer:
    """The engine's default tracer: every hook is a no-op.

    The hook surface below IS the tracing contract — `engine.py` calls
    exactly these methods at exactly these lifecycle points, and any
    real tracer implements the same names. Keeping the disabled path a
    plain method call (no ``if tracer:`` branches scattered through the
    engine) is what makes "tracing off" indistinguishable from the
    pre-observability engine: no allocation, no conditional state, and
    the test suite pins zero ``tracemalloc`` blocks from this module
    across a full engine run.
    """

    enabled = False

    def on_submit(self, handle, queue_depth: int) -> None:
        """Request accepted into the queue."""

    def on_admit(self, handle, slot: int, replay: bool) -> None:
        """Popped from the queue into a slot (admission starts)."""

    def on_prefix_match(self, handle, blocks_hit: int,
                        tokens_saved: int) -> None:
        """Prefix-cache lookup result for this admission."""

    def on_prefill_chunk(self, handle, site: str, start: int, width: int,
                         wall_s: float) -> None:
        """One admission device dispatch (gather / chunk prefill)."""

    def on_first_token(self, handle, ttft_s: float) -> None:
        """First token sampled (TTFT settles)."""

    def on_token(self, handle, step: int) -> None:
        """One decode-tick token appended to the stream."""

    def on_tick(self, step: int, queue_depth: int, live_slots: int,
                new_tokens: int, wall_s: float) -> None:
        """One engine step completed (engine-level, not per-request)."""

    def on_retry(self, step: int, site: str, attempt: int) -> None:
        """A transient device failure is being retried."""

    def on_fault_injected(self, step: int, site: str, kind: str) -> None:
        """The fault plan fired (wired via ``FaultPlan.on_inject``)."""

    def on_replay(self, handle, step: int, requeued: bool) -> None:
        """Slot KV lost; request requeued for rebuild (or failed)."""

    def on_degraded_entry(self, step: int) -> None:
        """OOM flipped the engine degraded."""

    def on_degraded_exit(self, step: int, duration_s: float) -> None:
        """Degraded window closed (cache re-armed)."""

    def on_deadline_shed(self, handle) -> None:
        """Queued request shed at pop time (deadline expired)."""

    def on_preempt(self, handle, step: int) -> None:
        """Running best_effort slot parked for queued interactive
        work; the stream resumes later via replay admission."""

    def on_finish(self, handle, reason: str) -> None:
        """Request reached a terminal state."""

    def on_drain(self, step: int, n_requests: int) -> None:
        """Engine drained (snapshot taken)."""

    def on_fleet_event(self, name: str, **attrs) -> None:
        """A fleet-router lifecycle event (``serve/fleet/router.py``):
        replica_up/replica_down, circuit transitions, migration,
        shed, heartbeat_missed, orphaned, probe_failed. One generic hook —
        the event vocabulary belongs to the router, the transport (and
        the no-op discipline) to the tracer."""

    # --------------------------------------- distributed-tracing hooks
    # The fleet propagation layer and the flight recorder (the JAX
    # package's `obs/propagate.py`, `obs/flightrec.py`) report through
    # the same surface — all no-ops here, so tracing-off stays exactly
    # free (the tracemalloc pin covers these too).

    def on_trace_context(self, request_id: int, trace_id: str,
                         parent_span_id: Optional[str]) -> None:
        """The router's wire context arrived for an in-flight request:
        restamp its span into the fleet trace."""

    def on_restored(self, handle, n_tokens: int) -> None:
        """A drained/migrated/hand-off stream resumed in THIS engine
        with ``n_tokens`` already emitted elsewhere."""

    def on_chain_export(self, n_blocks: int, wall_s: float) -> None:
        """A prefix chain left this engine over the chain wire."""

    def on_chain_import(self, n_blocks: int, wall_s: float) -> None:
        """A prefix chain landed in this engine's host tier."""

    def on_span_shipped(self, n: int, dropped: int) -> None:
        """A span batch left the worker for the router (``dropped`` is
        the shipper's cumulative overflow counter)."""

    def on_flight_rotate(self, segments: int,
                         bytes_written: int) -> None:
        """The flight recorder sealed a segment."""

    # ------------------------------------------------- training hooks
    # The JAX Trainer's guarded boundary (`train/loop.py`) emits through
    # the SAME tracer surface the serving engine uses — `on_retry` and
    # `on_fault_injected` above are shared verbatim (the (step, site)
    # coordinate is the optimizer step and compiled-program name);
    # these three cover what only training has: checkpoints and the
    # restore+replay recovery.

    def on_checkpoint_saved(self, step: int, wall_s: float) -> None:
        """A step-granular verified checkpoint finished dispatching."""

    def on_restore(self, step: int, restored_step: int,
                   site: str) -> None:
        """Training state lost at ``(step, site)``; rolled back to the
        verified checkpoint at ``restored_step``."""

    def on_recovery(self, step: int, restored_step: int,
                    replayed: int) -> None:
        """In-process recovery completed: ``replayed`` steps re-run
        from the replay buffer, training resumes at ``step``."""


NULL_TRACER = NullTracer()


class RequestTracer(NullTracer):
    """The real tracer: one span per request, engine events alongside.

    Args:
      clock: monotonic timestamp source (pass the engine's injectable
        clock in tests so span times line up with deadlines).
      sink: optional record consumer — an object with
        ``write(record)`` (a JSONL event log)
        or a plain callable. Finished spans and engine events are
        written as they settle; nothing buffers unboundedly.
      max_events_per_span: per-span event cap (drops counted).
      max_decode_events_per_span: separate, smaller budget for the
        per-token ``decode`` events, so a long stream can never crowd
        rare lifecycle events (replay, re-admission, deadline shed)
        out of the overall cap.
      max_finished: retained finished-span records (a bounded deque —
        the sink holds the full history, the tracer a recent window).
      emit_ticks: also write one ``kind="tick"`` record per engine
        step to the sink (off by default — the engine's telemetry ring
        already holds per-tick records; turn this on when the JSONL
        log must be self-contained).
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 sink=None, max_events_per_span: int = 4096,
                 max_decode_events_per_span: int = 512,
                 max_finished: int = 4096, emit_ticks: bool = False):
        self._clock = clock
        self._write = (sink.write if hasattr(sink, "write")
                       else sink) if sink is not None else None
        self._max_events = int(max_events_per_span)
        self._max_decode = int(max_decode_events_per_span)
        self._emit_ticks = bool(emit_ticks)
        self.active: Dict[int, Span] = {}
        self.finished: Deque[Dict[str, object]] = deque(maxlen=max_finished)
        self.engine_events: Deque[Dict[str, object]] = deque(
            maxlen=max_finished)
        self.spans_started = 0
        self.spans_finished = 0
        self.sink_errors = 0
        self.spans_shipped = 0
        self.span_ship_drops = 0

    # --------------------------------------------------------- plumbing
    def _span(self, handle) -> Optional[Span]:
        return self.active.get(handle.request.request_id)

    def _emit(self, record: Dict[str, object]) -> None:
        if self._write is None:
            return
        try:
            self._write(record)
        except Exception:  # noqa: BLE001 - observability must never be
            # a fault source: a closed/full/broken sink degrades to
            # no-export (counted, and the in-process deques still hold
            # the records) instead of crashing the serving engine.
            self.sink_errors += 1

    def _engine_event(self, name: str, kind: str = "engine_event",
                      **attrs) -> None:
        ev: Dict[str, object] = {"schema": SCHEMA_VERSION,
                                 "kind": kind,
                                 "t_s": self._clock(), "name": name}
        ev.update(attrs)
        self.engine_events.append(ev)
        self._emit(ev)

    # ----------------------------------------------------- request hooks
    def on_submit(self, handle, queue_depth: int) -> None:
        rid = handle.request.request_id
        now = self._clock()
        span = Span(trace_id=f"{rid:016x}", span_id="0000000000000001",
                    name="request", request_id=rid, start_s=now,
                    max_events=self._max_events)
        span.attrs["prompt_len"] = len(handle.request.prompt)
        span.attrs["max_new_tokens"] = handle.request.max_new_tokens
        span.event(now, "queued", queue_depth=queue_depth)
        self.active[rid] = span
        self.spans_started += 1

    def on_admit(self, handle, slot: int, replay: bool) -> None:
        span = self._span(handle)
        if span is not None:
            now = self._clock()
            # A replay admission's queue wait counts from its requeue,
            # not from the original submit — otherwise the first
            # service attempt reads as scheduler backlog.
            base = (span.last_requeue_s
                    if replay and span.last_requeue_s is not None
                    else span.start_s)
            span.event(now, "admitted", slot=slot, replay=replay,
                       queue_wait_s=now - base)

    def on_prefix_match(self, handle, blocks_hit: int,
                        tokens_saved: int) -> None:
        span = self._span(handle)
        if span is not None:
            span.event(self._clock(), "prefix_match",
                       blocks_hit=blocks_hit, tokens_saved=tokens_saved)

    def on_prefill_chunk(self, handle, site: str, start: int, width: int,
                         wall_s: float) -> None:
        span = self._span(handle)
        if span is not None:
            span.event(self._clock(), "prefill_chunk", site=site,
                       start=start, width=width, wall_s=wall_s)

    def on_first_token(self, handle, ttft_s: float) -> None:
        span = self._span(handle)
        if span is not None:
            span.attrs["ttft_s"] = ttft_s
            span.event(self._clock(), "first_token", ttft_s=ttft_s)

    def on_token(self, handle, step: int) -> None:
        span = self._span(handle)
        if span is not None:
            if span.decode_events >= self._max_decode:
                span.events_dropped += 1
                return
            span.decode_events += 1
            span.event(self._clock(), "decode", step=step)

    def on_finish(self, handle, reason: str) -> None:
        span = self.active.pop(handle.request.request_id, None)
        if span is None:
            return
        span.attrs["tokens_emitted"] = len(handle.tokens)
        span.attrs["replays"] = handle.replays
        span.finish(self._clock(), reason)
        record = span.to_record()
        self.finished.append(record)
        self.spans_finished += 1
        self._emit(record)

    def on_deadline_shed(self, handle) -> None:
        span = self._span(handle)
        if span is not None:
            span.event(self._clock(), "deadline_shed")

    def on_preempt(self, handle, step: int) -> None:
        span = self._span(handle)
        if span is not None:
            now = self._clock()
            span.last_requeue_s = now  # replay admission waits from HERE
            span.event(now, "preempted", step=step,
                       priority=handle.request.priority.value)
        self._engine_event("preempted", step=step,
                           request_id=handle.request.request_id)

    def on_replay(self, handle, step: int, requeued: bool) -> None:
        span = self._span(handle)
        if span is not None:
            now = self._clock()
            if requeued:
                span.last_requeue_s = now
            span.event(now, "replay", step=step, requeued=requeued)
        self._engine_event("replay", step=step,
                           request_id=handle.request.request_id,
                           requeued=requeued)

    # ------------------------------------------------------ engine hooks
    def on_tick(self, step: int, queue_depth: int, live_slots: int,
                new_tokens: int, wall_s: float) -> None:
        if self._emit_ticks:
            self._emit({"schema": SCHEMA_VERSION, "kind": "tick",
                        "t_s": self._clock(), "step": step,
                        "queue_depth": queue_depth,
                        "live_slots": live_slots,
                        "new_tokens": new_tokens, "wall_s": wall_s})

    def on_retry(self, step: int, site: str, attempt: int) -> None:
        self._engine_event("retry", step=step, site=site, attempt=attempt)

    def on_fault_injected(self, step: int, site: str, kind: str) -> None:
        self._engine_event("fault_injected", step=step, site=site,
                           kind=kind)

    def on_degraded_entry(self, step: int) -> None:
        self._engine_event("degraded_entry", step=step)

    def on_degraded_exit(self, step: int, duration_s: float) -> None:
        self._engine_event("degraded_exit", step=step,
                           duration_s=duration_s)

    def on_fleet_event(self, name: str, **attrs) -> None:
        # Rides the engine-event record stream (same deque, same sink)
        # with kind="fleet_event", so events_named() and the JSONL log
        # cover the fleet without a second pipeline.
        self._engine_event(name, kind="fleet_event", **attrs)

    # --------------------------------------- distributed-tracing hooks
    def on_trace_context(self, request_id: int, trace_id: str,
                         parent_span_id: Optional[str]) -> None:
        span = self.active.get(request_id)
        if span is None:
            return
        if trace_id:
            span.trace_id = trace_id
        if parent_span_id is not None:
            span.attrs["parent_span_id"] = parent_span_id

    def on_restored(self, handle, n_tokens: int) -> None:
        # A restored stream gets a fresh span (the original lives in
        # the source engine's record stream); the router's trace
        # context arrives right after and restamps the trace id.
        rid = handle.request.request_id
        now = self._clock()
        span = Span(trace_id=f"{rid:016x}",
                    span_id="0000000000000001",
                    name="request", request_id=rid, start_s=now,
                    max_events=self._max_events)
        span.attrs["prompt_len"] = len(handle.request.prompt)
        span.attrs["max_new_tokens"] = handle.request.max_new_tokens
        span.attrs["restored"] = True
        span.event(now, "restored", n_tokens=int(n_tokens))
        self.active[rid] = span
        self.spans_started += 1

    def on_chain_export(self, n_blocks: int, wall_s: float) -> None:
        self._engine_event("chain_export", n_blocks=n_blocks,
                           wall_s=wall_s)

    def on_chain_import(self, n_blocks: int, wall_s: float) -> None:
        self._engine_event("chain_import", n_blocks=n_blocks,
                           wall_s=wall_s)

    def on_span_shipped(self, n: int, dropped: int) -> None:
        self.spans_shipped += int(n)
        self.span_ship_drops = max(self.span_ship_drops, int(dropped))

    def on_flight_rotate(self, segments: int,
                         bytes_written: int) -> None:
        self._engine_event("flight_rotate", segments=segments,
                           bytes_written=bytes_written)

    # ------------------------------------------------- training hooks
    def on_checkpoint_saved(self, step: int, wall_s: float) -> None:
        self._engine_event("checkpoint_saved", step=step, wall_s=wall_s)

    def on_restore(self, step: int, restored_step: int,
                   site: str) -> None:
        self._engine_event("restore", step=step,
                           restored_step=restored_step, site=site)

    def on_recovery(self, step: int, restored_step: int,
                    replayed: int) -> None:
        self._engine_event("recovery", step=step,
                           restored_step=restored_step, replayed=replayed)

    def on_drain(self, step: int, n_requests: int) -> None:
        self._engine_event("drain", step=step, n_requests=n_requests)
        # Flush every in-flight span: the drained requests resume in a
        # FRESH engine (new tracer), so these spans would otherwise
        # never reach the sink — at exactly the moment a postmortem
        # needs them. ``finish_reason="drained"`` is not a terminal
        # request state; it marks a span cut short by the snapshot.
        now = self._clock()
        for rid in sorted(self.active):
            span = self.active.pop(rid)
            span.attrs["drained"] = True
            span.finish(now, "drained")
            record = span.to_record()
            self.finished.append(record)
            self.spans_finished += 1
            self._emit(record)

    # -------------------------------------------------------- inspection
    def events_named(self, name: str) -> List[Dict[str, object]]:
        """Engine events with ``name`` (test/debug convenience)."""
        return [e for e in self.engine_events if e["name"] == name]
