"""Cross-process trace-context propagation for the fleet.

The port's own copy of :mod:`pddl_tpu.obs.propagate` (host Python, no
JAX): the same names, error texts, literal tables and wire shapes.

`obs/trace.py` gives ONE engine Dapper-style spans; this module is the
glue that makes one trace span the whole fleet. Three pieces, all
dependency-free and transport-agnostic:

- **Context minting** (:func:`trace_id_for_rid`,
  :meth:`TraceCollector.context_for`): the router stamps
  ``(trace_id, parent_span_id)`` onto every submit/restore/chain pipe
  command. The trace id is the PRIMARY rid (hedge copies and the
  hand-off's fresh rid alias back to it — the same alias discipline
  the journal uses), so every process's records key to one trace
  without any cross-process id negotiation.
- **Span shipping** (:class:`SpanShipper`): a worker buffers its
  finished span records — bounded, drops counted, never blocking the
  engine loop — and ships them back piggybacked on the pong/event
  reads the pipe already does.
- **Collection** (:class:`TraceCollector`): the router-side ledger —
  one ``kind="fleet_span"`` record per stream (submit/route/hedge/
  restore/hand-off/finish events on the ROUTER's clock) plus every
  replica span record received, each tagged with the replica's
  estimated clock offset so `obs/assemble.py` can place all the
  timelines on one axis.

Clock alignment is NTP-style off the existing ping/pong heartbeat:
the router stamps its send time on each ping, the worker echoes it
back with its own ``time.monotonic()``, and the sample taken at the
smallest round-trip wins (:class:`ClockAligner`) — minimal RTT means
minimal asymmetry error.

Every event-name literal emitted here is machine-checked against the
assembler's ``TRACE_EVENTS`` vocabulary .
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

# A trace context on the wire: (trace_id, parent_span_id).
TraceContext = Tuple[str, str]


def trace_id_for_rid(rid: int) -> str:
    """The fleet trace id: the PRIMARY router rid, zero-padded hex —
    the same shape engine-local spans mint from their request ids, so
    a record's trace id never needs a second id namespace."""
    return f"{int(rid):016x}"


# ------------------------------------------------------ clock alignment


def estimate_offset(send_s: float, recv_s: float,
                    remote_mono_s: float) -> Tuple[float, float]:
    """One NTP-style sample: ``(offset_s, rtt_s)`` where ``offset_s``
    is the remote monotonic clock minus the local one (midpoint
    assumption: the remote read its clock halfway through the round
    trip). ``local_time = remote_time - offset_s``."""
    rtt = recv_s - send_s
    offset = remote_mono_s - (send_s + recv_s) / 2.0
    return offset, rtt


class ClockAligner:
    """Minimal-RTT offset keeper for one remote process: of every
    ping/pong sample observed, the one with the smallest round trip
    carries the smallest asymmetry error, so it wins outright —
    the classic NTP filter, one float of state per replica."""

    __slots__ = ("offset_s", "best_rtt_s", "samples")

    def __init__(self):
        self.offset_s: Optional[float] = None
        self.best_rtt_s: Optional[float] = None
        self.samples = 0

    def observe(self, send_s: float, recv_s: float,
                remote_mono_s: float) -> None:
        offset, rtt = estimate_offset(send_s, recv_s, remote_mono_s)
        if rtt < 0.0:
            return  # clock went backwards across the sample: discard
        self.samples += 1
        if self.best_rtt_s is None or rtt < self.best_rtt_s:
            self.best_rtt_s = rtt
            self.offset_s = offset


# --------------------------------------------------------- span shipping


class SpanShipper:
    """The worker-side span buffer: bounded (a stalled pipe must never
    balloon a worker), drops counted (the assembler reports them as a
    known blind spot instead of a silent one), drained in batches onto
    whatever event the transport is already sending."""

    __slots__ = ("_buf", "capacity", "dropped", "shipped")

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._buf: Deque[Dict[str, object]] = deque()
        self.dropped = 0
        self.shipped = 0

    def add(self, record: Dict[str, object]) -> bool:
        if len(self._buf) >= self.capacity:
            self.dropped += 1
            return False
        self._buf.append(record)
        return True

    def drain(self, max_records: Optional[int] = 64
              ) -> List[Dict[str, object]]:
        out: List[Dict[str, object]] = []
        while self._buf and (max_records is None
                             or len(out) < max_records):
            out.append(self._buf.popleft())
        self.shipped += len(out)
        return out

    def __len__(self) -> int:
        return len(self._buf)


def chain_export_span(ctx: Optional[TraceContext], t0: float, t1: float,
                      n_blocks: int, *, replica=None,
                      role: Optional[str] = None) -> Dict[str, object]:
    """The chain-wire transfer's OUT half as a span record — minted by
    the worker around ``export_prefix_chain`` so a hand-off's trace
    shows the D2H export wall on the prefill replica's own clock."""
    return _chain_span("chain_export", ctx, t0, t1, n_blocks,
                       replica, role)


def chain_import_span(ctx: Optional[TraceContext], t0: float, t1: float,
                      n_blocks: int, *, replica=None,
                      role: Optional[str] = None) -> Dict[str, object]:
    """The transfer's IN half: the host-tier landing on the decode
    replica."""
    return _chain_span("chain_import", ctx, t0, t1, n_blocks,
                       replica, role)


def _chain_span(name: str, ctx: Optional[TraceContext], t0: float,
                t1: float, n_blocks: int, replica,
                role: Optional[str]) -> Dict[str, object]:
    tid, psid = (ctx[0], ctx[1]) if ctx else (None, None)
    return {
        "schema": SCHEMA_VERSION,
        "kind": "span",
        "trace_id": tid,
        "span_id": name,
        "name": name,
        "request_id": None,
        "start_s": t0,
        "end_s": t1,
        "duration_s": t1 - t0,
        "finish_reason": "transferred",
        "attrs": {"parent_span_id": psid, "n_blocks": int(n_blocks)},
        "events": [{"t_s": t1, "name": name, "n_blocks": int(n_blocks),
                    "wall_s": t1 - t0}],
        "events_dropped": 0,
        "replica": replica,
        "role": role,
    }


# ------------------------------------------------------------ collection


class TraceCollector:
    """The router-side trace ledger (armed via ``FleetRouter(...,
    dtrace=True)``).

    One ``kind="fleet_span"`` record per stream, keyed by PRIMARY rid
    — hedge copies and hand-off rebinds alias to it, so the router's
    submit/route/hedge/restore/hand-off/finish events and every
    replica's span records share one trace id. Replica records land
    via :meth:`add_replica_records` (pipe batches or a dead worker's
    flight-recorder harvest) tagged with the replica's estimated
    clock offset when one is known.

    Bounded everywhere: at most ``max_traces`` live router records
    (oldest TERMINAL records retire first) and ``max_replica_records``
    replica spans, overflow counted in ``records_dropped`` — tracing
    must never become the router's memory leak.
    """

    def __init__(self, clock=time.monotonic, *,
                 max_traces: int = 8192,
                 max_replica_records: int = 65536):
        self._clock = clock
        self._records: "Dict[int, Dict[str, object]]" = {}
        self._order: Deque[int] = deque()
        self._alias: Dict[int, int] = {}
        self._replica_records: Deque[Dict[str, object]] = deque(
            maxlen=int(max_replica_records))
        self._aligners: Dict[int, ClockAligner] = {}
        self._max_traces = int(max_traces)
        self.records_dropped = 0
        self.flight_records = 0
        self.spans_dropped_remote = 0

    # ------------------------------------------------------- identity
    def primary_rid(self, rid: int) -> int:
        return self._alias.get(int(rid), int(rid))

    def context_for(self, rid: int) -> TraceContext:
        """The wire context for a submit/restore/chain command keyed
        by ``rid`` — pure (no record is opened), so a failed routing
        attempt leaves no phantom trace."""
        return (trace_id_for_rid(self.primary_rid(rid)), "router")

    def alias(self, rid: int, primary_rid: int) -> None:
        """Bind a secondary rid (hedge copy) to its primary."""
        self._alias[int(rid)] = self.primary_rid(primary_rid)

    def rebind(self, old_rid: int, new_rid: int) -> None:
        """The hand-off rebind: the stream continues under a FRESH
        rid; its records keep flowing into the original trace."""
        self._alias[int(new_rid)] = self.primary_rid(old_rid)

    # ------------------------------------------------- router records
    def _record(self, rid: int) -> Dict[str, object]:
        primary = self.primary_rid(rid)
        rec = self._records.get(primary)
        if rec is None:
            rec = {
                "schema": SCHEMA_VERSION,
                "kind": "fleet_span",
                "trace_id": trace_id_for_rid(primary),
                "rid": primary,
                "start_s": self._clock(),
                "end_s": None,
                "state": None,
                "reason": None,
                "n_tokens": 0,
                "ttft_s": None,
                "events": [],
            }
            self._records[primary] = rec
            self._order.append(primary)
            self._evict()
        return rec

    def _evict(self) -> None:
        while len(self._records) > self._max_traces:
            # Retire the oldest TERMINAL record first; a fleet holding
            # more than max_traces LIVE streams loses the oldest live
            # one (counted) rather than growing without bound.
            victim = None
            for rid in self._order:
                rec = self._records.get(rid)
                if rec is not None and rec["state"] is not None:
                    victim = rid
                    break
            if victim is None:
                victim = self._order[0]
            self._order.remove(victim)
            self._records.pop(victim, None)
            self.records_dropped += 1

    def _event(self, rid: int, name: str, **attrs) -> Dict[str, object]:
        rec = self._record(rid)
        ev: Dict[str, object] = {"t_s": self._clock(), "name": name}
        if attrs:
            ev.update(attrs)
        rec["events"].append(ev)  # type: ignore[union-attr]
        return rec

    def on_submit(self, rid: int, *, prompt_len: int, priority: str,
                  session: Optional[str] = None) -> None:
        rec = self._event(rid, "submit", prompt_len=int(prompt_len),
                          priority=priority)
        if session is not None:
            rec["session"] = session

    def on_route(self, rid: int, replica_id: int, how: str) -> None:
        self._event(rid, "route", replica=int(replica_id), how=how)

    def on_hedge(self, hedge_rid: int, primary_rid: int,
                 replica_id: int) -> None:
        self.alias(hedge_rid, primary_rid)
        self._event(primary_rid, "hedge", replica=int(replica_id),
                    hedge_rid=int(hedge_rid))

    def on_restore(self, rid: int, replica_id: int, via: str) -> None:
        self._event(rid, "restore", replica=int(replica_id), via=via)

    def on_first_token(self, rid: int, ttft_s: float) -> None:
        rec = self._record(rid)
        if rec["ttft_s"] is None:
            rec["ttft_s"] = float(ttft_s)
            self._event(rid, "first_token", ttft_s=float(ttft_s))

    def on_handoff(self, rid: int, from_replica: int, to_replica: int,
                   export_s: float, import_s: float,
                   blocks: int) -> None:
        """Stamp a completed prefill->decode hand-off (``rid`` is the
        FRESH rid, already rebound to the original trace)."""
        self._event(rid, "handoff", from_replica=int(from_replica),
                    to_replica=int(to_replica), blocks=int(blocks))
        self._event(rid, "handoff_export", wall_s=float(export_s))
        self._event(rid, "handoff_import", wall_s=float(import_s))

    def on_finish(self, rid: int, state: str, reason: Optional[str],
                  n_tokens: int, ttft_s: Optional[float] = None) -> None:
        rec = self._event(rid, "finish", state=state)
        rec["state"] = state
        rec["reason"] = reason
        rec["n_tokens"] = max(int(rec["n_tokens"] or 0), int(n_tokens))
        rec["end_s"] = self._clock()
        if ttft_s is not None:
            # The engine-measured TTFT outranks the router's event-
            # arrival stamp (same adoption rule the router applies).
            rec["ttft_s"] = float(ttft_s)

    # ------------------------------------------------ replica records
    def observe_clock(self, replica_id: int, send_s: float,
                      recv_s: float, remote_mono_s: float) -> None:
        self._aligners.setdefault(
            int(replica_id), ClockAligner()).observe(
            send_s, recv_s, remote_mono_s)

    def set_offset(self, replica_id: int,
                   offset_s: Optional[float]) -> None:
        """Adopt a driver-estimated offset (`ProcessReplica` keeps its
        own min-RTT estimate off the heartbeat it already runs)."""
        if offset_s is None:
            return
        aligner = self._aligners.setdefault(int(replica_id),
                                            ClockAligner())
        aligner.offset_s = float(offset_s)
        aligner.samples += 1

    def clock_offset(self, replica_id: int) -> Optional[float]:
        aligner = self._aligners.get(int(replica_id))
        return None if aligner is None else aligner.offset_s

    def add_replica_records(self, replica_id: int,
                            records: List[Dict[str, object]], *,
                            source: str = "pipe") -> int:
        """Fold a batch of worker span records in, tagged with their
        replica, transport (``pipe`` vs ``flightrec``), and the
        replica's current clock-offset estimate."""
        added = 0
        offset = self.clock_offset(replica_id)
        for rec in records:
            rec = dict(rec)
            rec.setdefault("replica", int(replica_id))
            rec["source"] = source
            if offset is not None:
                rec.setdefault("clock_offset_s", offset)
            self._replica_records.append(rec)
            added += 1
            if source == "flightrec":
                self.flight_records += 1
        return added

    def note_remote_drops(self, dropped: int) -> None:
        """Adopt a worker shipper's cumulative drop counter (the max
        across reports — it only grows on the worker's side)."""
        self.spans_dropped_remote = max(self.spans_dropped_remote,
                                        int(dropped))

    # ----------------------------------------------------- inspection
    def records(self) -> List[Dict[str, object]]:
        """Every record the collector holds — router fleet_spans (in
        submit order) then replica spans — ready for
        :func:`pddl_tpu_torch.obs.assemble.stitch`."""
        out: List[Dict[str, object]] = [
            dict(self._records[rid]) for rid in self._order
            if rid in self._records]
        out.extend(dict(r) for r in self._replica_records)
        return out

    def trace_ids(self) -> List[str]:
        return [trace_id_for_rid(rid) for rid in self._order
                if rid in self._records]

    def dump(self, path: str) -> int:
        """Write every record as JSONL (the assembler CLI's input);
        returns the record count."""
        records = self.records()
        with open(path, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec, separators=(",", ":"),
                                   default=_json_default) + "\n")
        return len(records)


def _json_default(obj):
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")
