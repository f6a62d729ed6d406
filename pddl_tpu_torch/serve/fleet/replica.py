"""Replica drivers: one engine behind a uniform router-facing surface.

The port's own copy of :mod:`pddl_tpu.serve.fleet.replica` (host Python,
no JAX): the same names, error texts, literal tables and wire shapes.

The router (`fleet/router.py`) speaks one small protocol no matter how
a replica actually runs:

- ``submit(rid, ...)`` / ``cancel(rid)`` — requests enter keyed by a
  ROUTER-assigned id (engine request ids are per-process counters and
  mean nothing across a fleet).
- ``step() -> events`` — advance/pump the replica; returns the token
  and finish events since the last call as plain dicts (the same
  shapes the process worker writes over its pipe, so the router cannot
  care which driver produced them).
- ``drain_entries(now) -> [(rid, entry)]`` — the live-migration
  capture: every in-flight request's host state in the
  `serve/drain.py` wire format, rid-tagged. Raises when the replica is
  beyond draining (hard-killed process) — the router then falls back
  to its own prompt+emitted-token mirrors, which is exactly the engine's
  in-engine replay contract promoted to the fleet level.
- ``restore(pairs)`` — live migration in: wire entries re-enter this
  replica's engine through the normal drain-restore replay path, so a
  migrated stream continues token-exactly.

Two drivers:

- :class:`LocalReplica` — in-process :class:`~pddl_tpu_torch.serve.ServeEngine`
  stepped by the router. Deterministic (injectable clocks/fault plans
  reach the engine directly), so the tier-1 fleet chaos matrix runs on
  it; a replica "dies" when :class:`~pddl_tpu_torch.utils.faults.KillPoint`
  (or a real error) unwinds out of ``step()``.
- :class:`ProcessReplica` — a real OS process (`fleet/worker.py`)
  driven over a stdio JSON-line pipe; pings are the heartbeat, EOF or
  ``SIGKILL`` is death. This is the "multiprocess on CPU" deployment
  the bench measures: N workers genuinely run in parallel.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from pddl_tpu_torch.obs.propagate import ClockAligner, SpanShipper
from pddl_tpu_torch.serve import drain as drain_io
from pddl_tpu_torch.serve.fleet.disagg import validate_role
from pddl_tpu_torch.serve.fleet.transport import (
    MAX_FRAME_BYTES,
    FrameReceiver,
    FrameSender,
    decode_control,
    encode_control,
)
from pddl_tpu_torch.serve.request import (
    Priority,
    QueueFull,
    RequestState,
    SamplingParams,
)


class ReplicaDied(RuntimeError):
    """The replica is gone mid-operation (process exited, pipe EOF).
    The router treats this exactly like a ``KillPoint`` unwinding out of
    a local replica's step: replica down, migrate the in-flight work."""

    def __init__(self, replica_id: int, why: str):
        self.replica_id = replica_id
        super().__init__(f"replica {replica_id} died: {why}")


class ReplicaSpawnTimeout(ReplicaDied):
    """A spawned worker never became ready inside its budget. Subclass
    of :class:`ReplicaDied` (every existing handler still catches it),
    but TYPED so a scale-up controller can tell "this spawn wedged —
    back off and retry later" from "a serving replica died — migrate
    its work": the autoscaler keys its breaker-style spawn backoff off
    this, instead of hanging the router's control loop behind a worker
    that will never ack."""

    def __init__(self, replica_id: int, waited_s: float):
        self.waited_s = float(waited_s)
        super().__init__(replica_id,
                         f"spawn timed out after {waited_s:.1f}s "
                         "(worker never became ready)")


class EpochFenced(RuntimeError):
    """The worker refused a command stamped with a STALE fencing epoch
   : a newer router has taken over and this
    driver's caller is the deposed primary. Deliberately NOT a
    :class:`ReplicaDied` — the replica is healthy and serving the new
    epoch's commands; the correct reaction is to stop commanding, not
    to migrate the replica's work."""

    def __init__(self, replica_id: int, epoch: int, highest: int):
        self.replica_id = int(replica_id)
        self.epoch = int(epoch)
        self.highest = int(highest)
        super().__init__(
            f"replica {replica_id} fenced epoch {epoch} command "
            f"(highest seen: {highest})")


# Machine-checked fencing manifest: the
# exact worker-bound command kinds the drivers below stamp with the
# issuing router's epoch — the fleet-state mutators plus the ``fence``
# probe itself. The worker's FENCED_CMDS dispatch table must equal
# this tuple, both directions: a command stamped here but unchecked
# there is a hole a deposed primary drives through; one checked there
# but never stamped here would fence every legacy (epoch-free) caller.
EPOCH_CMDS = ("submit", "cancel", "restore", "fence")


# The submit protocol's sampling wire shape IS the drain snapshot's —
# one encode/decode pair (`serve/drain.py`) for both.
sampling_to_wire = drain_io.encode_sampling
sampling_from_wire = drain_io.decode_sampling


def snapshot_from_pairs(pairs: List[Tuple[int, Dict]]) -> Dict[str, object]:
    """rid-tagged wire entries → a `serve/drain.py` snapshot dict the
    engine's ``restore()`` accepts. The one place the fleet assembles a
    snapshot (both drivers and the worker's restore handler), so a
    format/version change happens here, not in three copies."""
    return {"version": drain_io.SNAPSHOT_VERSION,
            "requests": [entry for _, entry in pairs]}


class HandleLedger:
    """rid → engine handle, plus the diff cursor that turns polled
    handle state into incremental events. Shared by :class:`LocalReplica`
    and the process worker so both emit identical event streams."""

    def __init__(self):
        self._handles: Dict[int, object] = {}
        self._sent: Dict[int, int] = {}

    def add(self, rid: int, handle) -> None:
        self._handles[rid] = handle
        # A restored/migrated handle arrives with its pre-migration
        # tokens attached; those were already streamed to the caller.
        self._sent[rid] = len(handle.tokens)

    def get(self, rid: int):
        return self._handles.get(rid)

    def harvest(self) -> List[Dict[str, object]]:
        """Events since the last harvest: one ``tokens`` event batching
        every stream's new tokens, then a ``finish`` per settled
        request (token order inside a tick does not matter — each
        stream's own order is what token-exactness pins)."""
        events: List[Dict[str, object]] = []
        toks: List[Tuple[int, List[int]]] = []
        done: List[int] = []
        for rid, h in self._handles.items():
            sent = self._sent[rid]
            if len(h.tokens) > sent:
                toks.append((rid, [int(t) for t in h.tokens[sent:]]))
                self._sent[rid] = len(h.tokens)
            if h.done:
                done.append(rid)
        if toks:
            events.append({"ev": "tokens", "toks": toks})
        for rid in done:
            h = self._handles.pop(rid)
            self._sent.pop(rid, None)
            events.append({
                "ev": "finish", "rid": rid, "state": h.state.value,
                "reason": (h.finish_reason.value
                           if h.finish_reason is not None else None),
                "ttft_s": h.ttft_s, "n_tokens": len(h.tokens)})
        return events

    def drain_entries(self, now_s: float) -> List[Tuple[int, Dict]]:
        """Every in-flight request as a rid-tagged drain wire entry,
        running-first FCFS order (the drain discipline: restore owes
        the oldest running stream the earliest re-admission)."""
        live = [(rid, h) for rid, h in self._handles.items() if not h.done]
        live.sort(key=lambda p: (p[1].state is not RequestState.RUNNING,
                                 p[1].arrival_s))
        return [(rid, drain_io.encode_handle(h, now_s)) for rid, h in live]

    def __len__(self) -> int:
        return len(self._handles)


class LocalReplica:
    """An in-process engine replica, stepped by the router.

    ``engine_factory()`` builds (and rebuilds, after a death) the
    :class:`~pddl_tpu_torch.serve.ServeEngine`; keeping construction in a
    factory is what makes the circuit breaker's HALF_OPEN probe a real
    respawn instead of a pointless ping at a dead object.

    ``role`` is the replica's place in a disaggregated fleet
    (`fleet/disagg.py`): ``prefill``, ``decode``, or ``unified`` (the
    default — both phases, the pre-disaggregation behavior). The role is
    router-side policy; the engine underneath is identical.
    """

    can_respawn = True

    def __init__(self, replica_id: int, engine_factory, *,
                 role: str = "unified"):
        self.replica_id = int(replica_id)
        self.role = validate_role(role)
        self._factory = engine_factory
        self.engine = engine_factory()
        self._ledger = HandleLedger()
        # Distributed tracing: finished engine spans are
        # pumped into this buffer (rid-tagged) for the router's
        # collector; inert unless the engine has an enabled tracer.
        self._span_buf = SpanShipper()
        self._trace_rids: Dict[int, int] = {}
        self._dtrace_armed = False
        # Highest fencing epoch seen. -1 =
        # never fenced; survives respawn() — the engine dies, the
        # single-writer promise does not.
        self.fence_epoch = -1

    # ------------------------------------------------------------ fencing
    def _check_epoch(self, epoch) -> None:
        """The worker-side fencing decision, in-object: a command
        carrying an epoch below the highest seen is refused with the
        typed reject; an equal-or-higher epoch is adopted. ``None``
        (an epoch-free caller, every pre-HA fleet) always passes."""
        if epoch is None:
            return
        if int(epoch) < self.fence_epoch:
            raise EpochFenced(self.replica_id, int(epoch),
                              self.fence_epoch)
        self.fence_epoch = int(epoch)

    def fence(self, epoch: int) -> int:
        """Adopt ``epoch`` as the floor for future commands (the
        promotion probe): returns the highest epoch now held. Raises
        :class:`EpochFenced` when the CALLER is the stale one."""
        self._check_epoch(int(epoch))
        return self.fence_epoch

    # ------------------------------------------------------------- intake
    def submit(self, rid: int, prompt, max_new_tokens: int,
               sampling: SamplingParams, deadline_s,
               priority: Priority = Priority.INTERACTIVE,
               adapter=None, constraint=None, trace=None,
               epoch=None) -> None:
        self._check_epoch(epoch)
        handle = self.engine.submit(prompt, max_new_tokens,
                                    sampling=sampling, deadline_s=deadline_s,
                                    priority=priority, adapter=adapter,
                                    constraint=constraint)
        self._ledger.add(rid, handle)
        self._apply_trace(rid, handle, trace)

    def _apply_trace(self, rid: int, handle, trace) -> None:
        tracer = self.engine.tracer
        if not tracer.enabled:
            return
        eng_rid = handle.request.request_id
        self._trace_rids[eng_rid] = int(rid)
        if trace is not None:
            tracer.on_trace_context(eng_rid, str(trace[0]), trace[1])

    def cancel(self, rid: int, epoch=None) -> None:
        self._check_epoch(epoch)
        h = self._ledger.get(rid)
        if h is not None:
            h.cancel()

    # ------------------------------------------------------------ serving
    def warmup(self) -> None:
        self.engine.warmup()

    def step(self) -> List[Dict[str, object]]:
        self.engine.step()
        self._pump_spans()
        return self._ledger.harvest()

    def _pump_spans(self) -> None:
        """Move finished engine spans (rid-tagged, replica-tagged) into
        the span buffer — destructive on the tracer's deque, so each
        record ships exactly once."""
        tracer = self.engine.tracer
        if not tracer.enabled:
            return
        finished = getattr(tracer, "finished", None)
        if not finished:
            return
        while True:
            try:
                rec = finished.popleft()
            except IndexError:
                break
            rec = dict(rec)
            rec["rid"] = self._trace_rids.pop(rec.get("request_id"), None)
            rec["replica"] = self.replica_id
            rec["role"] = self.role
            self._span_buf.add(rec)

    def take_span_records(self) -> List[Dict[str, object]]:
        """Span records since the last call (the router's collector
        drains this each step)."""
        self._pump_spans()
        return self._span_buf.drain(None)

    def flush_spans(self) -> None:
        """Death-path flush: cut every in-flight span short (the same
        ``drained`` discipline the engine's own drain applies) so the
        postmortem trace covers streams that never finished."""
        tracer = self.engine.tracer
        try:
            if tracer.enabled and tracer.active:
                tracer.on_drain(0, len(tracer.active))
        except Exception:  # noqa: BLE001 - the engine may be wedged
            pass
        self._pump_spans()

    def clock_offset(self) -> Optional[float]:
        """In-process replicas share the router's clock."""
        return 0.0

    @property
    def queue_depth(self) -> int:
        return self.engine.scheduler.depth

    @property
    def live_slots(self) -> int:
        return self.engine.live_slots

    @property
    def degraded(self) -> bool:
        """The engine's OOM-degraded flag — the router's overload
        detector reads it as pressure (memory pressure IS overload)."""
        return self.engine.degraded

    def compile_counts(self) -> Dict[str, int]:
        return self.engine.compile_counts()

    # --------------------------------------------------------- resilience
    def drain_entries(self, now_s: float) -> List[Tuple[int, Dict]]:
        """Live-migration capture. The engine's own ``drain()`` is also
        invoked (idempotent) so admission stops and in-flight tracer
        spans flush; the rid-tagged entries come from the ledger —
        identical wire format, but keyed for the router.

        ``now_s`` (the ROUTER's clock) is ignored for encoding: each
        handle's ``arrival_s`` was stamped on the ENGINE's clock, and
        ``elapsed_s`` (the consumed deadline budget) only means
        anything as a same-epoch difference — a router driving a fake
        chaos clock over real-clock engines would otherwise snapshot a
        garbage budget."""
        del now_s
        entries = self._ledger.drain_entries(self.engine._clock())
        try:
            self.engine.drain()
        except Exception:  # noqa: BLE001 - the engine may be arbitrarily
            pass           # wedged post-kill; the entries above suffice
        return entries

    def restore(self, pairs: List[Tuple[int, Dict]],
                traces=None, epoch=None) -> None:
        """Migration in: wire entries join this engine's queue through
        the standard restore path (depth limits bypassed — every one of
        these was admitted by the fleet already). ``traces`` optionally
        maps rid -> wire trace context so the resumed streams' spans
        stay in their original fleet traces."""
        self._check_epoch(epoch)
        handles = self.engine.restore(snapshot_from_pairs(pairs))
        for (rid, _), handle in zip(pairs, handles):
            self._ledger.add(rid, handle)
            self._apply_trace(rid, handle,
                              None if traces is None else traces.get(rid))

    def take_pending(self) -> List[Dict[str, object]]:
        """Unharvested ledger events — a request can finish inside the
        very ``engine.step()`` a death unwound out of; harvesting here
        lets the router settle it instead of migrating a done stream."""
        return self._ledger.harvest()

    def export_chain(self, prompt: List[int],
                     max_blocks: Optional[int] = None, trace=None):
        """Replica-to-replica prefix transfer OUT: the
        engine's longest cached chain for ``prompt`` as a drain-module
        chain wire entry, or None. A ``trace`` context makes the
        transfer a span in the stream's fleet trace."""
        t0 = time.monotonic()
        entry = self.engine.export_prefix_chain(prompt,
                                                max_blocks=max_blocks)
        if entry is not None and trace is not None \
                and self.engine.tracer.enabled:
            from pddl_tpu_torch.obs.propagate import chain_export_span

            n_blocks = len(entry.get("blocks") or ())
            t1 = time.monotonic()
            self.engine.tracer.on_chain_export(n_blocks, t1 - t0)
            self._span_buf.add(chain_export_span(
                trace, t0, t1, n_blocks, replica=self.replica_id,
                role=self.role))
        return entry

    def import_chain(self, entry, trace=None) -> int:
        """Transfer IN: the chain lands in the engine's HOST tier;
        returns blocks stored (0 = tier off / refused)."""
        t0 = time.monotonic()
        n = self.engine.import_prefix_chain(entry)
        if n and trace is not None and self.engine.tracer.enabled:
            from pddl_tpu_torch.obs.propagate import chain_import_span

            t1 = time.monotonic()
            self.engine.tracer.on_chain_import(n, t1 - t0)
            self._span_buf.add(chain_import_span(
                trace, t0, t1, n, replica=self.replica_id,
                role=self.role))
        return n

    def arm_tracing(self) -> None:
        """Arm a per-request tracer on the engine (idempotent): the
        router calls this when its dtrace collector is armed, so a
        LocalReplica fleet traces without per-test engine plumbing. A
        user-installed tracer is respected (never replaced)."""
        if not self.engine.tracer.enabled:
            from pddl_tpu_torch.obs.trace import RequestTracer

            self.engine.set_tracer(RequestTracer())
        self._dtrace_armed = True

    def respawn(self) -> None:
        self.engine = self._factory()
        self._ledger = HandleLedger()
        self._trace_rids = {}
        if self._dtrace_armed:
            self._dtrace_armed = False
            self.arm_tracing()

    def close(self) -> None:
        pass


class ProcessReplica:
    """A worker process replica (`fleet/worker.py`) over a stdio pipe.

    The parent writes commands to the child's stdin and reads events
    from its stdout (non-blocking, buffered); pings answered with
    pongs are the heartbeat, and process exit / pipe EOF surfaces as
    :class:`ReplicaDied` from whatever call noticed first. ``kill()``
    (SIGKILL) is the un-drainable hard death the chaos/bench legs
    inject; ``terminate()`` (SIGTERM) lets the worker drain and ship
    its snapshot back, which the router can migrate losslessly.

    The pipe speaks the FRAMED protocol by default
    (`fleet/transport.py`): length-prefix + CRC32 + monotone sequence
    per direction, duplicate suppression, gap detection with bounded
    resend requests, and a max-frame guard — the wire is untrusted,
    and ``wire_fault_plan`` makes its failure modes injectable
    (corrupt/truncate/duplicate/reorder/delay/drop at seeded frame
    coordinates, applied on this side of the pipe in BOTH directions
    so one seeded plan governs the whole link). ``transport="lines"``
    keeps the raw JSON-line protocol for A/B comparison.
    """

    can_respawn = True

    def __init__(self, replica_id: int, worker_config: Dict[str, object], *,
                 role: str = "unified",
                 python: str = sys.executable, ready_timeout_s: float = 300.0,
                 ping_interval_s: float = 0.25, drain_timeout_s: float = 10.0,
                 call_timeout_s: float = 30.0, transport: str = "framed",
                 wire_fault_plan=None,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 resend_timeout_s: float = 0.25,
                 max_resend_requests: int = 16,
                 clock=time.monotonic, stderr=None, wait_ready: bool = True):
        if transport not in ("framed", "lines"):
            raise ValueError(
                f"transport must be 'framed' or 'lines', got "
                f"{transport!r}")
        self.replica_id = int(replica_id)
        self._framed = transport == "framed"
        self._config = dict(worker_config)
        self._config["framed"] = self._framed
        # Disaggregation role (`fleet/disagg.py`): an explicit
        # worker_config value wins over the kwarg, and the worker
        # validates it again on its side of the pipe (vocabulary
        # parity, the `role-vocab` rule).
        self._config["role"] = validate_role(
            self._config.get("role", role))
        self.role = self._config["role"]
        # Both pipe ends must enforce the SAME cap (an explicit
        # worker_config value wins — the asymmetric-cap chaos tests
        # use that): a worker with a larger cap would emit snapshot/
        # chain frames this side terminally refuses.
        self._config.setdefault("max_frame_bytes", int(max_frame_bytes))
        self._plan = wire_fault_plan
        self._max_frame = int(max_frame_bytes)
        self._resend_timeout_s = float(resend_timeout_s)
        self._max_resend_requests = int(max_resend_requests)
        self._python = python
        self._ready_timeout_s = float(ready_timeout_s)
        self._ping_interval_s = float(ping_interval_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._call_timeout_s = float(call_timeout_s)
        self._clock = clock
        self._stderr = stderr
        self._spawn(wait_ready=wait_ready)

    # ------------------------------------------------------- process mgmt
    def _worker_argv(self) -> List[str]:
        """The child command line — a seam, so tests can stand in a
        process that never acks ready (the spawn-timeout contract)
        without re-implementing the spawn bookkeeping."""
        return [self._python, "-m", "pddl_tpu_torch.serve.fleet.worker",
                "--config-json", json.dumps(self._config)]

    def _spawn(self, wait_ready: bool = True) -> None:
        # The worker must import pddl_tpu_torch from wherever THIS
        # process found it — which may be a sys.path entry the child
        # would not inherit (PYTHONPATH is appended to, never
        # overwritten: other entries, e.g. site dirs, must survive).
        import pddl_tpu_torch  # noqa: PLC0415

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(pddl_tpu_torch.__file__)))
        env = dict(os.environ)
        parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        if pkg_root not in parts:
            env["PYTHONPATH"] = os.pathsep.join([pkg_root] + parts)
        self._proc = subprocess.Popen(
            self._worker_argv(),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._stderr, text=False, env=env)
        os.set_blocking(self._proc.stdout.fileno(), False)
        self._spawn_started_s = self._clock()
        self._buf = b""
        self._pending: List[Dict[str, object]] = []
        self._unanswered_ping_s: Optional[float] = None
        self._last_ping_s = 0.0
        self._degraded = False
        # Framed-transport state, fresh per process: per-direction
        # sender/receiver, the ingress frame counter (the fault plan's
        # deterministic step coordinate on the "ev" site), and the
        # bounded resend-request machinery.
        self._sender = FrameSender()
        self._receiver = FrameReceiver(max_frame_bytes=self._max_frame)
        self._ev_frame_no = 0
        self._oversize_dropping = False
        self._resend_attempts = 0
        self._next_resend_at = 0.0
        self._wire_retries = 0
        self._tick_walls: List[float] = []
        # Distributed tracing, fresh per process: span
        # records shipped back over the pipe, and the min-RTT clock
        # aligner fed by ping-echo timestamps on pongs.
        self._span_records: List[Dict[str, object]] = []
        self._spans_dropped = 0
        self._aligner = ClockAligner()
        self.ready_compile_counts: Optional[Dict[str, int]] = None
        if wait_ready:
            self.wait_ready()

    def wire_stats(self) -> Dict[str, int]:
        """Transport counters for the router's FleetMetrics fold (and
        the bench's zero-corrupt-frames-accepted referee): resend
        rounds requested, frames the CRC/length check refused, dups
        dropped, gaps seen, typed oversize rejects."""
        s = self._receiver.stats
        return {"retries": self._wire_retries,
                "crc_rejects": s["crc_rejects"],
                "dups": s["dups"], "gaps": s["gaps"],
                "too_large": s["too_large"],
                "frames_ok": s["frames_ok"],
                "frames_sent": self._sender.frames_sent,
                "frames_resent": self._sender.frames_resent}

    def wait_ready(self, timeout_s: Optional[float] = None) -> None:
        """Block until the worker's ``ready`` ack (engine built and
        warmed). Split from :meth:`_spawn` so a fleet can launch every
        worker first (``wait_ready=False``) and pay the N warmup
        compiles concurrently instead of serially.

        ``timeout_s`` overrides the constructor's ``ready_timeout_s``
        for THIS wait; either budget expiring kills the wedged worker
        and raises the typed :class:`ReplicaSpawnTimeout`, so a caller
        holding a control loop (the autoscaler's scale-up path) fails
        the attempt fast instead of blocking serving behind it."""
        budget = (self._ready_timeout_s if timeout_s is None
                  else float(timeout_s))
        deadline = self._clock() + budget
        while self.ready_compile_counts is None:
            for ev in self._read_events(block_s=0.1):
                if ev.get("ev") == "ready":
                    self.ready_compile_counts = ev.get("compile_counts")
                else:
                    self._pending.append(ev)
            if self._proc.poll() is not None:
                raise ReplicaDied(self.replica_id,
                                  f"worker exited rc={self._proc.returncode} "
                                  "before ready")
            if self._clock() > deadline:
                self._proc.kill()
                raise ReplicaSpawnTimeout(
                    self.replica_id, self._clock() - self._spawn_started_s)

    def poll_ready(self) -> bool:
        """Non-blocking readiness probe for concurrent warm-starts: the
        autoscaler spawns with ``wait_ready=False`` and polls this once
        per control tick, so a scale-up compiles in the background while
        the fleet keeps serving. Returns True once the ``ready`` ack has
        arrived; raises :class:`ReplicaDied` if the worker exited first
        and :class:`ReplicaSpawnTimeout` once ``ready_timeout_s`` has
        elapsed since the spawn (the worker is killed — a wedged spawn
        must not leak a zombie process)."""
        if self.ready_compile_counts is not None:
            return True
        for ev in self._read_events():
            if ev.get("ev") == "ready":
                self.ready_compile_counts = ev.get("compile_counts")
            else:
                self._pending.append(ev)
        if self.ready_compile_counts is not None:
            return True
        if self._proc.poll() is not None:
            raise ReplicaDied(self.replica_id,
                              f"worker exited rc={self._proc.returncode} "
                              "before ready")
        waited = self._clock() - self._spawn_started_s
        if waited > self._ready_timeout_s:
            self._proc.kill()
            raise ReplicaSpawnTimeout(self.replica_id, waited)
        return False

    def _send(self, cmd: Dict[str, object]) -> None:
        if self._proc.poll() is not None:
            raise ReplicaDied(self.replica_id,
                              f"worker exited rc={self._proc.returncode}")
        if self._framed:
            frame = self._sender.encode(
                json.dumps(cmd, separators=(",", ":")).encode())
            lines = ([frame] if self._plan is None else
                     self._plan.apply("cmd", self._sender.last_seq,
                                      frame))
        else:
            lines = [(json.dumps(cmd) + "\n").encode()]
        try:
            for line in lines:
                self._proc.stdin.write(line)
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise ReplicaDied(self.replica_id, f"pipe write failed: {e}") \
                from e

    def _write_raw(self, frames: List[bytes]) -> None:
        """Resent frames go out verbatim — the chaos already fired at
        their seq coordinates once; recovery must terminate."""
        try:
            for frame in frames:
                self._proc.stdin.write(frame)
            if frames:
                self._proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise ReplicaDied(self.replica_id, f"pipe write failed: {e}") \
                from e

    def _consume_line(self, line: bytes,
                      out: List[Dict[str, object]]) -> None:
        """One raw stdout line -> zero or more in-order events (framed
        mode runs the fault plan's ingress mangling, then the receiver;
        transport-control events are handled here, not surfaced)."""
        if not line.strip():
            return
        if not self._framed:
            if len(line) > self._max_frame:
                # Typed oversize reject (the unbounded single-line
                # read fix): drop the line, count it, never crash.
                self._receiver.stats["too_large"] += 1
                return
            self._absorb(json.loads(line), out)
            return
        ctl = decode_control(line)
        if ctl is not None:
            # Out-of-band control (never sequenced — a resend request
            # ordered behind the gap it reports would deadlock): the
            # worker lost command frames, replay them verbatim.
            if ctl.get("ctl") == "resend":
                self._wire_retries += 1
                self._write_raw(self._sender.resend_from(
                    int(ctl.get("from", 1))))
            return
        self._ev_frame_no += 1
        mangled = ([line + b"\n"] if self._plan is None else
                   self._plan.apply("ev", self._ev_frame_no,
                                    line + b"\n"))
        for raw in mangled:
            for payload in self._receiver.feed(raw.rstrip(b"\n")):
                self._absorb(json.loads(payload), out)

    def _absorb(self, ev: Dict[str, object],
                out: List[Dict[str, object]]) -> None:
        """Span batches are transport-level: fold them into
        the span buffer at the single ingestion point — whatever wait
        loop happened to read them — instead of surfacing an event the
        router's apply path would have to know to ignore."""
        if ev.get("ev") == "spans":
            self._span_records.extend(ev.get("spans") or [])
            if ev.get("dropped") is not None:
                self._spans_dropped = max(self._spans_dropped,
                                          int(ev["dropped"]))
            return
        out.append(ev)

    def _nudge(self) -> None:
        """Traffic generator for framed wait loops: a ping at the
        heartbeat cadence forces the worker to emit, so a corrupted or
        dropped REPLY surfaces as a sequence gap the resend machinery
        can heal — an idle pipe cannot tell "nothing sent" from
        "everything lost"."""
        if not self._framed:
            return
        now = self._clock()
        if now - self._last_ping_s >= self._ping_interval_s:
            self._last_ping_s = now
            # t_s echoes back on the pong with the worker's own
            # monotonic read: one clock-offset sample per heartbeat.
            self._send({"cmd": "ping", "t_s": now})
            if self._unanswered_ping_s is None:
                self._unanswered_ping_s = now

    def _maybe_request_resend(self) -> None:
        """Gap recovery, bounded: ask the worker to resend from the
        first missing event seq, with timeout backoff between asks;
        past the budget the wire is declared unrecoverable and the
        replica dies its typed death (the router migrates)."""
        if not self._framed:
            return
        if not self._receiver.has_gap:
            # Healed: BOTH the attempt budget and the backoff anchor
            # reset — a later, unrelated gap must get its first
            # request immediately, not inherit this one's backoff.
            self._resend_attempts = 0
            self._next_resend_at = 0.0
            return
        gap_from = self._receiver.expected_seq
        now = self._clock()
        if now < self._next_resend_at:
            return
        if self._resend_attempts >= self._max_resend_requests:
            raise ReplicaDied(
                self.replica_id,
                f"wire unrecoverable: event seq {gap_from} still "
                f"missing after {self._resend_attempts} resend "
                "requests")
        self._resend_attempts += 1
        self._wire_retries += 1
        self._next_resend_at = now + self._resend_timeout_s * min(
            8, 2 ** (self._resend_attempts - 1))
        # Out-of-band: a framed request would order BEHIND the very
        # gap it reports (mutual deadlock when both directions have
        # one) — control lines are sequence-free and idempotent.
        self._write_raw([encode_control(
            {"ctl": "resend", "from": int(gap_from)})])

    def _read_events(self, block_s: float = 0.0) -> List[Dict[str, object]]:
        """Drain available stdout lines (optionally waiting up to
        ``block_s`` for the first byte). EOF raises ReplicaDied."""
        out: List[Dict[str, object]] = []
        deadline = self._clock() + block_s
        while True:
            try:
                chunk = self._proc.stdout.read()
            except (BlockingIOError, OSError):
                chunk = None
            if chunk:
                self._buf += chunk
                # Max-frame guard on the LINE BUFFER itself: a payload
                # that never newline-terminates must not balloon the
                # parent's memory — discard through the next newline
                # and count the typed reject. 4x headroom so a
                # complete oversized FRAME still reaches the
                # receiver's skip path (which consumes its seq slot);
                # only unbounded garbage lands here.
                if self._oversize_dropping or (
                        b"\n" not in self._buf
                        and len(self._buf) > 4 * self._max_frame):
                    if b"\n" in self._buf:
                        _, self._buf = self._buf.split(b"\n", 1)
                        if self._oversize_dropping:
                            self._receiver.stats["too_large"] += 1
                        self._oversize_dropping = False
                    else:
                        self._buf = b""
                        self._oversize_dropping = True
                while b"\n" in self._buf:
                    line, self._buf = self._buf.split(b"\n", 1)
                    self._consume_line(line, out)
                if out:
                    # ANY event is a liveness proof — not just pongs —
                    # so whatever ping was outstanding is answered.
                    self._unanswered_ping_s = None
                    # Gap recovery must not wait for an idle read:
                    # under heavy token flow every pass returns early
                    # here, and deferring the resend request to a
                    # quiet moment turns a 1 ms heal into a whole
                    # engine-tick stall per fault.
                    self._maybe_request_resend()
                    return out
            elif chunk == b"":  # EOF: the worker is gone
                if self._proc.poll() is None:
                    self._proc.wait(timeout=5)
                raise ReplicaDied(
                    self.replica_id,
                    f"stdout EOF (rc={self._proc.returncode})")
            self._maybe_request_resend()
            if self._clock() >= deadline:
                return out
            time.sleep(0.002)

    # ------------------------------------------------------------- intake
    def submit(self, rid: int, prompt, max_new_tokens: int,
               sampling: SamplingParams, deadline_s,
               priority: Priority = Priority.INTERACTIVE,
               adapter=None, constraint=None, trace=None,
               epoch=None) -> None:
        """Synchronous across the pipe: the worker acks admission or
        reports its typed QueueFull (depth + retry_after hint), which
        re-raises here so the router's shed logic is driver-agnostic.
        ``adapter``/``constraint`` (the tenant fields) are already
        plain wire values — a name string and a spec dict; ``trace``
        is the router's ``(trace_id, parent_span_id)`` wire context
       , stamped only when fleet tracing is armed;
        ``epoch`` is the issuing router's fencing epoch —
        a stale one re-raises the worker's typed reject as
        :class:`EpochFenced`."""
        cmd = {"cmd": "submit", "rid": int(rid),
               "prompt": [int(t) for t in prompt],
               "max_new_tokens": int(max_new_tokens),
               "sampling": sampling_to_wire(sampling),
               "deadline_s": deadline_s,
               "priority": Priority(priority).value,
               "adapter": adapter, "constraint": constraint}
        if trace is not None:
            cmd["trace"] = [str(trace[0]), trace[1]]
        if epoch is not None:
            cmd["epoch"] = int(epoch)
        self._send(cmd)
        deadline = self._clock() + self._call_timeout_s
        while True:
            # Consume the WHOLE batch before acting on the ack: token
            # events can share a read with it, and an early return would
            # silently drop them (a lost token = a corrupted replay
            # mirror = a non-token-exact migration later).
            self._nudge()
            verdict = None
            for ev in self._read_events(block_s=0.05):
                kind = ev.get("ev")
                if kind == "submit_ok" and ev.get("rid") == rid:
                    verdict = "ok"
                elif kind == "queue_full" and ev.get("rid") == rid:
                    verdict = QueueFull(int(ev["queue_depth"]),
                                        int(ev["max_queue_depth"]),
                                        retry_after_s=ev.get("retry_after_s"),
                                        priority=Priority(priority))
                elif kind == "error" and ev.get("rid") == rid:
                    verdict = ValueError(str(ev.get("message")))
                elif kind == "fenced" and ev.get("rid") == rid:
                    verdict = EpochFenced(self.replica_id,
                                          int(ev.get("epoch", -1)),
                                          int(ev.get("highest", -1)))
                else:
                    self._pending.append(ev)
            if verdict == "ok":
                return
            if verdict is not None:
                raise verdict
            if self._clock() > deadline:
                raise ReplicaDied(self.replica_id, "submit ack timed out")

    def cancel(self, rid: int, epoch=None) -> None:
        cmd = {"cmd": "cancel", "rid": int(rid)}
        if epoch is not None:
            cmd["epoch"] = int(epoch)
        self._send(cmd)

    def fence(self, epoch: int) -> int:
        """Adopt ``epoch`` on the worker (the promotion probe):
        synchronous like :meth:`compile_counts` — the promoting router
        must KNOW every worker holds the new epoch before the deposed
        primary's next command can race it. Returns the worker's
        highest epoch; raises :class:`EpochFenced` when the caller's
        epoch is the stale one."""
        self._send({"cmd": "fence", "epoch": int(epoch)})
        deadline = self._clock() + self._call_timeout_s
        while self._clock() < deadline:
            self._nudge()
            verdict = None  # consume the whole batch (see submit())
            for ev in self._read_events(block_s=0.05):
                kind = ev.get("ev")
                if kind == "fence_ok" and verdict is None:
                    verdict = int(ev.get("highest", epoch))
                elif kind == "fenced" and ev.get("rid") is None \
                        and verdict is None:
                    verdict = EpochFenced(self.replica_id,
                                          int(ev.get("epoch", -1)),
                                          int(ev.get("highest", -1)))
                else:
                    self._pending.append(ev)
            if isinstance(verdict, EpochFenced):
                raise verdict
            if verdict is not None:
                return verdict
        raise ReplicaDied(self.replica_id, "fence ack timed out")

    # ------------------------------------------------------------ serving
    def warmup(self) -> None:
        pass  # ready implies warmed: the worker compiles before its ack

    def step(self) -> List[Dict[str, object]]:
        """Pump events; the worker self-drives its engine loop. Sends a
        ping at ``ping_interval_s`` cadence — pongs are the heartbeat
        the router's staleness check reads via :meth:`beat_age_s`."""
        now = self._clock()
        if now - self._last_ping_s >= self._ping_interval_s:
            self._last_ping_s = now
            self._send({"cmd": "ping", "t_s": now})
            if self._unanswered_ping_s is None:
                self._unanswered_ping_s = now
        events, self._pending = self._pending, []
        events.extend(self._read_events())
        out = []
        for ev in events:
            if ev.get("ev") == "pong":
                # Pongs double as the degraded gauge's transport: the
                # router's overload detector reads it off `degraded`.
                self._degraded = bool(ev.get("degraded", False))
                # ...and as the gray detector's: the worker's
                # self-reported engine-tick wall (the parent's pump
                # wall cannot see a slow self-driving worker).
                if ev.get("tick_wall_s") is not None:
                    self._tick_walls.append(float(ev["tick_wall_s"]))
                # ...and as the clock aligner's: the echoed ping send
                # time plus the worker's monotonic read is one NTP
                # sample. A pong that sat buffered through a blocked
                # call reads as a huge RTT, which the min-RTT filter
                # discards on its own.
                if (ev.get("echo_t_s") is not None
                        and ev.get("mono_s") is not None):
                    self._aligner.observe(float(ev["echo_t_s"]),
                                          self._clock(),
                                          float(ev["mono_s"]))
            else:
                out.append(ev)
        return out

    def take_latency_samples(self) -> List[float]:
        """Per-tick latency samples since the last call (worker
        self-reported engine-step walls, carried on pongs) — the gray
        detector's input for process replicas."""
        out, self._tick_walls = self._tick_walls, []
        return out

    def take_span_records(self) -> List[Dict[str, object]]:
        """Worker span records absorbed from the pipe since the last
        call (the router's collector drains this each step)."""
        out, self._span_records = self._span_records, []
        return out

    @property
    def spans_dropped(self) -> int:
        """The worker shipper's cumulative overflow counter, as last
        reported."""
        return self._spans_dropped

    def clock_offset(self) -> Optional[float]:
        """Best current estimate of (worker monotonic - router
        monotonic), from the minimal-RTT ping/pong sample; None until
        the first heartbeat answers."""
        return self._aligner.offset_s

    @property
    def flightrec_dir(self) -> Optional[str]:
        """Where this worker's flight recorder writes (config-armed);
        the router harvests it on death."""
        val = self._config.get("flightrec_dir")
        return None if val is None else str(val)

    def set_tick_delay(self, delay_s: float) -> None:
        """Chaos knob: make THIS worker gray — every engine step gains
        ``delay_s`` of wall time from here on (the process-replica
        analogue of a LATENCY fault plan on every device call)."""
        self._send({"cmd": "set_tick_delay", "delay_s": float(delay_s)})

    @property
    def degraded(self) -> bool:
        """Last pong's engine-degraded flag (the OOM machinery)."""
        return self._degraded

    def beat_age_s(self) -> float:
        """Age of the OLDEST unanswered ping; 0.0 when none is
        outstanding. Anchored to when a ping was actually SENT, never
        to the last read — a router that idles between bursts must not
        read its own quiet gap as replica silence and breaker-kill a
        healthy worker on the first steps after waking. Buffered
        events are drained (non-blocking) before judging: a pong that
        arrived while the router was blocked elsewhere (e.g. a bounded
        10 s drain capture of a wedged sibling) counts as answered."""
        if self._unanswered_ping_s is not None:
            try:
                self._pending.extend(self._read_events())
            except ReplicaDied:
                pass  # a real death surfaces from the next step()/send
        if self._unanswered_ping_s is None:
            return 0.0
        return self._clock() - self._unanswered_ping_s

    def compile_counts(self) -> Dict[str, int]:
        """Counts as of the last ``counts``/snapshot report (the ready
        ack at minimum)."""
        self._send({"cmd": "counts"})
        deadline = self._clock() + self._call_timeout_s
        while self._clock() < deadline:
            self._nudge()
            counts = None  # consume the whole batch (see submit())
            for ev in self._read_events(block_s=0.05):
                if ev.get("ev") == "counts" and counts is None:
                    counts = dict(ev["counts"])
                else:
                    self._pending.append(ev)
            if counts is not None:
                return counts
        raise ReplicaDied(self.replica_id, "counts request timed out")

    def export_chain(self, prompt: List[int],
                     max_blocks: Optional[int] = None, trace=None):
        """Replica-to-replica prefix transfer OUT, over the pipe:
        synchronous like :meth:`compile_counts` (the router is about to
        route based on the answer), bounded by ``call_timeout_s``.
        Returns the chain wire entry or None."""
        cmd = {"cmd": "export_chain",
               "prompt": [int(t) for t in prompt],
               "max_blocks": (int(max_blocks)
                              if max_blocks is not None else None)}
        if trace is not None:
            cmd["trace"] = [str(trace[0]), trace[1]]
        self._send(cmd)
        deadline = self._clock() + self._call_timeout_s
        while self._clock() < deadline:
            self._nudge()
            entry = missing = object()
            for ev in self._read_events(block_s=0.05):
                if ev.get("ev") == "chain" and entry is missing:
                    entry = ev.get("entry")
                else:
                    self._pending.append(ev)
            if entry is not missing:
                return entry
        raise ReplicaDied(self.replica_id, "export_chain timed out")

    def import_chain(self, entry, trace=None) -> int:
        """Transfer IN, over the pipe: the worker stores the chain in
        its engine's host tier and acks with the stored-block count."""
        cmd = {"cmd": "import_chain", "entry": entry}
        if trace is not None:
            cmd["trace"] = [str(trace[0]), trace[1]]
        self._send(cmd)
        deadline = self._clock() + self._call_timeout_s
        while self._clock() < deadline:
            self._nudge()
            n = None
            for ev in self._read_events(block_s=0.05):
                if ev.get("ev") == "chain_imported" and n is None:
                    n = int(ev.get("n", 0))
                else:
                    self._pending.append(ev)
            if n is not None:
                return n
        raise ReplicaDied(self.replica_id, "import_chain timed out")

    # --------------------------------------------------------- resilience
    def drain_entries(self, now_s: float) -> List[Tuple[int, Dict]]:
        """Graceful capture: SIGTERM the worker, read back its
        rid-tagged snapshot (the worker's drain handler writes it as
        its last event). A hard-killed worker raises instead — the
        router falls back to its own mirrors. The wait is bounded by
        ``drain_timeout_s``: the router's event loop blocks here, so a
        WEDGED worker must degrade to the replay fallback quickly
        rather than stall every surviving replica's stream for long."""
        if self._proc.poll() is not None:
            raise ReplicaDied(self.replica_id,
                              f"worker already dead rc={self._proc.returncode}")
        try:
            self._proc.send_signal(signal.SIGTERM)
        except OSError as e:
            raise ReplicaDied(self.replica_id, f"SIGTERM failed: {e}") from e
        deadline = self._clock() + self._drain_timeout_s
        snapshot = None
        while snapshot is None and self._clock() < deadline:
            try:
                events = self._read_events(block_s=0.1)
            except ReplicaDied:
                break  # EOF before the snapshot line made it out
            for ev in events:
                if ev.get("ev") == "snapshot":
                    snapshot = ev
                else:
                    # Backlog sharing the pipe with the snapshot —
                    # finish/token events for requests that settled just
                    # before the SIGTERM. Dropping them would leave their
                    # fleet handles unsettled forever; the router applies
                    # them via take_pending() after the capture.
                    self._pending.append(ev)
        if snapshot is None:
            if self._proc.poll() is None:  # wedged past the bound: put
                self._proc.kill()          # it down, replay-migrate
            raise ReplicaDied(self.replica_id,
                              "no drain snapshot before EOF")
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
        return [(int(rid), entry) for rid, entry in snapshot["requests"]]

    def take_pending(self) -> List[Dict[str, object]]:
        """Hand any buffered backlog events to the caller (the router
        applies these after a drain capture so same-pipe finish/token
        events are not lost with the replica). Drains the OS pipe
        buffer first, best-effort: a SIGKILL'd worker's stdout stays
        readable until EOF, and finish/token events it wrote before
        dying must settle their handles rather than force a pointless
        replay-migration of an already-complete stream."""
        try:
            while True:
                got = self._read_events()
                if not got:
                    break
                self._pending.extend(got)
        except ReplicaDied:
            pass  # EOF: everything readable was parsed above
        events, self._pending = self._pending, []
        return events

    _RESTORE_CHUNK = 8  # entries per restore command

    def restore(self, pairs: List[Tuple[int, Dict]],
                traces=None, epoch=None) -> None:
        """Migration in, chunked: one huge restore line can exceed the
        stdin pipe capacity while the worker is itself blocked writing
        token events nobody is reading — a mutual stall. Small commands
        with a non-blocking stdout drain between them keep both pipe
        directions moving; the worker treats each chunk as an
        independent restore. ``traces`` optionally maps rid -> wire
        trace context; ``epoch`` is the issuing router's
        fencing epoch — a stale restore is refused whole
        (the typed reject surfaces through the event stream)."""
        for i in range(0, len(pairs), self._RESTORE_CHUNK):
            chunk = pairs[i:i + self._RESTORE_CHUNK]
            cmd = {"cmd": "restore",
                   "requests": [[int(rid), entry]
                                for rid, entry in chunk]}
            if traces:
                stamped = [[int(rid), [str(traces[rid][0]),
                                       traces[rid][1]]]
                           for rid, _ in chunk if rid in traces]
                if stamped:
                    cmd["traces"] = stamped
            if epoch is not None:
                cmd["epoch"] = int(epoch)
            self._send(cmd)
            self._pending.extend(self._read_events())

    def respawn(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._spawn()

    # ------------------------------------------------------- fault inject
    def kill(self) -> None:
        """SIGKILL — the un-drainable death (bench/chaos legs)."""
        self._proc.kill()

    def terminate(self) -> None:
        self._proc.send_signal(signal.SIGTERM)

    def close(self) -> None:
        if self._proc.poll() is None:
            try:
                self._send({"cmd": "shutdown"})
                self._proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 - best-effort shutdown
                self._proc.kill()
                self._proc.wait()
