"""Fleet worker: one engine replica as a real OS process (the port's
own copy of :mod:`pddl_tpu.serve.fleet.worker`, the same protocol).

``python -m pddl_tpu_torch.serve.fleet.worker --config-json '{...}'``
builds a GPT + :class:`~pddl_tpu_torch.serve.ServeEngine` from the config
(on the card unless ``"device": "cpu"``), warms it (every kernel it will
launch is built and loaded then, K4 on a paged engine),
and then speaks the JSON-line protocol of
:class:`~pddl_tpu_torch.serve.fleet.replica.ProcessReplica` over stdio:
commands (submit/cancel/ping/counts/restore/fence/shutdown) arrive on
stdin, events (ready/submit_ok/queue_full/tokens/finish/pong/counts/
snapshot/fenced/fence_ok) leave on stdout. stdout is PROTOCOL-ONLY:
anything chatty (a kernel build's log) goes to stderr, which the parent
leaves attached to its own.

Determinism contract: every worker of a fleet (and the oracle engine a
chaos test compares against) initializes parameters from the same
``param_seed``, so greedy streams are token-exact across replicas —
which is what makes live migration's "finish with the identical token
sequence" promise testable.

Death modes, matching the single-engine taxonomy:

- **SIGTERM** → drain: stop admission, encode every in-flight request
  (rid-tagged, `serve/drain.py` wire format), emit it as the final
  ``snapshot`` event, exit 0. The router restores these on survivors —
  live migration.
- **SIGKILL / crash** → nothing is emitted; the parent sees EOF and
  the router rebuilds the lost requests from its own prompt+token
  mirrors (replay fallback).
"""

from __future__ import annotations

import argparse
import json
import select
import signal
import sys
from typing import Dict

from pddl_tpu_torch.serve.fleet.replica import HandleLedger, sampling_from_wire
from pddl_tpu_torch.serve.fleet.transport import (
    MAX_FRAME_BYTES,
    FrameReceiver,
    FrameSender,
    decode_control,
    encode_control,
)
from pddl_tpu_torch.serve.request import Priority, QueueFull

# Machine-checked role vocabulary: must stay
# set-equal to `fleet/disagg.py`'s ROLES — declared as a literal on
# BOTH sides of the process boundary on purpose, so the worker can
# refuse a role this build has never heard of even when spawned by a
# newer (or older) parent.
ROLES = ("prefill", "decode", "unified")

# Machine-checked fencing dispatch table:
# the command kinds whose ``epoch`` stamp this worker checks before
# dispatch — must stay tuple-equal to `fleet/replica.py`'s EPOCH_CMDS
# (the driver-side stamping manifest), both directions. Declared as a
# literal on BOTH sides of the process boundary on purpose, like
# ROLES: fencing is only as strong as the stalest binary's table.
FENCED_CMDS = ("submit", "cancel", "restore", "fence")


def build_engine(config: Dict[str, object]):
    """Engine from a flat config dict, the JAX worker's keys: the fleet's
    one model family, GPT with ``attention="reference"``, its weights
    drawn by the port's seeded init from ``param_seed``. One key of the
    port's own: ``device`` (default: the card; ``"cpu"`` runs the plain
    PyTorch paths). A missing card raises, as every entry point of the
    port does; nothing falls back to the CPU."""
    import torch

    from pddl_tpu_torch.device import resolve_device
    from pddl_tpu_torch.models.gpt import GPT
    from pddl_tpu_torch.serve import ServeEngine

    device = resolve_device(config.get("device"))
    # Fleet determinism: every process drawing from param_seed on the
    # same device draws the same bits, so greedy streams are token-exact
    # across replicas and against an oracle engine built the same way.
    model = GPT(vocab_size=int(config.get("vocab", 256)),
                max_len=int(config.get("max_len", 512)),
                embed_dim=int(config.get("embed_dim", 256)),
                depth=int(config.get("depth", 4)),
                num_heads=int(config.get("heads", 4)),
                attention="reference", device=device,
                seed=int(config.get("param_seed", 0)))
    aging = config.get("aging_s", 30.0)
    # Multi-tenant passthrough: a `tenant` sub-config builds the same
    # registry on every process replica — adapters are (name, seed[,
    # rank, scale]) pairs materialized via the registry's deterministic
    # `register_random`, so every replica (and the chaos oracle) holds
    # bit-identical factors and migrated tenant streams stay token-exact
    # across processes. `token_strings` enables grammar constraints;
    # absent `tenant` keeps the plain engine.
    tenant_cfg = config.get("tenant")
    tenant = None
    if tenant_cfg:
        from pddl_tpu_torch.serve.tenant import AdapterRegistry, TenantConfig

        registry = AdapterRegistry(
            model.embed_dim, model.vocab_size,
            rank=int(tenant_cfg.get("rank", 8)))
        for name, spec in (tenant_cfg.get("adapters") or {}).items():
            registry.register_random(
                name, int(spec["seed"]),
                scale=float(spec.get("scale", 0.05)),
                rank=spec.get("rank"))
        pool_slots = tenant_cfg.get("adapter_pool_slots")
        tenant = TenantConfig(
            registry=registry,
            adapter_pool_slots=(int(pool_slots)
                                if pool_slots is not None else None),
            token_strings=tenant_cfg.get("token_strings"),
            adapter_load_tokens=int(
                tenant_cfg.get("adapter_load_tokens", 8)))
    # Tiered KV cache: a nonzero host_tier_bytes arms the host-RAM spill
    # tier on every process replica — which is also what makes the
    # router's chain pulls land somewhere.
    host_tier = None
    if config.get("host_tier_bytes"):
        from pddl_tpu_torch.serve.kvcache import HostTierConfig

        host_tier = HostTierConfig(
            byte_budget=int(config["host_tier_bytes"]),
            promote_tokens_per_block=int(
                config.get("host_promote_tokens_per_block", 2)),
            min_chain_blocks=int(
                config.get("host_min_chain_blocks", 1)))
    return ServeEngine(
        model, device=device,
        host_tier=host_tier,
        max_slots=int(config.get("slots", 8)),
        prefill_len=int(config.get("prefill_len", 64)),
        max_queue_depth=int(config.get("max_queue_depth", 64)),
        # SLO knobs: scheduler aging and sliced prefill ride the same
        # flat config.
        prefill_token_budget=config.get("prefill_token_budget"),
        aging_s=float(aging) if aging is not None else None,
        prefill_slice_tokens=config.get("prefill_slice_tokens"),
        # Engine-parity default: absent means the auto-sized prefix
        # pool, NOT off — the router's affinity shadow must point at
        # caches that exist. Pass 0 explicitly to disable.
        prefix_cache_blocks=config.get("prefix_cache_blocks"),
        # Paged attention: decode straight from the block pool through
        # per-slot block tables (K4 on the card); absent keeps the row
        # engine.
        paged=bool(config.get("paged", False)),
        tenant=tenant,
        # Speculative serving: every replica drafts with the same
        # k/ngram, so migrated speculative streams land on an engine that
        # re-feeds them through the same verify machinery.
        spec_k=int(config.get("spec_k", 0)),
        spec_ngram=int(config.get("spec_ngram", 3)),
        rng=torch.Generator(device=device).manual_seed(
            int(config.get("engine_seed", 0))))


def _emit(record: Dict[str, object]) -> None:
    sys.stdout.write(json.dumps(record) + "\n")
    sys.stdout.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config-json", required=True)
    args = p.parse_args(argv)
    config = json.loads(args.config_json)

    # Disaggregation role: validated BEFORE the engine
    # build — a misconfigured role is a config error the spawn should
    # surface (the parent sees a ready timeout + this stderr line),
    # not a replica that silently serves the wrong phase.
    role = str(config.get("role", "unified"))
    if role not in ROLES:
        print(f"invalid replica role {role!r}: must be one of {ROLES}",
              file=sys.stderr)
        return 2

    # Framed transport: the parent
    # injects ``framed: true`` and both directions gain length+CRC+seq
    # framing, duplicate suppression, and bounded resend — stdout is
    # still PROTOCOL-ONLY, the frames are still one line each.
    framed = bool(config.get("framed", False))
    max_frame = int(config.get("max_frame_bytes", MAX_FRAME_BYTES))
    sender = FrameSender()
    receiver = FrameReceiver(max_frame_bytes=max_frame)

    if framed:
        def emit(record: Dict[str, object]) -> None:
            sys.stdout.buffer.write(sender.encode(
                json.dumps(record, separators=(",", ":")).encode()))
            sys.stdout.buffer.flush()
    else:
        emit = _emit

    engine = build_engine(config)
    engine.warmup()
    ledger = HandleLedger()

    # Distributed tracing: `dtrace` arms a RequestTracer on
    # the engine plus the bounded span shipper (records ride back on
    # the pipe); `flightrec_dir` arms the crash-durable flight
    # recorder (spans + per-tick records survive SIGKILL for the
    # router's postmortem harvest). Both default off — the tracing-off
    # worker is byte-identical to one built without tracing.
    tracer = None
    shipper = None
    recorder = None
    trace_rids: Dict[int, int] = {}  # engine request_id -> router rid
    if config.get("dtrace"):
        from pddl_tpu_torch.obs.propagate import SpanShipper
        from pddl_tpu_torch.obs.trace import RequestTracer

        # Small decode-event budget: per-token events are cadence
        # detail the TTFT critical path never reads (it keys off
        # prefill/first_token events and the tokens_emitted field),
        # but they dominate shipped-span JSON volume — and on a
        # shared-core host, serialize/parse time is decode time.
        tracer = RequestTracer(
            max_decode_events_per_span=int(
                config.get("dtrace_decode_events", 8)))
        engine.set_tracer(tracer)
        shipper = SpanShipper(capacity=int(
            config.get("dtrace_buffer", 512)))
    if config.get("flightrec_dir"):
        from pddl_tpu_torch.obs.flightrec import FlightRecorder

        recorder = FlightRecorder(
            str(config["flightrec_dir"]),
            max_segment_bytes=int(
                config.get("flightrec_segment_bytes", 262144)),
            max_segments=int(config.get("flightrec_segments", 4)),
            tracer=tracer)

    flags = {"drain": False, "shutdown": False}

    # Fencing epoch: the highest epoch any
    # command has carried. -1 = never fenced, so epoch-free callers
    # (every pre-HA fleet) are never refused. ``fence_path`` persists
    # the floor across a worker respawn — a deposed primary must not
    # regain the fleet by bouncing its workers.
    fence = {"epoch": -1}
    fence_path = config.get("fence_path")
    if fence_path:
        try:
            with open(str(fence_path)) as f:
                fence["epoch"] = max(fence["epoch"], int(f.read()))
        except (OSError, ValueError):
            pass  # no file yet / unreadable: the in-memory floor rules

    def raise_fence(epoch: int) -> None:
        fence["epoch"] = epoch
        if fence_path:
            try:
                with open(str(fence_path), "w") as f:
                    f.write(str(epoch))
            except OSError as e:  # keep serving: the in-memory floor
                print(f"fence persist failed: {e}", file=sys.stderr)

    def _on_sigterm(signum, frame):  # flag only: async-signal-safe
        flags["drain"] = True

    signal.signal(signal.SIGTERM, _on_sigterm)
    emit({"ev": "ready", "replica": config.get("replica_id"),
          "role": role, "compile_counts": engine.compile_counts()})

    import time

    def note_trace(rid: int, handle, ctx) -> None:
        """Stamp the router's wire trace context onto a fresh span and
        remember the engine-id -> rid mapping for shipping."""
        if tracer is None:
            return
        eng_rid = handle.request.request_id
        trace_rids[eng_rid] = rid
        if ctx:
            tracer.on_trace_context(eng_rid, str(ctx[0]), ctx[1])

    def pump_spans() -> None:
        """Finished engine spans -> flight recorder + shipper, then one
        ``spans`` event per batch so records reach the router in the
        same pipe write as the finishes they describe (no heartbeat
        lag for a test or a postmortem to wait out)."""
        if tracer is None:
            return
        moved = 0
        while True:
            try:
                rec = tracer.finished.popleft()
            except IndexError:
                break
            rec = dict(rec)
            rec["rid"] = trace_rids.pop(rec.get("request_id"), None)
            rec["replica"] = config.get("replica_id")
            rec["role"] = role
            if recorder is not None:
                recorder.append(rec)
            shipper.add(rec)
            moved += 1
        if moved:
            tracer.on_span_shipped(moved, shipper.dropped)
        while len(shipper):
            emit({"ev": "spans", "spans": shipper.drain(16),
                  "dropped": shipper.dropped})

    def handle_cmd(cmd: Dict[str, object]) -> None:
        kind = cmd.get("cmd")
        # Fencing gate, BEFORE dispatch: a command in the
        # FENCED_CMDS table carrying a STALE epoch is refused whole
        # with the typed reject — the deposed-but-alive primary
        # physically cannot drive this worker. Equal-or-higher epochs
        # are adopted (and persisted) first, so the promotion probe
        # and the new primary's first command both raise the floor.
        if kind in FENCED_CMDS and cmd.get("epoch") is not None:
            epoch = int(cmd["epoch"])
            if epoch < fence["epoch"]:
                emit({"ev": "fenced", "cmd": kind,
                      "rid": cmd.get("rid"), "epoch": epoch,
                      "highest": fence["epoch"]})
                return
            if epoch > fence["epoch"]:
                raise_fence(epoch)
        if kind == "fence":
            # The promotion probe: the gate above already adopted the
            # epoch (or refused the probe); ack with the floor held.
            emit({"ev": "fence_ok", "highest": fence["epoch"]})
        elif kind == "submit":
            rid = int(cmd["rid"])
            try:
                handle = engine.submit(
                    cmd["prompt"], int(cmd["max_new_tokens"]),
                    sampling=sampling_from_wire(cmd.get("sampling")),
                    deadline_s=cmd.get("deadline_s"),
                    priority=Priority(cmd.get(
                        "priority", Priority.INTERACTIVE.value)),
                    adapter=cmd.get("adapter"),
                    constraint=cmd.get("constraint"))
            except QueueFull as e:
                emit({"ev": "queue_full", "rid": rid,
                       "queue_depth": e.queue_depth,
                       "max_queue_depth": e.max_queue_depth,
                       "retry_after_s": e.retry_after_s})
                return
            except ValueError as e:  # bad request (too long, etc.):
                emit({"ev": "error", "rid": rid,  # reject it, not the
                       "message": str(e)})         # whole worker
                return
            ledger.add(rid, handle)
            note_trace(rid, handle, cmd.get("trace"))
            emit({"ev": "submit_ok", "rid": rid})
        elif kind == "cancel":
            h = ledger.get(int(cmd["rid"]))
            if h is not None:
                h.cancel()
        elif kind == "ping":
            # `tick_wall_s` (the worker's own last engine-step wall,
            # injected delay included) is the gray detector's latency
            # sample for PROCESS replicas: the parent's pipe-pump wall
            # cannot see a slow self-driving worker, so the worker
            # self-reports — gray failure is degradation, not
            # byzantine lying, and the number is measured where the
            # time is actually spent.
            # `echo_t_s`/`mono_s`: the parent's ping send time echoed
            # back with this process's own monotonic read — one clock-
            # offset sample per heartbeat.
            emit({"ev": "pong", "queue_depth": engine.scheduler.depth,
                  "live_slots": engine.live_slots,
                  "degraded": engine.degraded,
                  "tick_wall_s": wire["tick_wall_s"],
                  "echo_t_s": cmd.get("t_s"),
                  "mono_s": time.monotonic()})
            pump_spans()  # idle-path shipping: heartbeats flush spans
                          # even when no engine step is harvesting
        elif kind == "set_tick_delay":
            # Chaos knob (the gray-failure injector): every subsequent
            # engine step gains this much wall time — the process-
            # replica analogue of a LATENCY FaultPlan on every call.
            wire["tick_delay_s"] = float(cmd.get("delay_s", 0.0))
        elif kind == "counts":
            emit({"ev": "counts", "counts": engine.compile_counts()})
        elif kind == "restore":
            from pddl_tpu_torch.serve.fleet.replica import snapshot_from_pairs
            from pddl_tpu_torch.serve.request import FinishReason, RequestState

            # Entry-at-a-time with per-entry isolation (the submit
            # handler's discipline): one bad migrated entry — a
            # corrupted mirror, a prompt beyond THIS replica's max_len —
            # must fail that request terminally, not crash a healthy
            # survivor mid-failover and cascade the outage.
            tmap = {int(p[0]): p[1]
                    for p in (cmd.get("traces") or [])}
            for rid, entry in cmd["requests"]:
                rid = int(rid)
                try:
                    (h,) = engine.restore(snapshot_from_pairs(
                        [(rid, entry)]))
                except Exception as e:  # noqa: BLE001 - reject the entry
                    print(f"restore of rid={rid} rejected: {e}",
                          file=sys.stderr)
                    emit({"ev": "finish", "rid": rid,
                           "state": RequestState.FAILED.value,
                           "reason": FinishReason.ERROR.value,
                           "ttft_s": (entry.get("ttft_s")
                                      if isinstance(entry, dict) else None),
                           "n_tokens": 0})
                    continue
                ledger.add(rid, h)
                note_trace(rid, h, tmap.get(rid))
        elif kind == "export_chain":
            # Replica-to-replica prefix transfer OUT: the
            # chain wire entry (or null) as a synchronous ack, like
            # counts — the router routes on the answer. Per-command
            # isolation (the submit/restore discipline): the pull is
            # best-effort END TO END, so a failed export — tier off on
            # this engine, a device fault mid-read — answers null, it
            # never crashes a healthy replica serving live streams.
            t0 = time.monotonic()
            try:
                entry = engine.export_prefix_chain(
                    cmd["prompt"], max_blocks=cmd.get("max_blocks"))
            except Exception as e:  # noqa: BLE001 - reject the pull
                print(f"export_chain rejected: {e}", file=sys.stderr)
                entry = None
            t1 = time.monotonic()
            if entry is not None and tracer is not None:
                from pddl_tpu_torch.obs.propagate import chain_export_span

                n_blocks = len(entry.get("blocks") or ())
                tracer.on_chain_export(n_blocks, t1 - t0)
                shipper.add(chain_export_span(
                    cmd.get("trace"), t0, t1, n_blocks,
                    replica=config.get("replica_id"), role=role))
            emit({"ev": "chain", "entry": entry})
        elif kind == "import_chain":
            # Same isolation inbound: a malformed wire entry (bad
            # base64, an invalid dtype string from a foreign build)
            # refuses the chain, not the worker.
            t0 = time.monotonic()
            try:
                n = engine.import_prefix_chain(cmd["entry"])
            except Exception as e:  # noqa: BLE001 - reject the entry
                print(f"import_chain rejected: {e}", file=sys.stderr)
                n = 0
            t1 = time.monotonic()
            if n and tracer is not None:
                from pddl_tpu_torch.obs.propagate import chain_import_span

                tracer.on_chain_import(n, t1 - t0)
                shipper.add(chain_import_span(
                    cmd.get("trace"), t0, t1, n,
                    replica=config.get("replica_id"), role=role))
            emit({"ev": "chain_imported", "n": n})
        elif kind == "drain":
            flags["drain"] = True
        elif kind == "shutdown":
            flags["shutdown"] = True

    wire = {"next_resend_s": 0.0, "dropping": False,
            "tick_wall_s": None, "tick_delay_s": 0.0}

    def consume_cmd_line(line: bytes) -> None:
        """One stdin line -> command(s). Framed mode validates, dedups
        and re-orders through the receiver; a command the CRC refused
        heals via the resend request below. An oversized line is a
        TYPED reject in both modes — reported, counted, never a worker
        crash (the loop would have ballooned or thrown)."""
        if not line.strip():
            return
        if not framed:
            if len(line) > max_frame:
                receiver.stats["too_large"] += 1
                emit({"ev": "wire_error", "kind": "frame_too_large",
                      "bytes": len(line)})
                return
            handle_cmd(json.loads(line))
            return
        ctl = decode_control(line)
        if ctl is not None:
            # Out-of-band control (sequence-free — see transport.py):
            # the parent lost event frames, replay them verbatim from
            # the send buffer (chaos never re-fires on resends —
            # recovery must terminate).
            if ctl.get("ctl") == "resend":
                for frame in sender.resend_from(int(ctl.get("from", 1))):
                    sys.stdout.buffer.write(frame)
                sys.stdout.buffer.flush()
            return
        if len(line) > max_frame:
            # Report the typed reject; the receiver still consumes the
            # frame's sequence slot (policy refusal, not corruption —
            # a resend of the same oversize could never heal it).
            emit({"ev": "wire_error", "kind": "frame_too_large",
                  "bytes": len(line)})
        for payload in receiver.feed(line):
            handle_cmd(json.loads(payload))

    stdin_fd = sys.stdin.fileno()
    buf = b""
    while not flags["shutdown"]:
        # Commands first (non-blocking; idle workers block briefly so a
        # quiet fleet costs ~no CPU), then one engine step if live.
        timeout = 0.0 if engine.has_work else 0.02
        ready, _, _ = select.select([stdin_fd], [], [], timeout)
        if ready:
            try:
                chunk = sys.stdin.buffer.raw.read(65536)
            except (BlockingIOError, OSError):
                chunk = None
            if chunk == b"":  # parent closed stdin: orphaned, exit
                break
            if chunk:
                buf += chunk
                # Unterminated-giant-line guard: discard through the
                # next newline instead of growing without bound (4x
                # headroom — a complete oversized frame must reach the
                # receiver's skip path, which consumes its seq slot).
                if wire["dropping"] or (b"\n" not in buf
                                        and len(buf) > 4 * max_frame):
                    if b"\n" in buf:
                        _, buf = buf.split(b"\n", 1)
                        if wire["dropping"]:
                            receiver.stats["too_large"] += 1
                            emit({"ev": "wire_error",
                                  "kind": "frame_too_large"})
                        wire["dropping"] = False
                    else:
                        buf = b""
                        wire["dropping"] = True
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    consume_cmd_line(line)
        if framed and receiver.has_gap:
            # A command went missing (corrupt/dropped frame): ask the
            # parent to resend from the first missing seq, at a
            # bounded cadence so a dead gap cannot spam the pipe.
            # Out-of-band (sequence-free) on purpose — see
            # transport.encode_control.
            now_s = time.monotonic()
            if now_s >= wire["next_resend_s"]:
                wire["next_resend_s"] = now_s + 0.02
                sys.stdout.buffer.write(encode_control(
                    {"ctl": "resend", "from": receiver.expected_seq}))
                sys.stdout.buffer.flush()
        if flags["drain"]:
            now = time.monotonic()
            entries = ledger.drain_entries(now)
            try:
                engine.drain()
            except Exception:  # noqa: BLE001 - snapshot already captured
                pass
            # engine.drain() flushed every in-flight span; ship them
            # BEFORE the snapshot so the migration's trace has no hole
            # where the source replica's records should be.
            pump_spans()
            emit({"ev": "snapshot",
                   "requests": [[rid, entry] for rid, entry in entries],
                   "compile_counts": engine.compile_counts()})
            if recorder is not None:
                recorder.close()
            return 0
        if engine.has_work:
            t0 = time.monotonic()
            engine.step()
            if wire["tick_delay_s"] > 0.0:
                time.sleep(wire["tick_delay_s"])
            wire["tick_wall_s"] = time.monotonic() - t0
            events = ledger.harvest()
            for ev in events:
                emit(ev)
            if recorder is not None:
                # The flight record of THIS tick: enough to reassemble
                # the worker's final moments after a SIGKILL (tokens
                # streamed per rid, wall, load) from the file alone.
                t_now = time.monotonic()
                recorder.append({"kind": "flight_tick", "t_s": t_now,
                                 "wall_s": wire["tick_wall_s"],
                                 "queue_depth": engine.scheduler.depth,
                                 "live_slots": engine.live_slots})
                for ev in events:
                    if ev.get("ev") == "tokens":
                        recorder.append({"kind": "flight_tokens",
                                         "t_s": t_now,
                                         "toks": ev["toks"]})
            pump_spans()
    return 0


if __name__ == "__main__":
    sys.exit(main())
