"""The fleet router: N replicas behind one health-checked front door.

The port's own copy of :mod:`pddl_tpu.serve.fleet.router` (host Python,
no JAX): the same names, error texts, literal tables and wire shapes.

One :class:`~pddl_tpu_torch.serve.ServeEngine` multiplexes one card; the
ROADMAP's "millions of users" need a fleet — and a fleet's defining
property is that any replica can die at any moment. DistServe (Zhong et
al., 2024) and Splitwise (Patel et al., 2024) draw the architectural
conclusion this module implements: replicas are disposable ROLES behind
a router, never pets. Three router duties:

**Routing.** Prefix-affinity first: the router keeps a host-side SHADOW
of each replica's radix cache (the same
:class:`~pddl_tpu_torch.serve.kvcache.RadixPrefixCache` match machinery,
holding token chains but no device blocks) and sends a prompt to the
healthy replica whose cache already holds its longest leading-block
chain — shared system prompts land where their KV lives, which is what
makes per-replica prefix caches pay at fleet scale. Sticky sessions
(``session=``) keep multi-turn conversations on one replica for the
same reason. With host-tier replicas the shadow models the
SECOND tier too — its own LRU eviction demotes chains into a host
shadow, so affinity can route to "has it in host RAM" when no replica
has it in HBM — and ``chain_pull_blocks`` arms replica-to-replica
prefix transfer: a cold-routed request whose prefix a sibling holds
gets the chain PULLED into the target's host tier over the drain-module
chain wire format, eliminating the duplicate prefill fleet-wide. Cold
prompts route by RENDEZVOUS HASH of the leading blocks over the healthy
set, so one replica's death remaps only its own keys. A full replica (typed
:class:`~pddl_tpu_torch.serve.request.QueueFull`) sheds to the least-loaded
healthy replica, carrying the ``retry_after_s`` hint forward; only a
fleet-wide full queue rejects the caller.

**Disaggregation.** When the fleet holds strict ``prefill``
and ``decode`` role replicas (`fleet/disagg.py`), non-sticky
admissions route to the prefill pool (label ``prefill``) and each
stream hands off to a decode replica at first token — the finished KV
chain ships over the chain wire into the target's host tier, the
rebinding journals as a ``handoff`` record, and decode replicas never
pay a long prompt's prefill. An all-unified fleet (the default role)
routes exactly as above.

**Health.** Per-replica circuit breaker (`fleet/health.py`):
consecutive failures or heartbeat silence trip CLOSED→OPEN, a bounded
exponential backoff gates HALF_OPEN probes, and a successful probe (a
respawn — fresh engine / fresh worker process) closes the circuit and
returns the replica to rotation.

**Failover with live migration.** When a replica dies, the router
captures its drain snapshot — `serve/drain.py` is already the wire
format — and ``restore()``s the in-flight streams on survivors, where
the engine's replay admission rebuilds each KV token-exactly: a request
that STARTED on the dead replica FINISHES with the identical token
sequence. An un-drainable hard kill (SIGKILL, no snapshot possible)
falls back to the router's own prompt+emitted-token mirrors — exactly
the in-engine replay contract, held at fleet level. Requests with no
surviving replica park as orphans and re-enter when a probe brings a
replica back; they fail terminally only when recovery is impossible.

**Durability & gray failure.** The router itself is no
longer assumed immortal: with a :class:`~.journal.RouterJournal`
attached, every admission, routing/ledger binding, emitted-token
mirror delta, and finish is write-ahead logged (admits fsynced before
the caller's handle returns; token deltas fsync-batched — losing them
is safe, replay regenerates), with an atomic checkpoint+truncate
cycle riding the drain-snapshot encoder. :meth:`FleetRouter.recover`
rebuilds a fresh router + fresh replicas after a SIGKILL and resumes
every in-flight stream token-exactly through the same
mirror-replay contract failover uses. And between dead and alive sits
DEGRADED: a :class:`~.health.GrayDetector` watches per-replica
per-tick latency quantiles, interactive submissions to a
suspected-gray replica are HEDGED to the least-loaded healthy sibling
(first result wins, the loser is cancelled), and — with
``gray_drain`` on — the suspect is proactively retired through the
``scale_down`` live-migration path before it hard-fails.

Every fleet event (replica_up/down, circuit transitions, migrations,
sheds, hedges, gray drains) flows through the `obs/` tracer
(``on_fleet_event``) and the Prometheus exporter
(:func:`pddl_tpu_torch.obs.export.fleet_exposition`).
"""

from __future__ import annotations

import collections
import enum
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

from pddl_tpu_torch.obs import flightrec as flightrec_io
from pddl_tpu_torch.obs.propagate import TraceCollector
from pddl_tpu_torch.obs.trace import NULL_TRACER
from pddl_tpu_torch.serve import drain as drain_io
from pddl_tpu_torch.serve.fleet import journal as journal_io
from pddl_tpu_torch.serve.fleet.admission import AdmissionControl
from pddl_tpu_torch.serve.fleet.disagg import HandoffManager, role_of
from pddl_tpu_torch.serve.fleet.health import (
    BreakerState,
    CircuitBreaker,
    GrayDetector,
)
from pddl_tpu_torch.serve.fleet.replica import EpochFenced, ReplicaDied
from pddl_tpu_torch.serve.kvcache import RadixPrefixCache
from pddl_tpu_torch.serve.request import (
    AdmissionRejected,
    FinishReason,
    Priority,
    QueueFull,
    Request,
    RequestState,
    SamplingParams,
)
from pddl_tpu_torch.utils.faults import KillPoint

# Machine-checked route-label vocabulary:
# every label `_route`/`submit` can stamp on a routing decision. The
# journal's `VIA_LABELS` manifest must cover all of them (plus its own
# ledger-only labels, `migration`/`hedge`) — a label minted here that
# the WAL reader cannot classify is a lint error, not a runtime
# surprise.
ROUTE_LABELS = ("sticky", "adapter", "affinity", "load", "host_tier",
                "hash", "shed", "prefill")


class NoHealthyReplica(RuntimeError):
    """Every replica's circuit is open (or dead): the fleet cannot take
    this request right now. The HTTP-503 analogue — distinct from
    :class:`~pddl_tpu_torch.serve.request.QueueFull` (healthy but saturated)
    so upstream can tell "back off briefly" from "page someone"."""


class ReplicaLifecycle(enum.Enum):
    UP = "up"
    DEAD = "dead"
    # Retired by an elastic scale-down: the replica's in-flight work was
    # LIVE-MIGRATED onto survivors (drain snapshot first, router mirrors
    # as the fallback) and the slot left the rotation for good — unlike
    # DEAD, nothing probes it back.
    RETIRED = "retired"


class FleetHandle:
    """The caller's stream handle at fleet level.

    Mirrors the :class:`~pddl_tpu_torch.serve.request.RequestHandle` surface
    (``tokens``/``state``/``finish_reason``/``done``/``ttft_s``/
    ``cancel()``) but is owned by the ROUTER: ``tokens`` is the
    canonical append-only stream the caller reads, fed from whichever
    replica currently runs the request — across any number of
    migrations, which ``migrations`` counts. It doubles as the replay
    mirror: ``prompt + tokens`` is sufficient to rebuild the stream on
    a survivor when a replica hard-dies, so it duck-types the
    `serve/drain.py` encoder's handle surface."""

    def __init__(self, request: Request, arrival_s: float,
                 session: Optional[str] = None):
        self.request = request
        self.arrival_s = arrival_s
        self.session = session
        self.tokens: List[int] = []
        self.state = RequestState.QUEUED
        self.finish_reason: Optional[FinishReason] = None
        self.ttft_s: Optional[float] = None
        self.finish_s: Optional[float] = None
        self.replica_id: Optional[int] = None
        self.migrations = 0
        self._cancel = False
        self._orphan_counted = False

    def cancel(self) -> None:
        self._cancel = True

    @property
    def cancelled(self) -> bool:
        return self._cancel

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED,
                              RequestState.TIMED_OUT, RequestState.FAILED)

    def __repr__(self) -> str:  # debugging aid, not an API
        return (f"FleetHandle(id={self.request.request_id}, "
                f"replica={self.replica_id}, state={self.state.value}, "
                f"tokens={len(self.tokens)}, migrations={self.migrations})")


class FleetMetrics:
    """Fleet-level counters (replica lifecycle, routing decisions,
    migrations, shedding); per-request latency stays in each engine's
    own :class:`~pddl_tpu_torch.serve.ServeMetrics`."""

    def __init__(self):
        self.replica_up_events = 0       # respawns that closed a circuit
        self.replica_down_events = 0
        self.migrations = 0              # death → redistribution passes
        self.requests_migrated = 0
        self.migrated_via_drain = 0      # live migration (snapshot)
        self.migrated_via_replay = 0     # hard kill (router mirrors)
        self.requests_routed = 0
        self.routed_sticky = 0
        self.routed_affinity = 0
        self.routed_hash = 0
        self.routed_load_balanced = 0  # interactive shed off a hot
        #                                affinity replica (pressure-
        #                                aware routing)
        self.routed_adapter = 0        # adapter-affinity hit: routed to
        #                                the replica whose pool already
        #                                holds the request's LoRA
        #                                adapter (`serve/tenant/`)
        self.routed_host_tier = 0      # affinity hit on a replica's
        #                                HOST tier: no replica held the
        #                                chain in HBM, one held it in
        #                                host RAM (`kvcache/hosttier.py`)
        self.routed_prefill = 0        # disaggregated fleet:
        #                                cold prompt sent to the PREFILL
        #                                pool; the stream hands off to a
        #                                decode replica at first token
        # Replica-to-replica prefix transfer: chains pulled
        # from the replica that held them into the routed target's host
        # tier — duplicate prefill eliminated fleet-wide — and the
        # prompt tokens those pulls moved.
        self.chain_pulls = 0
        self.chain_pull_tokens = 0
        # Prefill->decode hand-offs (`fleet/disagg.py`): streams
        # rebound from the prefill pool to a decode replica at first
        # token, the subset that failed (died mid-transfer or the
        # target refused the KV), and the chain payload they moved.
        # `decode_long_prompt_stalls` counts streams that had to KEEP
        # decoding on a prefill replica because no decode replica
        # could take them (once per stream) — the exposition gauges it
        # NaN while the fleet is not disaggregation-armed.
        self.handoffs_completed = 0
        self.handoffs_failed = 0
        self.handoff_bytes = 0
        self.handoff_tokens = 0
        self.decode_long_prompt_stalls = 0
        self.shed_rerouted = 0           # QueueFull → another replica took it
        self.shed_rejected = 0           # fleet-wide full: caller rejected
        # Admission control / brownout (`fleet/admission.py`): front-
        # door rejections BEFORE any engine queue was consulted, plus
        # the ladder's movement counters. Per-class rejection splits
        # flatten into the snapshot as admission_rejected_<class>.
        self.admission_rate_limited = 0
        self.brownout_shed_best_effort = 0
        self.brownout_rejected_cold = 0
        self.brownout_capped_output = 0
        self.brownout_escalations = 0
        self.brownout_deescalations = 0
        self.rejected_by_priority: Dict[str, int] = {
            p.value: 0 for p in Priority}
        # Elastic scaling (`fleet/autoscaler.py` is the policy; the
        # router executes): replicas added/retired at runtime, and the
        # requests a scale-down live-migrated off its victim. The
        # policy-side counters (holds, cooldowns, spawn backoff) live
        # on the autoscaler's own metrics.
        self.scale_up_events = 0
        self.scale_down_events = 0
        self.scale_down_migrated = 0
        # Gray-failure machinery: interactive submissions
        # hedged off a suspected-gray replica, the subset where the
        # HEDGE copy beat the suspect to first result, the duplicate
        # copies cancelled (one per settled pair), and suspects
        # proactively retired through the scale_down migration path.
        self.hedges_launched = 0
        self.hedge_wins = 0
        self.hedge_cancelled = 0
        self.gray_drains = 0
        # Framed-transport health, aggregated from every
        # process replica's wire stats: resend rounds the gap/corrupt
        # recovery ran, and frames the CRC/length check REFUSED (a
        # nonzero reject count with token-exact streams is the "zero
        # corrupt frames accepted" proof, not a failure).
        self.wire_retries = 0
        self.wire_crc_rejects = 0
        # Journal storage health, mirrored from the WAL's
        # degradation machinery: every OSError the VFS shim surfaced
        # (retries included), entries into the NON_DURABLE degraded
        # mode, and re-arms back to durable. A nonzero error count
        # with zero degraded events is the bounded-backoff retry loop
        # absorbing a transient disk; the gauge (`journal_non_durable`)
        # carries the live alarmed state.
        self.journal_storage_errors = 0
        self.journal_degraded_events = 0
        self.journal_rearms = 0
        # Router HA: standby promotions executed by this
        # process, worker-bound commands a replica REFUSED because they
        # carried a stale fencing epoch (a nonzero count is the split-
        # brain defence firing, not a fleet fault), and catch-up folds a
        # standby ran from checkpoint+segment because the live stream
        # had a gap (join, or a NON_DURABLE backlog on the primary).
        self.takeovers = 0
        self.fenced_commands_refused = 0
        self.standby_catchups = 0
        self.requests_finished = 0
        self.requests_failed = 0
        self.requests_orphaned = 0
        self.heartbeat_failures = 0
        self.probes = 0
        self.probe_failures = 0
        self.tokens_streamed = 0
        # Per-class delivery splits (tokens_streamed_<class> in the
        # snapshot): the autoscaler's goodput signal — and the
        # dashboard's — without a second accounting path.
        self.tokens_streamed_by_priority: Dict[str, int] = {
            p.value: 0 for p in Priority}
        self.circuit_transitions: Dict[str, int] = {}

    def snapshot(self) -> Dict[str, object]:
        # Derived from the exporter's canonical key set so the two
        # cannot drift: a counter added above but missing from
        # FLEET_COUNTER_KEYS never reaches the snapshot, and one listed
        # there but not defined here raises loudly right away.
        from pddl_tpu_torch.obs.export import FLEET_COUNTER_KEYS  # noqa: PLC0415

        out = {k: getattr(self, k) for k in sorted(FLEET_COUNTER_KEYS)}
        for key, n in sorted(self.circuit_transitions.items()):
            out["circuit_" + key.replace("->", "_to_")] = n
        for cls, n in sorted(self.rejected_by_priority.items()):
            out["admission_rejected_" + cls] = n
        for cls, n in sorted(self.tokens_streamed_by_priority.items()):
            out["tokens_streamed_" + cls] = n
        return out


class _ShadowIndex:
    """Host-only shadow of one replica's radix cache: the SAME match
    machinery (`serve/kvcache/radix.py`), but its "block ids" are
    placeholders — no device pool exists here. Optimistic by design
    (the replica's real cache may have evicted a chain the shadow still
    holds); a stale hit costs one suboptimal route, never correctness.

    With ``host_capacity_blocks > 0`` the shadow models the replica's
    SECOND tier too: the device shadow's own LRU eviction
    demotes the victim's full chain into a host-shadow index — the same
    eviction-becomes-demotion composition the engine runs, mirrored
    structurally — so prefix-affinity can route to "has it in host
    RAM" when no replica has it in HBM. Same optimism: the engine's
    real policy (spill-worthiness, byte budget) may have decided
    differently; a stale host hit costs one promotion-less route."""

    def __init__(self, block_size: int, capacity_blocks: int,
                 host_capacity_blocks: int = 0):
        self._bs = int(block_size)
        self._idx = RadixPrefixCache(self._bs, capacity_blocks + 1)
        self._host = (RadixPrefixCache(self._bs, host_capacity_blocks + 1)
                      if host_capacity_blocks > 0 else None)
        if self._host is not None:
            self._idx.on_evict = self._demote

    def _demote(self, victims) -> None:
        for node in victims:
            tokens = self._idx.chain_tokens(node)
            self._store(self._host, tokens, len(tokens) // self._bs)

    def match_blocks(self, prompt, max_blocks: int) -> int:
        return self._idx.match(prompt, max_blocks=max_blocks).n_blocks

    def match_blocks_host(self, prompt, max_blocks: int) -> int:
        """Leading blocks the HOST-tier shadow holds (0 when the
        replica has no second tier)."""
        if self._host is None:
            return 0
        return self._host.match(prompt, max_blocks=max_blocks).n_blocks

    def observe(self, prompt, max_blocks: int) -> None:
        """Record that this replica now holds the prompt's leading
        blocks (mirror of the engine's donate-side dedup walk)."""
        self._store(self._idx, prompt, max_blocks)

    def observe_host(self, prompt, max_blocks: int) -> None:
        """Record that this replica's HOST tier now holds the prompt's
        leading blocks (a replica-to-replica chain pull landed)."""
        if self._host is not None:
            self._store(self._host, prompt, max_blocks)

    def _store(self, idx: RadixPrefixCache, prompt,
               max_blocks: int) -> None:
        match = idx.match(prompt, max_blocks=max_blocks)
        node, stored = idx.descend(match.node, prompt, match.n_blocks)
        want = min(len(prompt) // self._bs, max_blocks) - stored
        if want <= 0:
            return
        ids = idx.allocate(want)
        if ids:
            idx.extend(
                node,
                prompt[stored * self._bs:(stored + len(ids)) * self._bs],
                ids)


class _ReplicaSlot:
    """One replica's router-side state: driver + breaker + shadow index
    + the fleet handles currently assigned to it."""

    def __init__(self, driver, breaker: CircuitBreaker,
                 shadow_block_size: int, shadow_capacity: int,
                 shadow_host_capacity: int = 0):
        self.driver = driver
        self.replica_id = driver.replica_id
        self.breaker = breaker
        self.state = ReplicaLifecycle.UP
        self.assigned: Dict[int, FleetHandle] = {}
        self._shadow_cfg = (shadow_block_size, shadow_capacity,
                            shadow_host_capacity)
        self.shadow = _ShadowIndex(*self._shadow_cfg)
        # Last-read wire-stat snapshot (framed process replicas): the
        # router folds per-step DELTAS into FleetMetrics, so a respawn
        # (fresh transport, counters back to zero) resets this baseline
        # instead of double-counting or going negative.
        self.wire_base: Optional[Dict[str, int]] = None

    def reset_shadow(self) -> None:
        self.shadow = _ShadowIndex(*self._shadow_cfg)

    @property
    def load(self) -> int:
        return len(self.assigned)

    @property
    def available(self) -> bool:
        return (self.state is ReplicaLifecycle.UP
                and self.breaker.allows_traffic)


class FleetRouter:
    """Health-checked router over N replica drivers.

    Args:
      replicas: driver sequence (:class:`~.replica.LocalReplica` /
        :class:`~.replica.ProcessReplica`), ids unique.
      affinity_block_size: token granularity of the routing shadow —
        match the replicas' ``prefix_block_size`` so shadow hits
        predict real radix hits.
      affinity_blocks: leading blocks consulted for affinity AND fed to
        the rendezvous hash (the "prompt head").
      shadow_capacity_blocks: per-replica shadow index size (host RAM
        only; LRU beyond it).
      breaker: kwargs for each replica's :class:`CircuitBreaker`.
      heartbeat_timeout_s: a driver exposing ``beat_age_s`` (process
        replicas) older than this counts a breaker failure per step.
      respawn: allow HALF_OPEN probes to rebuild dead replicas (fresh
        engine / fresh worker process). With it off, a dead replica
        stays dead and its circuit never half-opens.
      tracer: `obs/` tracer; fleet events emit via ``on_fleet_event``.
      clock: injectable monotonic clock (chaos tests drive backoff and
        heartbeat timeouts with a fake one).
      admission: optional :class:`~.admission.AdmissionControl` — the
        overload front door (per-priority token buckets, overload
        detector, brownout ladder). ``None`` (default) admits
        everything the engines will take, exactly the behavior.
      interactive_reroute_load: priority-aware routing pressure
        threshold — when the affinity-chosen replica's assigned load
        reaches this many requests, INTERACTIVE submissions route to
        the least-loaded healthy replica instead of the warm cache
        (batch / best_effort keep pure prefix affinity: they can
        afford the queue wait the warm cache buys back). ``None``
        (default) keeps pure affinity for every class.
      shadow_host_capacity_blocks: per-replica HOST-TIER shadow size
       : the device shadow's own LRU eviction demotes
        chains into a second shadow index, mirroring the replicas'
        ``host_tier`` engines, so prefix-affinity can route to "has it
        in host RAM" when no replica has it in HBM (route label
        ``host_tier``). ``0`` (default) keeps the shadow tier-blind —
        exactly the router.
      journal: optional :class:`~.journal.RouterJournal` — the
        control-plane WAL. Admissions/bindings are logged
        durably before the caller's handle returns, token mirrors as
        fsync-batched deltas, and the checkpoint+truncate cycle runs
        on the step cadence; :meth:`recover` rebuilds a crashed router
        from the same directory. ``None`` (default) keeps the unjournaled
        in-memory-only control plane.
      gray: arm the gray-failure detector — a
        :class:`~.health.GrayDetector` instance, a kwargs dict for
        one, or ``True`` for defaults. The router feeds it each
        replica's per-step wall time; suspects are hedged around
        (``gray_hedge``) and optionally retired (``gray_drain``).
        ``None`` (default) keeps the dead-or-alive-only fleet.
      gray_hedge: with ``gray`` armed, INTERACTIVE submissions routed
        to a suspected replica are duplicated to the least-loaded
        healthy non-suspected sibling; the first replica to produce a
        result wins and the other copy is cancelled — the classic
        tail-tolerant hedge, applied only where suspicion already
        says the latency will be bad.
      gray_drain: with ``gray`` armed, a suspected replica is
        proactively RETIRED through the ``scale_down`` live-migration
        path (zero loss, the contract) while it can still drain —
        the gray-failure analogue of failover, run before the
        failure.
      gray_timer: wall-clock source for the per-step latency samples
        (``time.perf_counter``; injectable so chaos tests can script
        exact durations).
      chain_pull_blocks: replica-to-replica prefix transfer
        — when a request routes COLD (rendezvous hash, or a load
        escape off the warm replica) and some OTHER healthy replica's
        shadow holds at least this many leading blocks more than the
        target, the router PULLS the chain: the source exports it over
        the drain-module chain wire format
        (`serve/drain.py` ``kv_chain_to_wire``) and the target imports
        it into its HOST tier, where the admission promotes it instead
        of re-prefilling — duplicate prefill eliminated fleet-wide.
        Requires host-tier-enabled replicas to land anywhere. ``None``
        (default) disables pulling.
    """

    def __init__(self, replicas: Sequence[object], *,
                 affinity_block_size: int = 8, affinity_blocks: int = 8,
                 shadow_capacity_blocks: int = 4096,
                 breaker: Optional[Dict[str, object]] = None,
                 heartbeat_timeout_s: float = 5.0,
                 respawn: bool = True, tracer=None,
                 max_sessions: int = 65536,
                 admission: Optional[AdmissionControl] = None,
                 interactive_reroute_load: Optional[int] = None,
                 shadow_host_capacity_blocks: int = 0,
                 chain_pull_blocks: Optional[int] = None,
                 journal=None, gray=None, gray_hedge: bool = True,
                 gray_drain: bool = False, gray_timer=time.perf_counter,
                 dtrace=None, clock=time.monotonic):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"replica ids must be unique, got {ids}")
        self._clock = clock
        self._tracer = NULL_TRACER if tracer is None else tracer
        self._heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._respawn = bool(respawn)
        self._affinity_blocks = int(affinity_blocks)
        self._block_size = int(affinity_block_size)
        self._interactive_reroute_load = (
            int(interactive_reroute_load)
            if interactive_reroute_load is not None else None)
        if (self._interactive_reroute_load is not None
                and self._interactive_reroute_load < 1):
            raise ValueError(
                f"interactive_reroute_load must be >= 1, got "
                f"{interactive_reroute_load}")
        self.metrics = FleetMetrics()
        # Kept beyond __init__: an elastic scale-up builds new slots
        # with the SAME breaker policy and shadow sizing as the
        # original fleet.
        self._breaker_kw = dict(breaker or {})
        self._shadow_capacity = int(shadow_capacity_blocks)
        self._shadow_host_capacity = int(shadow_host_capacity_blocks)
        self._chain_pull_blocks = (int(chain_pull_blocks)
                                   if chain_pull_blocks is not None
                                   else None)
        if (self._chain_pull_blocks is not None
                and self._chain_pull_blocks < 1):
            raise ValueError(
                f"chain_pull_blocks must be >= 1, got "
                f"{chain_pull_blocks}")
        self._autoscaler = None
        self._journal = journal
        if journal is not None:
            # Storage degradation is alarmable, not silent: every VFS
            # error, NON_DURABLE entry, and re-arm lands in the trace
            # with its (op, errno) coordinate and mirrors into the
            # fleet counters the exposition exports.
            journal.on_storage_event = self._on_journal_storage_event
        if gray is True:
            gray = GrayDetector()
        elif isinstance(gray, dict):
            gray = GrayDetector(**gray)
        self._gray = gray
        self._gray_hedge = bool(gray_hedge)
        self._gray_drain = bool(gray_drain)
        self._gray_timer = gray_timer
        # Fleet-wide distributed tracing: `dtrace=True`
        # builds the router-side TraceCollector; pass a constructed
        # collector to share/inspect it. When armed, every submit/
        # restore/chain command is stamped with a wire trace context
        # and replica span records are drained into the collector each
        # step. None/False keeps every hot path byte-identical.
        if dtrace is None or dtrace is False:
            self._dtrace = None
        elif dtrace is True:
            self._dtrace = TraceCollector(clock=clock)
        else:
            self._dtrace = dtrace
        # Hedge bookkeeping: rid <-> rid cross-links for live pairs,
        # and the subset of rids that are the HEDGE copy (so a win by
        # the hedge — not by the suspected primary — is countable).
        self._hedge_peer: Dict[int, int] = {}
        self._hedge_rids: set = set()
        # hedge rid -> primary rid, for the JOURNAL's sake: the admit
        # was logged under the primary rid, so every later record for
        # the stream — tokens, the finish, the checkpoint entry — must
        # use the same key or recovery would resurrect a stream whose
        # finish it filed under an unknown rid.
        self._hedge_alias: Dict[int, int] = {}
        # Prefill->decode stream rebinding (`fleet/disagg.py`). Always
        # constructed; it only acts when a prefill-role slot emits
        # tokens, so an all-unified fleet never touches it.
        self._handoff = HandoffManager(self)
        self._slots: List[_ReplicaSlot] = []
        for driver in replicas:
            self._new_slot(driver)
        self._by_rid: Dict[int, FleetHandle] = {}
        self._rid_counter = 0
        # Sticky-session map, LRU-bounded: sessions outlive their
        # requests by design (that is the stickiness), so without a cap
        # a long-lived router grows one entry per distinct session
        # forever. Least-recently-routed sessions fall off first; an
        # evicted session that returns simply re-routes by affinity.
        self._max_sessions = int(max_sessions)
        self._sessions: "collections.OrderedDict[str, _ReplicaSlot]" = \
            collections.OrderedDict()
        # Adapter-affinity homes (`serve/tenant/`): adapter name → the
        # replica whose device pool last loaded it. Routing same-
        # adapter traffic back keeps the pool warm (a cold load per
        # replica per adapter, not per request); a death drops only its
        # own entries, and the home FOLLOWS reality — it re-pins to
        # wherever a request actually landed (shed reroutes included).
        self._adapter_homes: Dict[str, _ReplicaSlot] = {}
        # (rid, FleetHandle) pairs with no surviving replica, waiting
        # for a probe to bring one back.
        self._orphans: List[Tuple[int, FleetHandle]] = []
        self._closed = False
        # Fencing epoch: None = unarmed, every driver call
        # goes out epoch-free and pre-HA fleets are byte-identical.
        # Armed (via set_epoch, normally by HotStandby.promote), every
        # worker-bound mutator carries it and a deposed router's
        # commands come back as typed EpochFenced rejects.
        self._epoch: Optional[int] = None
        self._admission = admission
        if admission is not None:
            admission.brownout.on_transition = self._brownout_observer(
                admission.brownout.on_transition)

    @property
    def epoch(self) -> Optional[int]:
        """The fencing epoch this router stamps on worker-bound
        commands; None while HA is unarmed (single-router fleets)."""
        return self._epoch

    def set_epoch(self, epoch: int) -> None:
        """Arm (or raise) the fencing epoch. Journals an ``epoch``
        record so the WAL tail always names the current writer — a
        standby tailing this journal learns the leadership change from
        the same stream it replicates."""
        epoch = int(epoch)
        if self._epoch is not None and epoch < self._epoch:
            raise ValueError(
                f"epoch may only move forward ({self._epoch} -> {epoch})")
        self._epoch = epoch
        if self._journal is not None:
            self._journal.append(journal_io.encode_fence_epoch(epoch),
                                 durable=True)
        self._tracer.on_fleet_event("epoch_armed", epoch=epoch)

    def _count_fenced(self, exc: EpochFenced) -> None:
        self.metrics.fenced_commands_refused += 1
        self._tracer.on_fleet_event(
            "command_fenced", replica_id=exc.replica_id,
            epoch=exc.epoch, highest=exc.highest)

    def _brownout_observer(self, chained):
        def observe(old, new) -> None:
            if new > old:
                self.metrics.brownout_escalations += 1
            else:
                self.metrics.brownout_deescalations += 1
            self._tracer.on_fleet_event(
                "brownout", transition=f"{old.name}->{new.name}",
                rung=int(new))
            if chained is not None:  # the caller's own hook still fires
                chained(old, new)
        return observe

    @property
    def admission(self) -> Optional[AdmissionControl]:
        return self._admission

    @property
    def journal(self):
        """The attached control-plane WAL (None when not armed)."""
        return self._journal

    @property
    def gray(self) -> Optional[GrayDetector]:
        """The gray-failure detector (None when not armed)."""
        return self._gray

    @property
    def dtrace(self):
        """The distributed-trace collector (None when not armed) —
        `obs/assemble.py` stitches its ``records()``; the chaos
        conductor's ``trace_complete`` invariant keys off it."""
        return self._dtrace

    def _new_rid(self) -> int:
        rid = self._rid_counter
        self._rid_counter += 1
        return rid

    @property
    def clock(self):
        """The router's monotonic clock (injectable for chaos tests) —
        shared with the autoscaler so control-loop holds and cooldowns
        live on the same epoch as breaker backoffs and heartbeats."""
        return self._clock

    def _degraded_replica_count(self) -> int:
        """Replicas reporting DEGRADED (the OOM machinery) — fed to
        the overload detector so memory pressure and load pressure
        compose into one brownout signal."""
        return sum(1 for s in self._slots
                   if s.state is ReplicaLifecycle.UP
                   and bool(getattr(s.driver, "degraded", False)))

    # ------------------------------------------------------ observability
    def _circuit_observer(self, slot: _ReplicaSlot):
        def observe(old: BreakerState, new: BreakerState) -> None:
            key = f"{old.value}->{new.value}"
            self.metrics.circuit_transitions[key] = \
                self.metrics.circuit_transitions.get(key, 0) + 1
            self._tracer.on_fleet_event(
                "circuit", replica=slot.replica_id, transition=key)
        return observe

    @property
    def tracer(self):
        return self._tracer

    def set_tracer(self, tracer) -> None:
        self._tracer = NULL_TRACER if tracer is None else tracer

    # ----------------------------------------------------------- plumbing
    @property
    def replicas(self) -> List[_ReplicaSlot]:
        return list(self._slots)

    @property
    def healthy_replicas(self) -> int:
        return sum(s.available for s in self._slots)

    @property
    def disagg_armed(self) -> bool:
        """Disaggregated serving armed: the fleet holds at
        least one strict-``prefill`` AND one strict-``decode`` replica.
        A fleet-SHAPE property, not a health one — a split fleet whose
        prefill pool momentarily died stays armed (routing degrades to
        the unified path until a prefill replica returns); an
        all-unified fleet never arms, which is the backward-compat
        guarantee."""
        roles = {role_of(s.driver) for s in self._slots}
        return "prefill" in roles and "decode" in roles

    @property
    def has_work(self) -> bool:
        return any(not fh.done for fh in self._by_rid.values()) \
            or bool(self._orphans)

    def warmup(self) -> None:
        for slot in self._slots:
            if slot.state is ReplicaLifecycle.UP:
                slot.driver.warmup()

    def compile_counts(self) -> Dict[str, int]:
        """Aggregated per-replica compiled-program counts, keyed
        ``r<id>/<site>`` — the zero-recompiles pin applied to every
        queryable replica (a hard-killed worker is skipped: there is
        nothing left to recompile OR to query)."""
        counts: Dict[str, int] = {}
        for slot in self._slots:
            try:
                for site, n in slot.driver.compile_counts().items():
                    counts[f"r{slot.replica_id}/{site}"] = n
            except ReplicaDied:
                continue
        return counts

    # ------------------------------------------------------------ routing
    def _prompt_head(self, prompt: List[int]) -> bytes:
        head = prompt[:self._affinity_blocks * self._block_size]
        return (",".join(str(t) for t in head)).encode()

    def _rendezvous(self, prompt: List[int],
                    candidates: List[_ReplicaSlot]) -> _ReplicaSlot:
        head = self._prompt_head(prompt)

        def score(slot: _ReplicaSlot) -> int:
            h = hashlib.blake2b(head + b"|" + str(slot.replica_id).encode(),
                                digest_size=8)
            return int.from_bytes(h.digest(), "big")
        return max(candidates, key=score)

    def _session_pin(self, session: str, slot: _ReplicaSlot) -> None:
        self._sessions[session] = slot
        self._sessions.move_to_end(session)
        while len(self._sessions) > self._max_sessions:
            self._sessions.popitem(last=False)

    def _route(self, prompt: List[int], session: Optional[str],
               healthy: List[_ReplicaSlot],
               priority: Priority = Priority.INTERACTIVE,
               adapter: Optional[str] = None,
               ) -> Tuple[_ReplicaSlot, str, Dict[int, int], Dict[int, int]]:
        """Returns ``(slot, how, device_depths, host_depths)`` — the
        depth maps (replica_id -> matched blocks) record exactly the
        shadow walks this call performed, so ``_maybe_pull_chain`` can
        reuse them instead of re-walking every shadow on the routing
        path (a sticky/adapter return walked nothing; a device-affinity
        return never walked the host shadows)."""
        dev_depths: Dict[int, int] = {}
        host_depths: Dict[int, int] = {}
        if session is not None:
            stuck = self._sessions.get(session)
            if stuck is not None:
                self._sessions.move_to_end(session)  # LRU touch
                if stuck.available:
                    return stuck, "sticky", dev_depths, host_depths
        if self.disagg_armed:
            # Disaggregated fleet: every non-sticky
            # admission lands on the PREFILL pool — cold prompts
            # chunk-prefill there and hand off at first token, so a
            # decode replica never stalls a tick on one. Prefix
            # affinity applies WITHIN the pool (a shared system prompt
            # still lands where its KV lives), least-loaded breaks
            # cold ties. Adapter affinity is intentionally skipped:
            # its home would drag long prompts onto whatever decode
            # replica the stream handed off to last time. With the
            # whole pool down, routing degrades to the unified path
            # below — slow beats refused.
            pool = [s for s in healthy
                    if role_of(s.driver) == "prefill"]
            if pool:
                best = min(pool, key=lambda s: (
                    -s.shadow.match_blocks(
                        prompt, max_blocks=self._affinity_blocks),
                    s.load))
                return best, "prefill", dev_depths, host_depths
        if adapter is not None:
            # Adapter affinity outranks prefix affinity (reloading
            # LoRA factors costs more than a cold prefix chunk) but
            # yields to stickiness — a multi-turn session's KV lives
            # where the session lives — and to the SAME interactive
            # pressure escape prefix affinity has: a popular adapter
            # must not funnel interactive traffic onto one replica
            # until it hard-QueueFulls while siblings idle.
            home = self._adapter_homes.get(adapter)
            if home is not None and home.available:
                escape = self._interactive_load_escape(home, healthy,
                                                       priority)
                if escape is not None:
                    return escape, "load", dev_depths, host_depths
                return home, "adapter", dev_depths, host_depths
        best, best_blocks = None, 0
        for slot in healthy:
            m = slot.shadow.match_blocks(prompt,
                                         max_blocks=self._affinity_blocks)
            dev_depths[slot.replica_id] = m
            if m > best_blocks or (m == best_blocks and m > 0
                                   and best is not None
                                   and slot.load < best.load):
                best, best_blocks = slot, m
        if best is not None and best_blocks > 0:
            escape = self._interactive_load_escape(best, healthy,
                                                   priority)
            if escape is not None:
                return escape, "load", dev_depths, host_depths
            return best, "affinity", dev_depths, host_depths
        # Second-tier affinity: no replica holds the prefix
        # in HBM — route to the one whose HOST tier holds it (the
        # engine promotes instead of re-prefilling), under the same
        # interactive pressure escape HBM affinity has.
        hbest, hblocks = None, 0
        for slot in healthy:
            hm = slot.shadow.match_blocks_host(
                prompt, max_blocks=self._affinity_blocks)
            host_depths[slot.replica_id] = hm
            if hm > hblocks or (hm == hblocks and hm > 0
                                and hbest is not None
                                and slot.load < hbest.load):
                hbest, hblocks = slot, hm
        if hbest is not None and hblocks > 0:
            escape = self._interactive_load_escape(hbest, healthy,
                                                   priority)
            if escape is not None:
                return escape, "load", dev_depths, host_depths
            return hbest, "host_tier", dev_depths, host_depths
        return (self._rendezvous(prompt, healthy), "hash",
                dev_depths, host_depths)

    def _maybe_pull_chain(self, prompt: List[int], chosen: _ReplicaSlot,
                          healthy: List[_ReplicaSlot],
                          dev_depths: Optional[Dict[int, int]] = None,
                          host_depths: Optional[Dict[int, int]] = None,
                          ) -> None:
        """Replica-to-replica prefix transfer (the ``chain_pull_blocks``
        arg docs): when a sibling's shadow (HBM or host tier) holds
        meaningfully more of the prompt's prefix than the routing
        target, export the chain from the sibling and import it into
        the target's host tier — the admission then PROMOTES instead of
        re-prefilling, eliminating the duplicate prefill the cold route
        would have paid. Best-effort end to end: a dead source, a
        refused import (target tier off / budget / foreign config), or
        an empty export all degrade to the plain cold admission.

        ``dev_depths``/``host_depths`` are ``_route``'s own shadow-walk
        results (replica_id -> matched blocks) — a depth already
        computed on the routing path is reused, only the components
        the route never walked (e.g. host shadows when device affinity
        decided first) are walked here."""
        blocks = self._affinity_blocks
        dev_depths = dev_depths or {}
        host_depths = host_depths or {}

        def depth_of(slot: _ReplicaSlot) -> int:
            d = dev_depths.get(slot.replica_id)
            if d is None:
                d = slot.shadow.match_blocks(prompt, max_blocks=blocks)
            h = host_depths.get(slot.replica_id)
            if h is None:
                h = slot.shadow.match_blocks_host(prompt,
                                                  max_blocks=blocks)
            return max(d, h)

        own = depth_of(chosen)
        best_src, depth = None, own
        for slot in healthy:
            if slot is chosen:
                continue
            d = depth_of(slot)
            if d > depth:
                best_src, depth = slot, d
        if best_src is None or depth - own < self._chain_pull_blocks:
            return
        export = getattr(best_src.driver, "export_chain", None)
        import_fn = getattr(chosen.driver, "import_chain", None)
        if export is None or import_fn is None:
            return
        try:
            entry = export(list(prompt), depth)
        except Exception:  # noqa: BLE001 - source may be dying; the
            return         # next step() settles it, the pull just skips
        if not entry:
            return
        try:
            n = import_fn(entry)
        except Exception:  # noqa: BLE001 - same best-effort contract
            return
        if n > 0:
            self.metrics.chain_pulls += 1
            self.metrics.chain_pull_tokens += n * self._block_size
            # The target's host tier now covers the EXPORTED chain's
            # depth (the import walks it from block 0, skipping blocks
            # already resident) — NOT own + n: `own` may be a device-
            # shadow match the host tier never held, and over-recording
            # would suppress deeper pulls for every later sharer.
            pulled_depth = (len(entry.get("tokens", []))
                            // self._block_size
                            if isinstance(entry, dict) else n)
            chosen.shadow.observe_host(
                prompt, max_blocks=min(blocks, pulled_depth))
            self._tracer.on_fleet_event(
                "chain_pull", from_replica=best_src.replica_id,
                to_replica=chosen.replica_id, blocks=n)

    def _interactive_load_escape(self, chosen: _ReplicaSlot,
                                 healthy: List[_ReplicaSlot],
                                 priority: Priority,
                                 ) -> Optional[_ReplicaSlot]:
        """Priority-aware load shedding of an affinity choice (warm
        prefix OR warm adapter): a warm cache is worth a queue wait to
        a BATCH request, but an INTERACTIVE one under an SLO prefers a
        cold start on an idle replica over queueing behind a hot spot.
        When the affinity winner's load crosses the threshold and a
        meaningfully lighter healthy replica exists, returns it
        (routed/labeled "load" — the runbook's signal that affinity is
        saturating); else None (keep the affinity choice)."""
        if (self._interactive_reroute_load is None
                or priority is not Priority.INTERACTIVE
                or chosen.load < self._interactive_reroute_load):
            return None
        lightest = min(healthy, key=lambda s: s.load)
        if lightest is not chosen and lightest.load < chosen.load:
            return lightest
        return None

    def submit(self, prompt, max_new_tokens: int, *,
               sampling: Optional[SamplingParams] = None,
               deadline_s: Optional[float] = None,
               session: Optional[str] = None,
               priority: Priority = Priority.INTERACTIVE,
               adapter: Optional[str] = None,
               constraint: Optional[dict] = None) -> FleetHandle:
        """Route one request; returns its fleet stream handle.

        ``adapter``/``constraint`` (the tenant fields, `serve/tenant/`)
        pass through to the replica engines; same-adapter traffic
        routes to the replica whose pool already holds the factors
        (adapter affinity — sticky sessions still outrank it).

        Raises :class:`NoHealthyReplica` when every circuit is open,
        :class:`~pddl_tpu_torch.serve.request.AdmissionRejected` when the
        admission front door refused it (rate limit or brownout — the
        hint covers the ladder's recovery horizon), and
        :class:`~pddl_tpu_torch.serve.request.QueueFull` (with the smallest
        ``retry_after_s`` hint any replica offered) when every healthy
        replica shed it."""
        if self._closed:
            raise RuntimeError("fleet router is closed")
        priority = Priority(priority)
        prompt = [int(t) for t in prompt]
        sampling = sampling or SamplingParams()
        healthy = [s for s in self._slots if s.available]
        if not healthy:
            raise NoHealthyReplica(
                f"no healthy replica among {len(self._slots)} "
                "(all circuits open)")
        chosen, how, dev_depths, host_depths = self._route(
            prompt, session, healthy, priority, adapter)
        now = self._clock()
        if self._admission is not None:
            self._admission.update(now, self._degraded_replica_count())
            # `cold` = neither sticky nor affinity matched: the
            # admission the top brownout rung refuses to buy. The
            # front door's own rejections are NOT fed to the overload
            # detector — the ladder must unwind on engine-side calm,
            # not sustain itself on the pressure of its own shedding.
            ok, reason, hint = self._admission.admit(
                now, priority, cold=(how == "hash"))
            if not ok:
                self.metrics.rejected_by_priority[priority.value] += 1
                if reason == "rate_limit":
                    self.metrics.admission_rate_limited += 1
                elif reason == "brownout_shed":
                    self.metrics.brownout_shed_best_effort += 1
                else:
                    self.metrics.brownout_rejected_cold += 1
                self._tracer.on_fleet_event(
                    "admission_rejected", reason=reason,
                    priority=priority.value)
                raise AdmissionRejected(reason, retry_after_s=hint,
                                        priority=priority)
            capped = self._admission.brownout.cap_new_tokens(
                max_new_tokens)
            if capped < int(max_new_tokens):
                self.metrics.brownout_capped_output += 1
                max_new_tokens = capped
        if self._chain_pull_blocks is not None and how in ("hash", "load"):
            # The request is landing COLD somewhere even though a
            # sibling may hold its prefix: pull the chain to the target
            # before the engine sees the prompt.
            self._maybe_pull_chain(prompt, chosen, healthy,
                                   dev_depths, host_depths)
        # Gray hedging: an INTERACTIVE request the routing
        # sent at a suspected-gray replica is duplicated to the
        # least-loaded healthy NON-suspected sibling — first result
        # wins, the other copy is cancelled. Batch/best_effort keep the
        # single copy: they can afford the suspect's tail.
        hedge_to: Optional[_ReplicaSlot] = None
        if (self._gray is not None and self._gray_hedge
                and priority is Priority.INTERACTIVE
                and self._gray.is_suspected(chosen.replica_id)):
            siblings = [s for s in healthy if s is not chosen
                        and not self._gray.is_suspected(s.replica_id)]
            if siblings:
                hedge_to = min(siblings, key=lambda s: s.load)
        order = [chosen] + sorted((s for s in healthy if s is not chosen),
                                  key=lambda s: s.load)
        hints: List[float] = []
        depth_sum = cap_sum = sheds_seen = 0
        for slot in order:
            rid = self._new_rid()
            # Stamp-only-when-armed: an unarmed router (epoch None)
            # emits the exact pre-HA call shape, so drivers and test
            # doubles that predate fencing keep working untouched.
            extra: Dict[str, object] = {}
            if self._dtrace is not None:
                extra["trace"] = self._dtrace.context_for(rid)
            if self._epoch is not None:
                extra["epoch"] = self._epoch
            try:
                slot.driver.submit(rid, prompt, max_new_tokens,
                                   sampling, deadline_s, priority,
                                   adapter, constraint, **extra)
            except EpochFenced as e:
                # Deposed router: the fleet refused us by design. No
                # point trying siblings — they share the fence floor.
                self._count_fenced(e)
                raise
            except QueueFull as e:
                sheds_seen += 1
                if e.retry_after_s is not None:
                    hints.append(e.retry_after_s)
                depth_sum += e.queue_depth
                cap_sum += e.max_queue_depth
                continue
            except ReplicaDied as e:
                self._on_death(slot, e)
                continue
            fh = FleetHandle(
                Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                        sampling=sampling, deadline_s=deadline_s,
                        priority=priority, adapter=adapter,
                        constraint=constraint),
                arrival_s=self._clock(), session=session)
            fh.replica_id = slot.replica_id
            fh.state = RequestState.QUEUED
            self._by_rid[rid] = fh
            slot.assigned[rid] = fh
            slot.shadow.observe(prompt, max_blocks=self._affinity_blocks)
            if session is not None:
                self._session_pin(session, slot)
            if adapter is not None:
                # The home follows where the request actually LANDED
                # (a shed reroute moves it): that replica's pool holds
                # — or is about to load — the factors.
                self._adapter_homes[adapter] = slot
            self.metrics.requests_routed += 1
            # Only a reroute forced by an actual QueueFull is load
            # shedding (the runbook reads shed_rerouted as
            # backpressure); skipping past a replica that DIED during
            # submit keeps the original routing label — the death
            # already traced replica_down.
            if sheds_seen:
                how = "shed"
                self.metrics.shed_rerouted += 1
                self._tracer.on_fleet_event(
                    "shed", request_id=fh.request.request_id,
                    to_replica=slot.replica_id)
            elif how == "sticky":
                self.metrics.routed_sticky += 1
            elif how == "adapter":
                self.metrics.routed_adapter += 1
            elif how == "affinity":
                self.metrics.routed_affinity += 1
            elif how == "load":
                self.metrics.routed_load_balanced += 1
            elif how == "host_tier":
                self.metrics.routed_host_tier += 1
            elif how == "prefill":
                self.metrics.routed_prefill += 1
            else:
                self.metrics.routed_hash += 1
            if self._admission is not None:
                # Engine-side signal: a reroute forced by QueueFull is
                # pressure even though the request landed.
                self._admission.observe(now, rejected=sheds_seen > 0)
            if self._dtrace is not None:
                # After the shed relabel, so the trace's route label
                # matches the journal's.
                self._dtrace.on_submit(rid, prompt_len=len(prompt),
                                       priority=priority.value,
                                       session=session)
                self._dtrace.on_route(rid, slot.replica_id, how)
            if hedge_to is not None and slot is not hedge_to:
                self._launch_hedge(fh, rid, slot, hedge_to,
                                   max_new_tokens)
            if self._journal is not None:
                # WAL contract: the admission + binding are DURABLE
                # before the caller holds an acked handle — a router
                # SIGKILL after this return can never lose the
                # request (`fleet/journal.py`).
                self._journal.append(
                    journal_io.encode_admit(rid, fh.request, session))
                self._journal.append(
                    journal_io.encode_route(rid, slot.replica_id, how),
                    durable=True)
            return fh
        if cap_sum == 0 and not hints:
            # Nothing actually reported a full queue — every attempt hit
            # a dying replica. That is the 503 case, not backpressure.
            raise NoHealthyReplica(
                f"every healthy replica died during submit "
                f"({len(order)} attempted)")
        self.metrics.shed_rejected += 1
        self.metrics.rejected_by_priority[priority.value] += 1
        if self._admission is not None:
            self._admission.observe(now, rejected=True)
        raise QueueFull(depth_sum, max(cap_sum, depth_sum),
                        retry_after_s=min(hints) if hints else None,
                        priority=priority)

    # ------------------------------------------------------------ hedging
    def _launch_hedge(self, fh: FleetHandle, primary_rid: int,
                      primary: _ReplicaSlot, hedge_to: _ReplicaSlot,
                      max_new_tokens: int) -> None:
        """Duplicate one admitted request onto ``hedge_to`` (the
        suspected-primary case). Best-effort: a full or dying hedge
        target simply leaves the single copy — hedging must never turn
        one admission into a failure it would not otherwise have."""
        req = fh.request
        hrid = self._new_rid()
        trace = None
        if self._dtrace is not None:
            # Alias FIRST so the hedge copy's wire context carries the
            # primary's trace id (one trace, two replicas racing).
            self._dtrace.alias(hrid, primary_rid)
            trace = self._dtrace.context_for(hrid)
        extra: Dict[str, object] = {}
        if trace is not None:
            extra["trace"] = trace
        if self._epoch is not None:
            extra["epoch"] = self._epoch
        try:
            hedge_to.driver.submit(hrid, list(req.prompt),
                                   int(max_new_tokens), req.sampling,
                                   req.deadline_s, req.priority,
                                   req.adapter, req.constraint, **extra)
        except EpochFenced as e:
            self._count_fenced(e)
            return
        except Exception:  # noqa: BLE001 - QueueFull / ReplicaDied /
            return         # anything: the single copy stands alone
        self._by_rid[hrid] = fh
        hedge_to.assigned[hrid] = fh
        self._hedge_peer[primary_rid] = hrid
        self._hedge_peer[hrid] = primary_rid
        self._hedge_rids.add(hrid)
        self._hedge_alias[hrid] = primary_rid
        self.metrics.hedges_launched += 1
        if self._dtrace is not None:
            self._dtrace.on_hedge(hrid, primary_rid,
                                  hedge_to.replica_id)
        if self._journal is not None:
            self._journal.append(journal_io.encode_route(
                hrid, hedge_to.replica_id, "hedge"))
        self._tracer.on_fleet_event(
            "hedge", request_id=req.request_id,
            suspected_replica=primary.replica_id,
            hedge_replica=hedge_to.replica_id)

    def _settle_hedge(self, winner_rid: int) -> None:
        """First-result-wins: the other copy of the pair is unbound
        from the fleet handle and cancelled on its replica; its later
        events fall into the void (``_by_rid`` miss). Idempotent — a
        rid with no live peer is a no-op."""
        loser_rid = self._hedge_peer.pop(winner_rid, None)
        if loser_rid is None:
            return
        self._hedge_peer.pop(loser_rid, None)
        self._hedge_alias.pop(loser_rid, None)  # winner's alias stays:
        #   its tokens/finish keep journaling under the primary rid
        fh = self._by_rid.pop(loser_rid, None)
        for slot in self._slots:
            if loser_rid in slot.assigned:
                slot.assigned.pop(loser_rid, None)
                try:
                    if self._epoch is not None:
                        slot.driver.cancel(loser_rid, epoch=self._epoch)
                    else:
                        slot.driver.cancel(loser_rid)
                except EpochFenced as e:
                    self._count_fenced(e)
                except Exception:  # noqa: BLE001 - loser may be dying;
                    pass           # either way its events are unbound
        winner_hedge = winner_rid in self._hedge_rids
        self._hedge_rids.discard(winner_rid)
        self._hedge_rids.discard(loser_rid)
        if winner_hedge:
            self.metrics.hedge_wins += 1
            # The handle follows the winner: the hedge replica now
            # runs the stream.
            fh = fh if fh is not None else self._by_rid.get(winner_rid)
            if fh is not None:
                for slot in self._slots:
                    if winner_rid in slot.assigned:
                        fh.replica_id = slot.replica_id
                        break
        self.metrics.hedge_cancelled += 1
        self._tracer.on_fleet_event(
            "hedge_settled", winner_rid=winner_rid,
            hedge_won=winner_hedge)

    def _abandon_hedge_copy(self, rid: int) -> None:
        """Dissolve a hedge pair in the PEER's favor without a winner
        ceremony: this copy failed/was shed with nothing emitted, so
        the peer simply continues as the (now sole) stream."""
        peer = self._hedge_peer.pop(rid, None)
        if peer is not None:
            self._hedge_peer.pop(peer, None)
        self._by_rid.pop(rid, None)
        self._hedge_rids.discard(rid)
        self._hedge_alias.pop(rid, None)
        self._tracer.on_fleet_event("hedge_copy_abandoned", rid=rid)

    # ------------------------------------------------------------ serving
    def step(self) -> int:
        """One router round: probe dead replicas whose backoff expired,
        pump/step every live replica (catching deaths and migrating
        their work), apply the resulting stream events. Returns tokens
        streamed to fleet handles this round."""
        now = self._clock()
        tokens = 0
        if self._admission is not None:
            # Ladder recovery must not depend on new submits arriving:
            # a browned-out fleet that traffic abandoned entirely still
            # unwinds to NORMAL on the step cadence.
            self._admission.update(now, self._degraded_replica_count())
        # Cancelled orphans settle HERE: no replica holds them, so the
        # per-slot cancel forwarding never sees them, and without this
        # an unbounded run() would spin on has_work through a total
        # outage whose probes keep failing — cancel() must always lead
        # to a terminal state.
        if self._orphans:
            kept = []
            for rid, fh in self._orphans:
                if fh.cancelled and not fh.done:
                    fh.state = RequestState.CANCELLED
                    fh.finish_reason = FinishReason.CANCELLED
                    fh.finish_s = now
                    self._by_rid.pop(rid, None)
                    if self._dtrace is not None:
                        self._dtrace.on_finish(
                            rid, fh.state.value, fh.finish_reason.value,
                            len(fh.tokens))
                elif not fh.done:
                    kept.append((rid, fh))
            self._orphans = kept
        for slot in self._slots:
            if slot.state is ReplicaLifecycle.DEAD:
                self._maybe_probe(slot, now)
                continue
            beat_fn = getattr(slot.driver, "beat_age_s", None)
            # One reading per round: each call drains the pipe, and the
            # pre-step value is the conservative one to credit against.
            beat_age = None if beat_fn is None else beat_fn()
            if beat_age is not None \
                    and beat_age > self._heartbeat_timeout_s:
                self.metrics.heartbeat_failures += 1
                slot.breaker.record_failure(now)
                self._tracer.on_fleet_event(
                    "heartbeat_missed", replica=slot.replica_id)
                if slot.breaker.state is BreakerState.OPEN:
                    self._on_death(
                        slot, ReplicaDied(slot.replica_id,
                                          "heartbeat timeout"))
                    continue
            step_t0 = self._gray_timer() if self._gray is not None \
                else 0.0
            try:
                events = slot.driver.step()
            except (KillPoint, ReplicaDied) as e:
                self._on_death(slot, e)
                continue
            except Exception as e:  # noqa: BLE001 - replica failure, not ours
                slot.breaker.record_failure(now)
                self._tracer.on_fleet_event(
                    "replica_error", replica=slot.replica_id,
                    error=type(e).__name__)
                if slot.breaker.state is BreakerState.OPEN:
                    self._on_death(slot, e)
                continue
            if self._gray is not None:
                # The per-tick latency samples the gray band judges. A
                # self-driving process replica SELF-REPORTS its engine
                # tick walls (on pongs): the router's pump wall cannot
                # see a slow worker across a pipe. In-process drivers
                # have no such channel — there, stepping IS the work,
                # so the step wall is the honest sample.
                take = getattr(slot.driver, "take_latency_samples",
                               None)
                if take is not None:
                    for sample in take():
                        self._gray.observe(slot.replica_id, sample)
                else:
                    self._gray.observe(slot.replica_id,
                                       self._gray_timer() - step_t0)
            self._fold_wire_stats(slot)
            if self._dtrace is not None:
                self._collect_spans(slot)
            # A successful pump only counts as breaker success when the
            # heartbeat (if the driver has one) is actually fresh — a
            # hung-but-alive worker keeps accepting pings into its pipe
            # buffer, and crediting that would reset the silence count
            # so the breaker could never reach OPEN.
            if beat_age is None or beat_age <= self._heartbeat_timeout_s:
                slot.breaker.record_success(now)
            tokens += self._apply_events(slot, events)
            self._forward_cancels(slot)
        # Prefill->decode hand-offs run AFTER the slot loop (a hand-off
        # restores onto another slot — same no-mutation-under-iteration
        # discipline the autoscaler tick below rides).
        if self._handoff.pending:
            self._handoff.execute()
        self._maybe_gray_drain()
        if self._autoscaler is not None:
            # One controller decision per routing round, AFTER the slot
            # loop: a scale-down mutates the slot list, which must never
            # happen under the iteration above.
            self._autoscaler.step(self._clock())
        if self._journal is not None:
            # emergency_checkpoint_due: the WAL hit ENOSPC — an
            # immediate checkpoint+rotate retires the oldest segment
            # (the only space the journal owns) instead of blind-
            # retrying writes against a full disk.
            if (self._journal.checkpoint_due
                    or getattr(self._journal,
                               "emergency_checkpoint_due", False)):
                self._journal_checkpoint()
            self._journal.tick()
        return tokens

    def _collect_spans(self, slot: _ReplicaSlot) -> None:
        """Drain a driver's shipped span records into the collector
        and refresh the replica's clock-offset estimate.
        Driver-agnostic via getattr — a test double without the trace
        surface simply contributes nothing."""
        take = getattr(slot.driver, "take_span_records", None)
        if take is not None:
            try:
                records = take()
            except Exception:  # noqa: BLE001 - a dying pipe settles later
                records = []
            if records:
                self._dtrace.add_replica_records(slot.replica_id,
                                                 records)
        off = getattr(slot.driver, "clock_offset", None)
        if off is not None:
            try:
                self._dtrace.set_offset(slot.replica_id, off())
            except Exception:  # noqa: BLE001 - same
                pass
        dropped = getattr(slot.driver, "spans_dropped", None)
        if dropped:
            self._dtrace.note_remote_drops(int(dropped))

    def _fold_wire_stats(self, slot: _ReplicaSlot) -> None:
        """Aggregate a framed driver's transport counters into
        FleetMetrics as deltas against the slot's last reading."""
        ws = getattr(slot.driver, "wire_stats", None)
        if ws is None:
            return
        try:
            stats = dict(ws())
        except Exception:  # noqa: BLE001 - a dying pipe settles later
            return
        base = slot.wire_base or {}
        self.metrics.wire_retries += max(
            0, stats.get("retries", 0) - base.get("retries", 0))
        self.metrics.wire_crc_rejects += max(
            0, stats.get("crc_rejects", 0) - base.get("crc_rejects", 0))
        slot.wire_base = stats

    def _maybe_gray_drain(self) -> None:
        """Proactively retire suspected-gray replicas through the
        ``scale_down`` live-migration path — the whole point of a gray
        DETECTOR is acting before the failure. Refuses to drain the
        last available replica (slow beats gone)."""
        if self._gray is None or not self._gray_drain:
            return
        for rid in sorted(self._gray.suspected):
            slot = next((s for s in self._slots
                         if s.replica_id == rid
                         and s.state is ReplicaLifecycle.UP), None)
            if slot is None:
                self._gray.forget(rid)
                continue
            try:
                migrated = self.scale_down(rid)
            except ValueError:
                return  # no survivor to absorb it: keep serving slow
            self.metrics.gray_drains += 1
            self._gray.forget(rid)
            self._tracer.on_fleet_event(
                "gray_drain", replica=rid, migrated=migrated)

    def _journal_entries(self) -> List[Tuple[int, Dict]]:
        """The checkpoint body: every in-flight stream's mirror as a
        rid-tagged drain wire entry (one per HANDLE — a hedged pair
        checkpoints its primary rid only, so recovery revives one
        copy, not a duplicate race)."""
        now = self._clock()
        out: List[Tuple[int, Dict]] = []
        seen = set()
        for rid, fh in sorted(self._by_rid.items()):
            if fh.done or rid in self._hedge_rids or id(fh) in seen:
                continue
            seen.add(id(fh))
            entry = drain_io.encode_handle(fh, now)
            entry["session"] = fh.session
            # A won hedge runs under its hedge rid; the journal's key
            # for the stream is the primary rid its admit used.
            out.append((self._hedge_alias.get(rid, rid), entry))
        return out

    def _journal_checkpoint(self) -> None:
        self._journal.checkpoint(self._journal_entries(),
                                 next_rid=self._rid_counter)
        if self._epoch is not None:
            # The checkpoint truncated the WAL: re-assert the writer's
            # epoch so the fresh segment — the suffix a standby tails —
            # always opens by naming who is allowed to write it.
            self._journal.append(journal_io.encode_fence_epoch(self._epoch))

    def _on_journal_storage_event(self, event: str, detail: Dict) -> None:
        """The WAL's degradation observer: mirror storage health into
        FleetMetrics and the trace. ``journal_storage_error`` fires per
        OSError (retries included); ``journal_degraded`` /
        ``journal_rearmed`` bracket the NON_DURABLE window the
        ``journal_non_durable`` gauge alarms."""
        if event == "journal_storage_error":
            self.metrics.journal_storage_errors += 1
        elif event == "journal_degraded":
            self.metrics.journal_degraded_events += 1
        elif event == "journal_rearmed":
            self.metrics.journal_rearms += 1
        elif event == "journal_checkpoint_failed":
            self.metrics.journal_storage_errors += 1
        self._tracer.on_fleet_event(event, **detail)

    def run(self, max_steps: Optional[int] = None,
            idle_sleep_s: Optional[float] = None) -> None:
        """Drive :meth:`step` until every fleet handle settles (or the
        budget runs out). ``idle_sleep_s`` throttles the poll loop;
        the default (``None``) auto-selects — 2 ms when any replica is
        a self-driving process (a tight non-blocking pipe poll would
        steal a whole core from the very workers it waits on), 0 for
        purely in-process fleets, where stepping IS the work."""
        if idle_sleep_s is None:
            idle_sleep_s = (0.002 if any(
                hasattr(s.driver, "beat_age_s") for s in self._slots)
                else 0.0)
        steps = 0
        while self.has_work:
            emitted = self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            if emitted == 0 and idle_sleep_s > 0:
                time.sleep(idle_sleep_s)

    def _forward_cancels(self, slot: _ReplicaSlot) -> None:
        for rid, fh in list(slot.assigned.items()):
            if fh.cancelled and not fh.done:
                try:
                    if self._epoch is not None:
                        slot.driver.cancel(rid, epoch=self._epoch)
                    else:
                        slot.driver.cancel(rid)
                except EpochFenced as e:
                    self._count_fenced(e)
                except (ReplicaDied, OSError):
                    pass  # death handling will settle it

    def _apply_events(self, slot: _ReplicaSlot,
                      events: List[Dict[str, object]]) -> int:
        tokens = 0
        now = self._clock()
        for ev in events:
            kind = ev.get("ev")
            if kind == "tokens":
                for rid, toks in ev["toks"]:
                    if toks and rid in self._hedge_peer:
                        # First result wins: this copy takes the
                        # stream, the peer is cancelled and unbound
                        # (its later events miss `_by_rid` below).
                        self._settle_hedge(rid)
                    fh = self._by_rid.get(rid)
                    if fh is None:
                        continue
                    if fh.ttft_s is None and toks:
                        fh.ttft_s = now - fh.arrival_s
                        if self._dtrace is not None:
                            self._dtrace.on_first_token(rid, fh.ttft_s)
                    if fh.state is RequestState.QUEUED:
                        fh.state = RequestState.RUNNING
                    fh.tokens.extend(int(t) for t in toks)
                    tokens += len(toks)
                    self.metrics.tokens_streamed_by_priority[
                        fh.request.priority.value] += len(toks)
                    if toks and role_of(slot.driver) == "prefill" \
                            and rid not in self._hedge_rids:
                        # First token on a PREFILL slot: prefill is
                        # done, decode has begun in the wrong place —
                        # queue the stream's hand-off (executed after
                        # the slot loop, `fleet/disagg.py`).
                        self._handoff.note(rid)
                    if self._journal is not None:
                        # The emitted-token mirror delta: fsync-BATCHED
                        # (losing a tail is safe — replay regenerates
                        # the identical tokens). Hedge copies journal
                        # under the PRIMARY rid their admit used.
                        self._journal.append(journal_io.encode_tokens(
                            self._hedge_alias.get(rid, rid),
                            list(toks)))
            elif kind == "finish":
                rid = ev["rid"]
                if rid in self._hedge_peer:
                    # Only a SUCCESSFUL first result wins the race: a
                    # copy that failed/was shed with nothing emitted
                    # must not drag down the healthy peer — hedging
                    # can never turn one admission into a failure it
                    # would not otherwise have. The failed copy is
                    # quietly unlinked; the peer keeps the stream.
                    if ev.get("state") == RequestState.FAILED.value \
                            and not ev.get("n_tokens"):
                        self._abandon_hedge_copy(rid)
                        slot.assigned.pop(rid, None)
                        continue
                    self._settle_hedge(rid)
                fh = self._by_rid.pop(rid, None)
                slot.assigned.pop(rid, None)
                if fh is None:
                    continue
                # Adopt the ENGINE-measured TTFT when the driver
                # reports one: the router-side stamp above measures
                # first-token EVENT ARRIVAL, which under load includes
                # however long the router spent between pipe pumps —
                # loop latency, not scheduling quality. The engine's
                # number (queue wait + prefill, on the replica's own
                # clock) is what the SLO machinery actually controls
                # and what the per-priority dashboards read.
                if ev.get("ttft_s") is not None:
                    fh.ttft_s = float(ev["ttft_s"])
                fh.state = RequestState(ev["state"])
                fh.finish_reason = (FinishReason(ev["reason"])
                                    if ev.get("reason") else None)
                fh.finish_s = now
                if fh.state is RequestState.FINISHED:
                    self.metrics.requests_finished += 1
                elif fh.state is RequestState.FAILED:
                    self.metrics.requests_failed += 1
                if self._dtrace is not None:
                    self._dtrace.on_finish(
                        rid, fh.state.value,
                        fh.finish_reason.value
                        if fh.finish_reason is not None else None,
                        len(fh.tokens),
                        ttft_s=ev.get("ttft_s"))
                if self._journal is not None:
                    self._journal.append(journal_io.encode_finish(
                        self._hedge_alias.pop(rid, rid),
                        fh.state.value,
                        fh.finish_reason.value
                        if fh.finish_reason is not None else None))
                else:
                    self._hedge_alias.pop(rid, None)
            elif kind == "fenced":
                # A fire-and-forget command (cancel, a restore chunk)
                # bounced off the worker's fence floor asynchronously.
                # The replica is healthy — this router is just not the
                # writer any more; count it, the chaos referee reads
                # the counter as the split-brain discriminant.
                self._count_fenced(EpochFenced(
                    slot.replica_id, int(ev.get("epoch", -1)),
                    int(ev.get("highest", -1))))
        self.metrics.tokens_streamed += tokens
        return tokens

    # --------------------------------------------------------- resilience
    def _wire_entry(self, fh: FleetHandle) -> Dict[str, object]:
        """A drain wire entry from the router's own mirror (the hard-
        kill fallback: prompt + emitted tokens replay)."""
        return drain_io.encode_handle(fh, self._clock())

    def _on_death(self, slot: _ReplicaSlot, cause: BaseException) -> None:
        if slot.state is ReplicaLifecycle.DEAD:
            return
        now = self._clock()
        slot.state = ReplicaLifecycle.DEAD
        slot.breaker.trip(now)
        if self._gray is not None:
            self._gray.forget(slot.replica_id)  # dead outranks gray
        # Its adapter pool died with it: drop only ITS homes, so the
        # next same-adapter submission re-homes wherever it lands.
        self._adapter_homes = {name: home for name, home
                               in self._adapter_homes.items()
                               if home is not slot}
        self.metrics.replica_down_events += 1
        self._tracer.on_fleet_event(
            "replica_down", replica=slot.replica_id,
            cause=type(cause).__name__, in_flight=len(slot.assigned))
        # Mirror summary for the postmortem bundle BEFORE _evacuate
        # clears the assignment map.
        mirrors = ([[rid, len(fh.tokens)]
                    for rid, fh in slot.assigned.items()]
                   if self._dtrace is not None else None)
        # Live migration: the replica's own drain snapshot when it can
        # still produce one (`serve/drain.py` wire format, rid-tagged);
        # otherwise rebuild from the router mirrors — same format, the
        # prompt+emitted-token replay the engine pins.
        migrate, leftovers, via = self._evacuate(slot, now)
        if self._dtrace is not None:
            self._harvest_flight(slot, mirrors)
        self._distribute(migrate, via)
        if leftovers:
            self._distribute(leftovers, "replay")

    def _harvest_flight(self, slot: _ReplicaSlot,
                        mirrors: Optional[List[List[int]]]) -> None:
        """Post-mortem span recovery for a dead replica: flush whatever
        the driver can still surface in-process, then read the crash-
        durable flight-recorder segments off disk (`obs/flightrec.py`)
        — the SIGKILL path, where the worker never shipped its final
        batches — and leave a postmortem bundle beside the WAL and
        drain mirrors for the operator runbook (docs/OPERATIONS.md)."""
        flush = getattr(slot.driver, "flush_spans", None)
        if flush is not None:
            try:
                flush()
            except Exception:  # noqa: BLE001 - dead replica, best effort
                pass
        self._collect_spans(slot)
        frdir = getattr(slot.driver, "flightrec_dir", None)
        if frdir is None:
            return
        records = flightrec_io.harvest(str(frdir))
        spans = [r for r in records if r.get("kind") == "span"]
        if spans:
            self._dtrace.add_replica_records(slot.replica_id, spans,
                                             source="flightrec")
        flightrec_io.write_postmortem(str(frdir), {
            "replica": slot.replica_id,
            "harvested_records": len(records),
            "harvested_spans": len(spans),
            "mirrors": mirrors or [],
        })

    def _evacuate(self, slot: _ReplicaSlot, now: float) -> Tuple[
            List[Tuple[int, Dict, FleetHandle]],
            List[Tuple[int, Dict, FleetHandle]], str]:
        """The capture-and-adopt half shared by death handling and
        scale-down retirement: snapshot the replica (drain if it can,
        router mirrors if not), adopt snapshot tokens into the fleet
        handles, and return ``(migrate, leftovers, via)`` ready for
        :meth:`_distribute` — the slot's assignment map is cleared."""
        pairs = self._capture(slot, now)
        via = "drain" if pairs is not None else "replay"
        if pairs is None:
            pairs = [(rid, self._wire_entry(fh))
                     for rid, fh in slot.assigned.items() if not fh.done]
        migrate: List[Tuple[int, Dict, FleetHandle]] = []
        for rid, entry in pairs:
            if rid in self._hedge_peer:
                # A hedged copy leaving with its host is not migrated:
                # the surviving peer IS the stream — settle the pair
                # in its favor instead of reviving a duplicate race.
                self._settle_hedge(self._hedge_peer[rid])
                continue
            fh = self._by_rid.get(rid)
            if fh is None or fh.done:
                continue
            etoks = [int(t) for t in entry.get("tokens", [])]
            # The entry is authoritative: tokens the engine emitted in
            # its dying step may not have streamed yet — adopt them so
            # the restored stream and the caller's view agree exactly.
            # A divergence means the snapshot and the caller's stream
            # disagree: fail THAT request terminally rather than abort
            # the whole death-handling pass mid-migration (and never
            # restore a stream we know would not be token-exact).
            if etoks[:len(fh.tokens)] != fh.tokens:
                self._tracer.on_fleet_event(
                    "migration_token_mismatch", request_id=rid)
                self._fail_handle(fh, rid)
                continue
            if fh.ttft_s is None and len(etoks) > len(fh.tokens):
                fh.ttft_s = now - fh.arrival_s
            fh.tokens.extend(etoks[len(fh.tokens):])
            migrate.append((rid, entry, fh))
        leftovers = self._mirror_leftovers(slot, {rid for rid, _ in pairs})
        slot.assigned.clear()
        return migrate, leftovers, via

    def _capture(self, slot: _ReplicaSlot,
                 now: float) -> Optional[List[Tuple[int, Dict]]]:
        """The capture discipline shared by death handling and graceful
        drain: ask the driver for its snapshot (None = hard kill / no
        snapshot possible), then fold whatever backlog the driver read
        before or while capturing into the mirrors — finish events
        settle their handles (so done streams are not migrated), token
        events freshen the replay mirrors — BEFORE the caller judges
        which entries still need moving."""
        try:
            pairs = slot.driver.drain_entries(now)
        except Exception:  # noqa: BLE001 - incl. ReplicaDied: hard kill
            pairs = None
        take = getattr(slot.driver, "take_pending", None)
        if take is not None:
            try:
                self._apply_events(slot, take())
            except Exception:  # noqa: BLE001 - backlog is best-effort
                pass
        return pairs

    def _mirror_leftovers(self, slot: _ReplicaSlot, in_snapshot) -> List[
            Tuple[int, Dict, FleetHandle]]:
        """Requests assigned to the replica but absent from its snapshot
        — e.g. a migration restore the worker never read off its pipe —
        must not be silently dropped: rebuild them from the router
        mirrors (the replay wire entry), same rule for death and drain."""
        return [(rid, self._wire_entry(fh), fh)
                for rid, fh in slot.assigned.items()
                if rid not in in_snapshot and not fh.done]

    def _distribute(self, migrate: List[Tuple[int, Dict, FleetHandle]],
                    via: str) -> None:
        if not migrate:
            return
        survivors = [s for s in self._slots if s.available]
        if not survivors:
            if self._can_ever_recover():
                self._orphans.extend((rid, fh) for rid, _, fh in migrate)
                # Count each REQUEST once, ever: a flapping revive
                # (probe succeeds, restore target dies, re-park) would
                # otherwise inflate the counter the runbook keys manual
                # intervention off to M*K for K real requests.
                fresh = [fh for _, _, fh in migrate
                         if not fh._orphan_counted]
                for fh in fresh:
                    fh._orphan_counted = True
                self.metrics.requests_orphaned += len(fresh)
                self._tracer.on_fleet_event("orphaned", n=len(migrate))
            else:
                for rid, _, fh in migrate:
                    self._fail_handle(fh, rid)
            return
        self.metrics.migrations += 1
        per_target: Dict[int, List[Tuple[int, Dict, FleetHandle]]] = {}
        # Least-loaded-first round robin keeps the redistributed load
        # balanced without a second routing pass per request.
        ordered = sorted(survivors, key=lambda s: s.load)
        for i, item in enumerate(migrate):
            target = ordered[i % len(ordered)]
            per_target.setdefault(target.replica_id, []).append(item)
        by_id = {s.replica_id: s for s in self._slots}
        for tid, items in per_target.items():
            target = by_id[tid]
            try:
                pairs = [(rid, entry) for rid, entry, _ in items]
                extra: Dict[str, object] = {}
                if self._epoch is not None:
                    extra["epoch"] = self._epoch
                if self._dtrace is not None:
                    traces = {}
                    for rid, _entry, _fh in items:
                        self._dtrace.on_restore(rid, target.replica_id,
                                                via)
                        traces[rid] = self._dtrace.context_for(rid)
                    target.driver.restore(pairs, traces=traces, **extra)
                else:
                    target.driver.restore(pairs, **extra)
            except EpochFenced as e:
                # A fenced restore means WE are the deposed router —
                # the new primary owns these streams now. Do not park
                # them as orphans (that would double-drive on revive).
                self._count_fenced(e)
                raise
            except (ReplicaDied, KillPoint) as e:
                self._on_death(target, e)
                # Re-distribute this shard over whoever remains — from
                # FRESH mirror entries, not the originals: the target
                # may have applied part of a chunked restore and
                # streamed tokens past the old snapshot before dying
                # (_on_death just folded that backlog into the
                # mirrors), so restoring a stale entry would re-emit
                # tokens the caller already holds.
                retry = [(rid, self._wire_entry(fh), fh)
                         for rid, _, fh in items if not fh.done]
                self._distribute(retry, "replay")
                continue
            for rid, _, fh in items:
                fh.replica_id = tid
                fh.migrations += 1
                target.assigned[rid] = fh
                self._by_rid[rid] = fh
                target.shadow.observe(
                    list(fh.request.prompt),
                    max_blocks=self._affinity_blocks)
                if fh.session is not None:
                    self._session_pin(fh.session, target)
                if self._journal is not None:
                    # The re-bind is a ledger event too: recovery
                    # ignores it (fresh fleet, fresh routing) but the
                    # decision history stays auditable.
                    self._journal.append(journal_io.encode_route(
                        rid, tid, "migration"))
            self.metrics.requests_migrated += len(items)
            if via == "drain":
                self.metrics.migrated_via_drain += len(items)
            else:
                self.metrics.migrated_via_replay += len(items)
            self._tracer.on_fleet_event(
                "migration", to_replica=tid, n=len(items), via=via)

    def _fail_handle(self, fh: FleetHandle,
                     rid: Optional[int] = None) -> None:
        fh.state = RequestState.FAILED
        fh.finish_reason = FinishReason.ERROR
        fh.finish_s = self._clock()
        self.metrics.requests_failed += 1
        if self._dtrace is not None and rid is not None:
            self._dtrace.on_finish(rid, fh.state.value,
                                   fh.finish_reason.value, len(fh.tokens))
        # Drop the routing entry too: a terminally-failed handle left in
        # `_by_rid` is scanned by every subsequent `has_work` forever —
        # a slow leak across total-outage windows on a long-lived router.
        if rid is not None:
            self._by_rid.pop(rid, None)

    def _can_ever_recover(self) -> bool:
        return self._respawn and any(
            getattr(s.driver, "can_respawn", False) for s in self._slots)

    def _maybe_probe(self, slot: _ReplicaSlot, now: float) -> None:
        if not (self._respawn and getattr(slot.driver, "can_respawn",
                                          False)):
            return
        if not slot.breaker.probe_due(now):
            return
        slot.breaker.begin_probe(now)
        self.metrics.probes += 1
        try:
            slot.driver.respawn()
            slot.driver.warmup()
        except Exception as e:  # noqa: BLE001 - probe failed, stay open
            self.metrics.probe_failures += 1
            slot.breaker.record_failure(self._clock())
            self._tracer.on_fleet_event(
                "probe_failed", replica=slot.replica_id,
                error=type(e).__name__)
            return
        slot.breaker.record_success(self._clock())
        slot.state = ReplicaLifecycle.UP
        slot.reset_shadow()  # the fresh engine's radix cache is empty
        slot.wire_base = None  # fresh transport: counters restart at 0
        if self._gray is not None:
            self._gray.forget(slot.replica_id)  # fresh baseline too
        self.metrics.replica_up_events += 1
        self._tracer.on_fleet_event("replica_up", replica=slot.replica_id)
        if self._orphans:
            orphans, self._orphans = self._orphans, []
            self._distribute(
                [(rid, self._wire_entry(fh), fh) for rid, fh in orphans
                 if not fh.done],
                "replay")

    # ----------------------------------------------------- crash recovery
    @classmethod
    def recover(cls, journal_dir: str, replicas: Sequence[object], *,
                journal=None, **router_kw
                ) -> Tuple["FleetRouter", Dict[int, FleetHandle]]:
        """Rebuild a crashed router from its WAL: the
        control-plane answer to a SIGKILL with no drain possible.

        ``replicas`` are FRESH drivers (fresh engines / re-spawned
        worker processes — the old ones died with the old router);
        ``journal`` defaults to a new :class:`~.journal.RouterJournal`
        over the same directory, which the recovered router keeps
        appending to. Every stream that was durably admitted and had
        not finished re-enters through the mirror-replay path —
        the same contract hard-killed REPLICAS already recover by, so
        the streams continue token-exactly — and the first act of the
        recovered router is a fresh checkpoint: recovery is the
        snapshot path's second "normal case", not a special one.

        Returns ``(router, {rid: FleetHandle})`` — the caller's old
        handles died with the old process; these are their reborn
        equivalents, carrying the full mirrored stream so far.
        """
        entries, next_rid = journal_io.read_state(journal_dir)
        if journal is None:
            journal = journal_io.RouterJournal(journal_dir)
        router = cls(replicas, journal=journal, **router_kw)
        router._rid_counter = max(router._rid_counter, int(next_rid))
        now = router._clock()
        migrate: List[Tuple[int, Dict, FleetHandle]] = []
        for rid, entry in sorted(entries.items()):
            fh = router._handle_from_entry(entry, now)
            router._by_rid[rid] = fh
            migrate.append((rid, entry, fh))
        router._distribute(migrate, "replay")
        router._journal_checkpoint()
        router._tracer.on_fleet_event(
            "router_recovered", revived=len(migrate),
            replicas=len(router._slots))
        return router, {rid: fh for rid, _, fh in migrate}

    def _handle_from_entry(self, entry: Dict,
                           now: float) -> FleetHandle:
        """A reborn :class:`FleetHandle` from a journal mirror entry
        (the drain wire shape plus the router-level ``session``)."""
        req = Request(
            prompt=[int(t) for t in entry.get("prompt", [])],
            max_new_tokens=int(entry.get("max_new_tokens", 0)),
            sampling=drain_io.decode_sampling(entry.get("sampling")),
            deadline_s=entry.get("deadline_s"),
            priority=Priority(entry.get(
                "priority", Priority.INTERACTIVE.value)),
            adapter=entry.get("adapter"),
            constraint=entry.get("constraint"))
        fh = FleetHandle(
            req,
            arrival_s=now - float(entry.get("elapsed_s") or 0.0),
            session=entry.get("session"))
        fh.tokens = [int(t) for t in entry.get("tokens", [])]
        if entry.get("ttft_s") is not None:
            fh.ttft_s = float(entry["ttft_s"])
        return fh

    # ----------------------------------------------------- elastic scaling
    def _new_slot(self, driver) -> _ReplicaSlot:
        ids = [s.replica_id for s in self._slots]
        if driver.replica_id in ids:
            raise ValueError(
                f"replica ids must be unique, got {driver.replica_id} "
                f"already in {ids}")
        # Fleet-wide probe desynchronization: a mass-kill
        # must not schedule every replica's HALF_OPEN probe on the
        # same doubling schedule, so each breaker gets subtractive
        # jitter seeded by its replica id — deterministic per replica,
        # divergent across the fleet. An explicit breaker= policy can
        # still pin either knob.
        kw = dict(self._breaker_kw)
        kw.setdefault("jitter_frac", 0.1)
        kw.setdefault("seed", int(driver.replica_id))
        slot = _ReplicaSlot(driver, CircuitBreaker(**kw),
                            self._block_size, self._shadow_capacity,
                            self._shadow_host_capacity)
        slot.breaker.on_transition = self._circuit_observer(slot)
        if self._dtrace is not None:
            # In-process replicas arm their engine tracer here (worker
            # processes arm from their spawn config instead) — covers
            # both the initial fleet and elastic scale-up.
            arm = getattr(driver, "arm_tracing", None)
            if arm is not None:
                arm()
        self._slots.append(slot)
        return slot

    def attach_autoscaler(self, autoscaler) -> None:
        """Wire a :class:`~.autoscaler.FleetAutoscaler` into the step
        cadence: the router pumps replicas, then the controller gets
        one decision tick per round — so every existing entry point
        (``run()``, bench loops, chaos harnesses) drives the control
        loop without a second scheduler."""
        self._autoscaler = autoscaler

    @property
    def autoscaler(self):
        return self._autoscaler

    def scale_up(self, driver) -> None:
        """Add a READY replica driver to the rotation (the elastic
        scale-up mechanism; the autoscaler is the policy deciding when,
        and it spawns/warms the driver CONCURRENTLY before handing it
        here — this call itself never blocks on a warmup). Parked
        orphans re-enter service on the new replica immediately: a
        scale-up during a total outage is also a recovery."""
        if self._closed:
            raise RuntimeError("fleet router is closed")
        slot = self._new_slot(driver)
        self.metrics.scale_up_events += 1
        self._tracer.on_fleet_event(
            "scale_up", replica=slot.replica_id,
            replicas=len(self._slots))
        if self._orphans:
            orphans, self._orphans = self._orphans, []
            self._distribute(
                [(rid, self._wire_entry(fh), fh) for rid, fh in orphans
                 if not fh.done],
                "replay")

    def scale_down(self, replica_id: int) -> int:
        """Retire one replica by LIVE-MIGRATING its queued+running
        streams onto the survivors, then removing it from the rotation
        — zero lost requests by construction: the capture is the same
        drain-snapshot discipline death handling uses (`serve/drain.py`
        wire format; router-mirror replay as the fallback), but taken
        GRACEFULLY, so the snapshot path is the normal case rather than
        the lucky one. Returns the number of requests migrated off the
        victim. Refuses (``ValueError``) when no OTHER available
        replica exists to absorb them — a scale-down must never orphan
        work, that is the whole contract."""
        slot = next((s for s in self._slots
                     if s.replica_id == int(replica_id)), None)
        if slot is None:
            raise ValueError(f"no replica {replica_id} in the fleet")
        survivors = [s for s in self._slots
                     if s is not slot and s.available]
        if not survivors:
            raise ValueError(
                f"refusing to retire replica {replica_id}: no other "
                "available replica to migrate its work onto")
        now = self._clock()
        migrate, leftovers, via = self._evacuate(slot, now)
        slot.state = ReplicaLifecycle.RETIRED
        self._slots.remove(slot)
        if self._gray is not None:
            self._gray.forget(slot.replica_id)
        self._adapter_homes = {name: home for name, home
                               in self._adapter_homes.items()
                               if home is not slot}
        # Sticky sessions pinned here must not keep the retired slot
        # (and, for local replicas, its whole closed engine) alive
        # until LRU eviction: unlike a DEAD slot — which stays in
        # `_slots` awaiting a probe — a retirement is final. Dropped
        # sessions simply re-route by affinity; migration re-pins the
        # in-flight ones to their new replica below.
        for name in [n for n, s in self._sessions.items() if s is slot]:
            del self._sessions[name]
        n_moved = len(migrate) + len(leftovers)
        self.metrics.scale_down_events += 1
        self.metrics.scale_down_migrated += n_moved
        self._tracer.on_fleet_event(
            "scale_down", replica=slot.replica_id, migrated=n_moved,
            via=via, replicas=len(self._slots))
        self._distribute(migrate, via)
        if leftovers:
            self._distribute(leftovers, "replay")
        try:
            slot.driver.close()
        except Exception:  # noqa: BLE001 - retirement is best-effort
            pass
        return n_moved

    # ------------------------------------------------------------ teardown
    def drain(self) -> Dict[str, object]:
        """Graceful fleet-wide drain: every live replica's in-flight
        requests in one `serve/drain.py`-format snapshot (restorable
        into a fresh engine or fleet). The router stops accepting."""
        now = self._clock()
        entries: List[Dict[str, object]] = []
        for slot in self._slots:
            if slot.state is not ReplicaLifecycle.UP:
                continue
            pairs = self._capture(slot, now)
            if pairs is None:
                entries.extend(self._wire_entry(fh)
                               for fh in slot.assigned.values()
                               if not fh.done)
                continue
            in_snapshot = set()
            for rid, entry in pairs:
                in_snapshot.add(rid)
                fh = self._by_rid.get(rid)
                if fh is not None and fh.done:
                    continue  # settled by the backlog applied above
                entries.append(entry)
            entries.extend(
                entry for _, entry, _ in
                self._mirror_leftovers(slot, in_snapshot))
        entries.extend(self._wire_entry(fh) for _, fh in self._orphans
                       if not fh.done)
        self._closed = True
        if self._journal is not None:
            self._journal.commit()
        return {"version": drain_io.SNAPSHOT_VERSION,
                "drained_unix_s": time.time(), "requests": entries}

    def close(self) -> None:
        self._closed = True
        if self._autoscaler is not None:
            self._autoscaler.close()  # an in-flight spawn dies too
        for slot in self._slots:
            try:
                slot.driver.close()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
        if self._journal is not None:
            try:
                self._journal.close()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
