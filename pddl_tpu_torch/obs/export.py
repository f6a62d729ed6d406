"""Dependency-free exporters for the observability layer.

The port's own copy of :mod:`pddl_tpu.obs.export` (host Python, no JAX):
the same names, error texts, literal tables and wire shapes.

Two consumers, two formats, zero new dependencies:

- **JSONL event log** (:class:`JsonlEventLog`): one schema-versioned
  JSON object per line — span records from `obs/trace.py`, tick
  records from the engine's telemetry ring, whatever a bench wants to
  append. Writes are single ``os.write`` calls on an ``O_APPEND``
  descriptor, so concurrent writers interleave at LINE granularity
  (the same torn-write discipline `serve/drain.py` applies to its
  snapshot) and ``tail -f`` always sees whole records.
- **Prometheus text exposition** (:func:`render_prometheus` and the
  :func:`serve_exposition` convenience): the v0.0.4 text format over
  ``ServeMetrics.snapshot()`` plus engine gauges (`engine_gauges`:
  ``prefix_pool_nbytes``, ``live_slots``, ``degraded``, per-site
  ``compile_counts``), the training `StepTimer` snapshot, and
  device-memory stats (`device_memory_gauges`) — training and serving
  share one export path. The renderer enumerates EVERY key of the
  snapshot it is handed (unknown keys render as gauges), which is what
  makes the snapshot-drift guard in `tests/test_obs.py` structural: a
  new counter cannot silently skip export.

:func:`parse_prometheus_text` is the strict round-trip parser the
tests pin the renderer against (and a convenience for scrape tooling);
:class:`MetricsHTTPServer` serves ``collect()`` at ``/metrics`` from a
stdlib ``http.server`` daemon thread for anything that scrapes.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

SCHEMA_VERSION = 1

# ---------------------------------------------------------------- JSONL


class JsonlEventLog:
    """Atomic-append JSONL writer: one record, one line, one write.

    Each record gains ``schema`` (the event-log schema version) unless
    it already carries one. The descriptor is opened ``O_APPEND`` and
    every line lands in a single ``os.write``, so a reader (or a
    second writer) never sees a torn line.
    """

    def __init__(self, path: str):
        self.path = path
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self._fd: Optional[int] = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self.records_written = 0

    def write(self, record: Mapping[str, object]) -> None:
        if self._fd is None:
            raise ValueError(f"event log {self.path!r} is closed")
        rec = dict(record)
        rec.setdefault("schema", SCHEMA_VERSION)
        line = json.dumps(rec, separators=(",", ":"),
                          allow_nan=False, default=_json_default)
        data = (line + "\n").encode("utf-8")
        # os.write may land a partial write (ENOSPC, signals); finish
        # the line before counting the record as written.
        while data:
            n = os.write(self._fd, data)
            data = data[n:]
        self.records_written += 1

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "JsonlEventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _json_default(obj):
    """Tolerate numpy scalars riding in telemetry records."""
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


def read_jsonl(path: str):
    """Parse every line of an event log (tooling/test convenience)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ----------------------------------------------------------- Prometheus

# ServeMetrics.snapshot() keys that are monotonic counters (everything
# else renders as a gauge). Keep in sync with
# `pddl_tpu/serve/metrics.py` — the drift guard asserts every snapshot
# key is exported either way, so a missing entry here degrades a
# counter to a gauge, never drops it.
SERVE_COUNTER_KEYS = frozenset({
    "requests_finished", "requests_rejected", "requests_timed_out",
    "requests_cancelled", "requests_failed", "requests_deadline_shed",
    "tokens_emitted", "prefix_lookups", "prefix_hits",
    "prefill_tokens_saved", "prefix_evictions", "retries", "replays",
    "preemptions", "degraded_entries", "degraded_time_s",
    "copy_bytes_avoided",
    # Multi-tenant counters (`serve/tenant/`): adapter pool traffic and
    # constrained-decoding volume. (adapter_hit_rate / the residency
    # gauge / requests_by_adapter stay gauges.)
    "adapter_hits", "adapter_loads", "adapter_evictions",
    "constrained_requests", "requests_grammar_complete",
    # Speculative serving (engine ``spec_k > 0``): verify windows and
    # the drafted/accepted token volume behind the acceptance-rate
    # gauge (the rate itself stays a gauge).
    "spec_ticks", "spec_drafted_tokens", "spec_accepted_tokens",
    # Tiered KV cache (`serve/kvcache/hosttier.py`): demotion/promotion
    # traffic and the promotion budget charge (the residency gauge
    # host_tier_bytes_resident stays a gauge).
    "host_tier_spills", "host_tier_hits", "host_tier_promotions",
    "host_tier_promote_tokens_charged",
})

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _fmt_value(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if isinstance(v, float) else str(int(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


# Latency histogram bucket edges (seconds): the conventional
# Prometheus latency ladder, clipped to the ranges the serving SLOs
# actually alarm on. TTFT spans queue wait + prefill (up to seconds
# under load); per-token decode latency is an order of magnitude
# tighter.
TTFT_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                  1.0, 2.5, 5.0, 10.0)
TOKEN_LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                           0.1, 0.25, 1.0)


def reservoir_histogram(reservoir,
                        buckets: Sequence[float]) -> Dict[str, object]:
    """A :class:`~pddl_tpu_torch.serve.metrics.Reservoir` (or any iterable
    of floats) folded into the renderer's histogram spec: CUMULATIVE
    per-``le`` counts in ascending edge order plus the implicit
    ``+Inf`` bucket, with ``sum``/``count`` over the same samples —
    so ``le="+Inf"`` always equals ``count``, the consistency the
    round-trip test pins."""
    edges = sorted(float(b) for b in buckets)
    samples = sorted(float(v) for v in reservoir)
    cum: Dict[str, int] = {}
    i = 0
    for edge in edges:
        while i < len(samples) and samples[i] <= edge:
            i += 1
        cum[format(edge, "g")] = i
    cum["+Inf"] = len(samples)
    return {"buckets": cum, "sum": float(sum(samples)),
            "count": len(samples)}


def render_prometheus(snapshot: Mapping[str, object], *,
                      prefix: str = "pddl",
                      counters: frozenset = frozenset(),
                      help_text: Optional[Mapping[str, str]] = None,
                      histograms: Optional[Mapping[str, Mapping]] = None,
                      ) -> str:
    """Render a flat snapshot dict as Prometheus text exposition.

    EVERY key renders: scalars become ``{prefix}_{key}`` (counters per
    ``counters`` get the conventional ``_total`` suffix), ``None``
    renders as ``NaN`` (present-but-unobserved beats absent — a scrape
    can tell "no samples yet" from "metric vanished"), booleans as
    0/1, and Mapping values become one labeled series
    ``{prefix}_{key}{{key="..."}}`` per entry (``compile_counts``,
    per-device memory). Keys must already be exposition-legal
    (``[a-zA-Z0-9_]``) — snapshots in this repo are.

    ``histograms`` maps extra metric names to
    :func:`reservoir_histogram` specs, rendered as conventional
    cumulative histograms (``{name}_bucket{{le="..."}}`` ascending,
    ``le="+Inf"`` == ``{name}_count``, plus ``_sum``/``_count``) —
    the shape every Prometheus quantile/burn-rate recipe expects.
    """
    lines = []
    for key in snapshot:
        value = snapshot[key]
        name = f"{prefix}_{key}"
        if not _NAME_RE.match(name):
            raise ValueError(f"metric name {name!r} is not "
                             "exposition-legal")
        is_counter = key in counters
        if is_counter and not name.endswith("_total"):
            name += "_total"
        if help_text and key in help_text:
            lines.append(f"# HELP {name} {help_text[key]}")
        if isinstance(value, Mapping):
            lines.append(f"# TYPE {name} gauge")
            if not value:
                # An OPEN label set with no members yet (e.g.
                # requests_by_adapter before any tenant traffic) still
                # exports its metric name — one NaN sample under an
                # empty label, the same present-but-unobserved
                # philosophy as None -> NaN — so the snapshot-drift
                # guard (and a scrape differ) can tell "no labels yet"
                # from "metric vanished".
                lines.append(f'{name}{{key=""}} NaN')
            for label_val in sorted(value):
                lines.append(
                    f'{name}{{key="{_escape_label(str(label_val))}"}} '
                    f"{_fmt_value(value[label_val])}")
        else:
            lines.append(f"# TYPE {name} "
                         f"{'counter' if is_counter else 'gauge'}")
            lines.append(f"{name} {_fmt_value(value)}")
    for key in (histograms or {}):
        spec = histograms[key]
        name = f"{prefix}_{key}"
        if not _NAME_RE.match(name):
            raise ValueError(f"metric name {name!r} is not "
                             "exposition-legal")
        lines.append(f"# TYPE {name} histogram")
        buckets = spec["buckets"]
        for le in buckets:
            lines.append(f'{name}_bucket{{le="{le}"}} '
                         f"{int(buckets[le])}")
        lines.append(f"{name}_sum {_fmt_value(float(spec['sum']))}")
        lines.append(f"{name}_count {int(spec['count'])}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{([^{}]*)\})?"                     # optional label set
    r" (NaN|[+-]Inf|[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|histogram|summary|untyped)$")


def parse_prometheus_text(text: str) -> Tuple[
        Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float],
        Dict[str, str]]:
    """STRICT parse of the text exposition format.

    Returns ``(samples, types)``: ``samples`` maps
    ``(name, sorted-label-pairs)`` to the float value, ``types`` maps
    metric name to its declared ``# TYPE``. Any line that is neither a
    well-formed sample, a ``# TYPE``/``# HELP`` comment, nor blank
    raises ``ValueError`` — this is the round-trip referee for
    :func:`render_prometheus`, so leniency here would hide renderer
    bugs.
    """
    samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                if m.group(1) in types:
                    raise ValueError(
                        f"line {lineno}: duplicate # TYPE for "
                        f"{m.group(1)!r}")
                types[m.group(1)] = m.group(2)
                continue
            if line.startswith("# HELP "):
                continue
            raise ValueError(f"line {lineno}: malformed comment "
                             f"{line!r}")
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name, labels_raw, value = m.group(1), m.group(2), m.group(3)
        labels: Tuple[Tuple[str, str], ...] = ()
        if labels_raw:
            parsed = _LABEL_RE.findall(labels_raw)
            # Re-render to catch trailing junk the findall skipped.
            rebuilt = ",".join(f'{k}="{v}"' for k, v in parsed)
            if rebuilt != labels_raw.rstrip(","):
                raise ValueError(
                    f"line {lineno}: malformed labels {labels_raw!r}")
            labels = tuple(sorted(parsed))
        key = (name, labels)
        if key in samples:
            raise ValueError(f"line {lineno}: duplicate sample {key}")
        samples[key] = float(value)
    return samples, types


# ------------------------------------------------------- gauge sources


def engine_gauges(engine) -> Dict[str, object]:
    """The live-engine gauges the exposition carries beyond
    ``ServeMetrics``: slot occupancy, queue depth, the degraded flag,
    the sheddable prefix-pool HBM, drain state, and the per-site
    compiled-executable counts (any value above 1 in a scrape is a
    recompile — the zero-recompile contract as a dashboard line)."""
    return {
        "live_slots": engine.live_slots,
        "max_slots": engine.max_slots,
        "queue_depth": engine.scheduler.depth,
        "degraded": engine.degraded,
        "drained": engine.drained,
        "prefix_pool_nbytes": engine.prefix_pool_nbytes,
        # Paged-attention gauges (0 / 0.0 on a copy-mode engine): live
        # cross-slot sharing and table occupancy, the dashboard's view
        # of the in-place prefix sharing (`ServeEngine.paged`).
        "paged": getattr(engine, "paged", False),
        "blocks_shared": getattr(engine, "blocks_shared", 0),
        "block_table_fill": getattr(engine, "block_table_fill", 0.0),
        # Speculative-serving gauges (0 on a classic engine): the
        # compiled draft width and whether a draft model (second paged
        # cache tree) is doing the drafting.
        "spec_k": getattr(engine, "spec_k", 0),
        "spec_draft_model": getattr(engine, "spec_draft_model_enabled",
                                    False),
        # Tiered-KV-cache gauges (False/0 without a host tier): whether
        # the spill tier is armed and its live host-side residency —
        # the "Host tier sizing" runbook's watchlist lines.
        "host_tier": getattr(engine, "host_tier_enabled", False),
        "host_tier_bytes_resident": getattr(
            engine, "host_tier_bytes_resident", 0),
        "host_tier_blocks_resident": getattr(
            engine, "host_tier_blocks_resident", 0),
        # Multi-tenant gauges (False/0 on a plain engine): whether the
        # tenant path is compiled in, and how many adapters are
        # device-resident right now (`serve/tenant/`).
        "tenant": getattr(engine, "tenant_enabled", False),
        "adapter_pool_resident": getattr(engine, "adapter_pool_resident",
                                         0),
        "compile_counts": engine.compile_counts(),
    }


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card memory (bytes) from the CUDA caching allocator: bytes
    allocated now and at peak, and the card's total memory as the
    limit. Empty on a host without a card."""
    import torch  # noqa: PLC0415

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          -1)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               -1)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(i).total_memory),
        }
    return out


def device_memory_gauges() -> Dict[str, object]:
    """:func:`device_memory_stats` reshaped for the renderer: one
    labeled series per stat, one label per device."""
    stats = device_memory_stats()
    out: Dict[str, Dict[str, int]] = {
        "bytes_in_use": {}, "peak_bytes_in_use": {}, "bytes_limit": {}}
    for dev, fields in stats.items():
        for k in out:
            out[k][dev] = fields[k]
    return out


TRAIN_COUNTER_KEYS = frozenset({
    # Trainer.fault_snapshot() keys that are monotonic counters; the
    # rest render as gauges. The drift guard in tests/test_train_faults
    # asserts every snapshot key exports either way.
    "retries", "recoveries", "replayed_steps", "checkpoints_saved",
    "checkpoint_wall_s",
})


def train_exposition(trainer, *, step_timer=None,
                     device_memory: bool = False) -> str:
    """The training scrape body: the Trainer's fault/recovery snapshot
    (retries, in-process recoveries, replayed steps, checkpoint count
    and wall time, per-kind injections, per-site dispatch wall,
    compile counts — any ``compile_counts`` value above 1 on a scrape
    is a recompile, the zero-recompile contract as a dashboard line),
    optionally the `StepTimer` percentiles and per-device memory —
    the SAME renderer and text format the serving engine exports
    through, so one Prometheus config scrapes both."""
    parts = [render_prometheus(trainer.fault_snapshot(),
                               prefix="pddl_train",
                               counters=TRAIN_COUNTER_KEYS)]
    if step_timer is not None:
        parts.append(render_prometheus(
            step_timer.snapshot(), prefix="pddl_train_step",
            counters=frozenset({"steps_timed"})))
    if device_memory:
        parts.append(render_prometheus(device_memory_gauges(),
                                       prefix="pddl_device_memory"))
    return "".join(parts)


# The canonical fleet-counter vocabulary: FleetMetrics.snapshot()
# derives its keys from this set (and render's counter typing reads
# it), so there is exactly one list to extend per new counter.
FLEET_COUNTER_KEYS = frozenset({
    "replica_up_events", "replica_down_events", "migrations",
    "requests_migrated", "migrated_via_drain", "migrated_via_replay",
    "requests_routed", "routed_sticky", "routed_affinity", "routed_hash",
    "routed_load_balanced", "routed_adapter",
    "shed_rerouted", "shed_rejected", "requests_finished",
    "requests_failed", "requests_orphaned", "heartbeat_failures",
    "probes", "probe_failures", "tokens_streamed",
    # Admission control / brownout (`serve/fleet/admission.py`): the
    # front-door rejections and ladder movement. Per-class splits
    # flatten to admission_rejected_<class>, typed counters below like
    # the circuit_* transitions.
    "admission_rate_limited", "brownout_shed_best_effort",
    "brownout_rejected_cold", "brownout_capped_output",
    "brownout_escalations", "brownout_deescalations",
    # Elastic scaling mechanism counters (`serve/fleet/autoscaler.py`
    # is the policy; the router executes): replicas added/retired at
    # runtime, and the requests scale-downs live-migrated. Per-class
    # delivery splits flatten to tokens_streamed_<class>, typed
    # counters below like the circuit_* transitions.
    "scale_up_events", "scale_down_events", "scale_down_migrated",
    # Tiered KV cache at fleet level: prefix-affinity routes
    # taken because a replica held the chain in HOST RAM (no replica
    # had it in HBM), and replica-to-replica chain pulls — the
    # duplicate-prefill eliminator — with the tokens they moved.
    "routed_host_tier", "chain_pulls", "chain_pull_tokens",
    # Control-plane durability & gray failure: interactive
    # hedges launched off suspected-gray replicas / won by the hedge
    # copy / duplicate copies cancelled, suspects proactively retired
    # through the scale_down migration path, and the framed
    # transport's resend rounds + CRC/length rejects aggregated from
    # every process replica's wire stats.
    "hedges_launched", "hedge_wins", "hedge_cancelled", "gray_drains",
    "wire_retries", "wire_crc_rejects",
    # Disaggregated prefill/decode serving: admissions routed to the
    # prefill pool, prefill->decode stream hand-offs completed/failed, and the chain
    # payload they moved. (`decode_long_prompt_stalls` is deliberately
    # NOT here: it exports as a gauge, NaN while the fleet is not
    # disaggregation-armed.)
    "routed_prefill", "handoffs_completed", "handoffs_failed",
    "handoff_bytes", "handoff_tokens",
    # Journal storage health:
    # every OSError the WAL's VFS shim surfaced (bounded-backoff
    # retries included), entries into the NON_DURABLE degraded mode,
    # and re-arms back to durable. The live alarmed state is the
    # `journal_non_durable` gauge below.
    "journal_storage_errors", "journal_degraded_events",
    "journal_rearms",
    # Router high availability:
    # standby promotions to primary, worker-side epoch refusals of a
    # deposed router's commands (each one is a split-brain write that
    # did NOT happen — any nonzero value during steady state is a
    # page), and WAL-tail catch-up resyncs (checkpoint+segment reads
    # covering stream gaps or NON_DURABLE backlogs). The live
    # `router_epoch` / `lease_age_s` / `standby_lag_records` gauges
    # ride below.
    "takeovers", "fenced_commands_refused", "standby_catchups",
})


# The controller-side vocabulary (`serve/fleet/autoscaler.py`):
# AutoscaleMetrics.snapshot() derives its keys from this set, exactly
# the FLEET_COUNTER_KEYS discipline — one list to extend per counter.
# Decision-tick splits flatten to decision_ticks_<decision>.
AUTOSCALE_COUNTER_KEYS = frozenset({
    "scale_up_started", "scale_up_completed", "scale_up_failed",
    "scale_down_completed", "scale_down_vetoed", "spawn_timeouts",
})


def fleet_exposition(router, autoscaler=None) -> str:
    """The fleet-router scrape body: :class:`~pddl_tpu_torch.serve.fleet.
    FleetMetrics` counters (circuit transitions and per-class
    ``tokens_streamed_<class>`` splits included as flattened counters)
    plus live per-replica gauges — lifecycle, breaker state, and
    assigned load as labeled series keyed by replica id. Same
    renderer/text format as serving and training, so one Prometheus
    config scrapes all three tiers.

    ``autoscaler`` (defaults to the router's attached one, if any)
    appends the elastic-scaling series under ``pddl_fleet_autoscale_``:
    the controller counters (scale attempts/completions/vetoes, spawn
    timeouts, decision-tick splits) and its live gauges (fleet size,
    pending spawns, pressure, per-class goodput rates) — the scale
    events the runbook reads during a capacity page."""
    snap = dict(router.metrics.snapshot())
    counters = FLEET_COUNTER_KEYS | {
        k for k in snap
        if k.startswith(("circuit_", "admission_rejected_",
                         "tokens_streamed_"))}
    snap["replicas"] = len(router.replicas)
    snap["replicas_healthy"] = router.healthy_replicas
    # Disaggregation: pool sizes as a role-labeled series
    # (every vocabulary role present, so a dashboard's query shape
    # does not depend on the fleet's), and the decode-side stall gauge
    # — NaN while the fleet is not disaggregation-armed, the same
    # present-but-unobserved philosophy as the journal gauges below.
    role_counts = {role: 0 for role in ("prefill", "decode", "unified")}
    for s in router.replicas:
        role = getattr(s.driver, "role", "unified")
        role_counts[role] = role_counts.get(role, 0) + 1
    snap["replicas_by_role"] = role_counts
    armed = bool(getattr(router, "disagg_armed", False))
    snap["decode_long_prompt_stalls"] = (
        router.metrics.decode_long_prompt_stalls if armed else None)
    # Control-plane durability gauges. Present even when
    # the subsystem is unarmed — None renders NaN, the same
    # present-but-unobserved philosophy as every other gauge, so a
    # dashboard can tell "journal off" from "metric vanished".
    journal = getattr(router, "journal", None)
    snap["journal_bytes"] = (journal.wal_bytes
                             if journal is not None else None)
    snap["journal_lag_records"] = (journal.records_since_checkpoint
                                   if journal is not None else None)
    # The widened loss-on-crash window, live: 1 while the
    # WAL runs NON_DURABLE (acks flowing, backlog in memory), 0 while
    # durable, NaN when no journal is armed. THE disk-failure pager.
    snap["journal_non_durable"] = (
        int(bool(getattr(journal, "non_durable", False)))
        if journal is not None else None)
    gray = getattr(router, "gray", None)
    snap["replicas_suspected_gray"] = (len(gray.suspected)
                                       if gray is not None else None)
    # Router HA gauges: the armed fencing epoch (NaN on an
    # epoch-free router — the pre-HA deployment shape), the lease's
    # age since last renewal (read against its TTL: age approaching
    # TTL means the holder's renewal loop is wedged), and the hot
    # standby's replication lag in WAL records (0 = promotable with an
    # empty loss window). `router.ha` duck-types either side of the
    # pair: a primary's LeaseKeeper or a promoted HotStandby.
    snap["router_epoch"] = getattr(router, "epoch", None)
    ha = getattr(router, "ha", None)
    lease_age = getattr(ha, "lease_age_s", None)
    snap["lease_age_s"] = lease_age() if callable(lease_age) else None
    lag = getattr(ha, "lag_records", None)
    snap["standby_lag_records"] = lag() if callable(lag) else None
    if router.admission is not None:
        # The ladder rung as a gauge: 0 NORMAL … 3 REJECT_COLD. The
        # runbook's first stop during an overload page.
        snap["brownout_rung"] = int(router.admission.rung)
    snap["replica_state"] = {
        f"r{s.replica_id}": 1 if s.state.value == "up" else 0
        for s in router.replicas}
    snap["replica_breaker_open"] = {
        f"r{s.replica_id}": 0 if s.breaker.allows_traffic else 1
        for s in router.replicas}
    snap["replica_load"] = {
        f"r{s.replica_id}": s.load for s in router.replicas}
    parts = [render_prometheus(snap, prefix="pddl_fleet",
                               counters=frozenset(counters))]
    if autoscaler is None:
        autoscaler = getattr(router, "autoscaler", None)
    if autoscaler is not None:
        auto = dict(autoscaler.metrics.snapshot())
        auto_counters = AUTOSCALE_COUNTER_KEYS | {
            k for k in auto if k.startswith("decision_ticks_")}
        auto.update(autoscaler.gauges())
        parts.append(render_prometheus(
            auto, prefix="pddl_fleet_autoscale",
            counters=frozenset(auto_counters)))
    return "".join(parts)


def serve_exposition(metrics, engine=None, *,
                     step_timer=None,
                     device_memory: bool = False) -> str:
    """The one scrape body: serving metrics (+ engine gauges + ring
    summary when an engine is given), optionally the training
    `StepTimer` snapshot and per-device memory — training and serving
    through a single export path."""
    parts = [render_prometheus(
        metrics.snapshot(), prefix="pddl_serve",
        counters=SERVE_COUNTER_KEYS,
        # Cumulative latency histograms over the same reservoirs the
        # p50/p99 gauges estimate from — the dashboard's
        # histogram_quantile() and SLO burn-rate source.
        histograms={
            "ttft_seconds": reservoir_histogram(
                metrics.ttft_s, TTFT_BUCKETS_S),
            "token_latency_seconds": reservoir_histogram(
                metrics.token_latency_s, TOKEN_LATENCY_BUCKETS_S),
        })]
    if engine is not None:
        parts.append(render_prometheus(engine_gauges(engine),
                                       prefix="pddl_serve_engine"))
        summary = engine.telemetry.summary()
        # The ring summary's non-scalar fields are labeled series
        # already shaped for the renderer; drop the step window (ids,
        # not measurements).
        summary.pop("window_first_step", None)
        summary.pop("window_last_step", None)
        parts.append(render_prometheus(summary, prefix="pddl_serve_ring"))
    if step_timer is not None:
        parts.append(render_prometheus(
            step_timer.snapshot(), prefix="pddl_train_step",
            counters=frozenset({"steps_timed"})))
    if device_memory:
        parts.append(render_prometheus(device_memory_gauges(),
                                       prefix="pddl_device_memory"))
    return "".join(parts)


# ------------------------------------------------------- HTTP endpoint


class MetricsHTTPServer:
    """``/metrics`` on a stdlib HTTP server (daemon thread).

    ``collect`` is called per scrape and must return the exposition
    text (build it with :func:`serve_exposition`); a raising collect
    answers 500 with the error text instead of killing the thread.
    ``port=0`` binds an ephemeral port (tests); read it back from
    ``server.port``.
    """

    def __init__(self, collect: Callable[[], str],
                 host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API name
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404, "only /metrics is served")
                    return
                try:
                    body = collect().encode("utf-8")
                except Exception as e:  # noqa: BLE001 - scrape must not kill
                    body = f"collect failed: {e}\n".encode("utf-8")
                    self.send_response(500)
                else:
                    self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet: scrapes are chatty
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="pddl-metrics-http")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsHTTPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
