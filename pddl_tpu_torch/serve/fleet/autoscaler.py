"""Elastic autoscaling: the control loop that closes the fleet's size.

The port's own copy of :mod:`pddl_tpu.serve.fleet.autoscaler` (host
Python, no JAX): the same names, error texts, literal tables and wire
shapes.

The fleet is robust to faults (breakers, live migration) and to
overload (admission, brownout) — but its SIZE is static, so
sustained overload can only shed and idle capacity can only burn.
AlpaServe (Li et al., OSDI '23) frames the capacity question the right
way — SLO attainment per resource-hour, not raw throughput — and
Llumnix (Sun et al., OSDI '24) shows live migration is the right
primitive for rescheduling LLM requests across instances. This module
is the controller that applies both: watch the pressure the fleet
already measures, and use the migration machinery the fleet already
has, to scale in BOTH directions without losing a request.

**Signals.** The :class:`~.admission.OverloadDetector`'s pressure (the
rejected/shed fraction of recent submits, floored while any replica is
OOM-degraded) plus the mean assigned load per available replica, and —
for observability and the scale-down guard — per-class goodput rates
derived from the router's ``tokens_streamed_by_priority`` counters over
a sliding window.

**Hysteresis** (the :class:`~.admission.BrownoutController` discipline,
applied to capacity): pressure must hold above ``up_pressure`` for
``up_hold_s`` before a scale-up starts, and below ``down_pressure``
(with load under ``down_load``) for ``down_hold_s`` before a
scale-down; every executed action opens a ``cooldown_s`` window in
which no further action fires. One replica per action — a storm walks
capacity up a rung at a time, exactly like the brownout ladder walks
shedding. ``up_pressure`` defaults BELOW the brownout ladder's
``high`` water mark on purpose: capacity arrives ahead of the ladder
engaging, so brownout stays the last resort, not the first response.

**Scale-up = concurrent warm-start.** The ``replica_factory`` spawns
an UNREADY driver (a :class:`~.replica.ProcessReplica` with
``wait_ready=False``); the controller polls
:meth:`~.replica.ProcessReplica.poll_ready` once per tick while the
fleet keeps serving, and hands the driver to
:meth:`~.router.FleetRouter.scale_up` only when its engine is built
and warmed. A wedged spawn raises the typed
:class:`~.replica.ReplicaSpawnTimeout`; the attempt fails FAST and a
breaker-style doubling backoff gates the retry, so a broken image
cannot make the control loop spawn-storm.

**Scale-down = live migration, zero loss by construction.** The victim
(the least-loaded available replica) retires through
:meth:`~.router.FleetRouter.scale_down`: its queued+running streams are
captured via its drain snapshot (`serve/drain.py` wire format — the
same one failover uses, but taken gracefully) and restored onto
survivors before the process exits. A projection guard vetoes the
retirement when the survivors could not absorb the victim's load
without re-crossing the scale-up threshold — shrink must not cause the
very pressure that forces the next grow.

Every transition (SCALE_UP/SCALE_DOWN/HOLD/COOLDOWN) is counted in
:class:`AutoscaleMetrics`, exported through
:func:`pddl_tpu_torch.obs.export.fleet_exposition` (``pddl_fleet_autoscale_*``)
and traced via ``on_fleet_event("autoscale", ...)``.
"""

from __future__ import annotations

import enum
import random
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from pddl_tpu_torch.serve.fleet.disagg import role_of, validate_role
from pddl_tpu_torch.serve.fleet.replica import ReplicaDied, ReplicaSpawnTimeout


class ScaleDecision(enum.Enum):
    """One control tick's outcome. HOLD covers both "signals are in the
    dead band" and "an action's hold timer is still accumulating";
    COOLDOWN means an action recently fired and the controller is
    deliberately deaf; SCALE_UP/SCALE_DOWN mark the ticks that START a
    spawn (or complete one) / execute a retirement."""

    HOLD = "hold"
    SCALE_UP = "scale_up"
    SCALE_DOWN = "scale_down"
    COOLDOWN = "cooldown"


class AutoscaleMetrics:
    """Controller-side counters (the router's FleetMetrics carries the
    mechanism side: ``scale_up_events``/``scale_down_events``/
    ``scale_down_migrated``). Snapshot keys derive from the exporter's
    canonical ``AUTOSCALE_COUNTER_KEYS`` so the two cannot drift —
    the same discipline as FleetMetrics."""

    def __init__(self):
        self.scale_up_started = 0     # spawns launched
        self.scale_up_completed = 0   # spawns that joined the rotation
        self.scale_up_failed = 0      # spawn timeout or death pre-ready
        self.scale_down_completed = 0
        self.scale_down_vetoed = 0    # projection guard refused a shrink
        self.spawn_timeouts = 0       # the ReplicaSpawnTimeout subset
        self.decision_ticks: Dict[str, int] = {
            d.value: 0 for d in ScaleDecision}

    def snapshot(self) -> Dict[str, object]:
        from pddl_tpu_torch.obs.export import (  # noqa: PLC0415
            AUTOSCALE_COUNTER_KEYS)

        out = {k: getattr(self, k) for k in sorted(AUTOSCALE_COUNTER_KEYS)}
        for d, n in sorted(self.decision_ticks.items()):
            out["decision_ticks_" + d] = n
        return out


class FleetAutoscaler:
    """Hysteretic pressure-driven capacity controller over one
    :class:`~.router.FleetRouter`.

    Args:
      router: the fleet to control. The constructor attaches itself
        (``router.attach_autoscaler``), so every ``router.step()``
        drives one control tick — benches and chaos tests that pump
        the router get the control loop for free.
      replica_factory: ``fn(replica_id) -> driver``. For process
        fleets, return ``ProcessReplica(..., wait_ready=False)`` — the
        controller polls readiness concurrently. A driver without
        ``poll_ready`` (``LocalReplica``) counts as ready immediately.
      min_replicas / max_replicas: hard fleet-size bounds (a pending
        spawn counts against ``max_replicas``).
      up_pressure: overload-detector pressure that, held for
        ``up_hold_s``, starts a scale-up. Keep it BELOW the brownout
        ladder's ``high`` mark so capacity engages first.
      down_pressure / down_load: recovery band — pressure at or below
        ``down_pressure`` AND mean assigned load per available replica
        at or below ``down_load``, held for ``down_hold_s``, retires
        one replica.
      up_load: optional load trigger — mean assigned load per
        available replica at or above this also arms scale-up (and
        powers the scale-down projection guard). ``None`` disables
        both (pressure-only control; no projection veto).
      cooldown_s: post-action deafness (flap damping on top of the
        hold hysteresis).
      goodput_window_s: sliding window for the per-class goodput rates
        (:meth:`goodput_tokens_per_s`).
      spawn_backoff_base_s / spawn_backoff_max_s: bounded exponential
        backoff between FAILED spawn attempts (doubles per failure,
        resets on success) — the circuit-breaker discipline applied to
        the factory.
      tracer: defaults to the router's tracer.
      clock: defaults to the router's clock (one epoch for holds,
        cooldowns, breaker backoffs, and heartbeats).
      role: scope this controller to ONE role pool of a disaggregated
        fleet (`fleet/disagg.py`): size bounds, mean load, and the
        retirement victim are all computed over replicas of this role
        only, and the factory is expected to produce drivers carrying
        it. ``None`` (default) controls the whole fleet — the
        pre-disaggregation behavior.
      attach: attach to the router's step cadence (the default).
        :class:`~pddl_tpu_torch.serve.fleet.disagg.RoleAutoscaler` passes
        ``False`` — it multiplexes several controllers behind one
        attachment, and a second ``attach_autoscaler`` would silently
        replace the first.
      id_alloc: optional ``fn() -> int`` minting replica ids. Per-role
        controllers over one fleet MUST share an allocator (the
        multiplexer provides it) — each minting independently would
        collide on the shared id space. ``None`` uses an internal
        counter seeded past the fleet's current ids.
    """

    def __init__(self, router, replica_factory, *,
                 min_replicas: int = 1, max_replicas: int = 8,
                 up_pressure: float = 0.15, down_pressure: float = 0.02,
                 up_load: Optional[float] = None, down_load: float = 1.0,
                 up_hold_s: float = 0.25, down_hold_s: float = 2.0,
                 cooldown_s: float = 1.0,
                 goodput_window_s: float = 5.0,
                 spawn_backoff_base_s: float = 0.5,
                 spawn_backoff_max_s: float = 30.0,
                 spawn_jitter_frac: float = 0.0,
                 spawn_jitter_seed: Optional[int] = None,
                 tracer=None, clock=None,
                 role: Optional[str] = None, attach: bool = True,
                 id_alloc=None):
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}")
        if not 0.0 <= down_pressure < up_pressure <= 1.0:
            raise ValueError(
                f"need 0 <= down_pressure < up_pressure <= 1, got "
                f"{down_pressure}/{up_pressure}")
        if spawn_backoff_base_s <= 0 \
                or spawn_backoff_max_s < spawn_backoff_base_s:
            raise ValueError(
                f"need 0 < spawn_backoff_base_s <= spawn_backoff_max_s, "
                f"got {spawn_backoff_base_s}/{spawn_backoff_max_s}")
        if not 0.0 <= spawn_jitter_frac < 1.0:
            raise ValueError(
                f"spawn_jitter_frac must be in [0, 1), got "
                f"{spawn_jitter_frac}")
        self.router = router
        self._factory = replica_factory
        self.role = (validate_role(role) if role is not None else None)
        self._id_alloc = id_alloc
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_pressure = float(up_pressure)
        self.down_pressure = float(down_pressure)
        self.up_load = float(up_load) if up_load is not None else None
        self.down_load = float(down_load)
        self.up_hold_s = float(up_hold_s)
        self.down_hold_s = float(down_hold_s)
        self.cooldown_s = float(cooldown_s)
        self.goodput_window_s = float(goodput_window_s)
        self._clock = clock if clock is not None else router.clock
        self._tracer = tracer if tracer is not None else router.tracer
        self.metrics = AutoscaleMetrics()
        self._next_id = 1 + max(
            (s.replica_id for s in router.replicas), default=-1)
        self._pending = None            # spawned driver, not ready yet
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._cooldown_until = float("-inf")
        self._spawn_backoff_s = float(spawn_backoff_base_s)
        self._spawn_backoff_base_s = float(spawn_backoff_base_s)
        self._spawn_backoff_max_s = float(spawn_backoff_max_s)
        # Subtractive retry jitter: several controllers
        # recovering from the same incident (role pools, restarted
        # fleets) must not all retry their spawns at the same instant.
        # Same discipline as CircuitBreaker.jitter_frac — a jittered
        # retry never fires LATER than the deterministic schedule.
        self._spawn_jitter_frac = float(spawn_jitter_frac)
        self._spawn_rng = random.Random(spawn_jitter_seed)
        self._spawn_retry_at = float("-inf")
        self._last_decision = ScaleDecision.HOLD
        self._last_pressure = 0.0
        self._last_load = 0.0
        # (t, {class: cumulative tokens}) ring for the goodput rates.
        self._goodput_ring: Deque[Tuple[float, Dict[str, int]]] = deque()
        if attach:
            router.attach_autoscaler(self)

    # ------------------------------------------------------------- signals
    def pressure(self, now: float) -> float:
        """The overload detector's pressure when admission control is
        armed; 0.0 otherwise (a pressure-blind fleet still scales on
        ``up_load``)."""
        admission = self.router.admission
        if admission is None:
            return 0.0
        return admission.detector.pressure(now)

    def _pool(self):
        """The replicas this controller governs: the whole fleet, or
        — for a role-scoped controller — its role's pool only."""
        slots = self.router.replicas
        if self.role is None:
            return slots
        return [s for s in slots if role_of(s.driver) == self.role]

    def mean_load(self) -> float:
        """Mean assigned requests per AVAILABLE replica of this
        controller's pool (the routable denominator: dead/open-circuit
        replicas serve nothing)."""
        avail = [s for s in self._pool() if s.available]
        if not avail:
            return 0.0
        return sum(s.load for s in avail) / len(avail)

    def _update_goodput(self, now: float) -> None:
        cum = dict(self.router.metrics.tokens_streamed_by_priority)
        self._goodput_ring.append((now, cum))
        cutoff = now - self.goodput_window_s
        while len(self._goodput_ring) > 1 \
                and self._goodput_ring[0][0] < cutoff:
            self._goodput_ring.popleft()

    def goodput_tokens_per_s(self) -> Dict[str, float]:
        """Per-class delivered-token rates over the sliding window —
        the goodput view of the same scaling decision (exported as a
        labeled gauge series; the scale-down guard reasons in load
        units, which track the same signal one derivative earlier)."""
        if len(self._goodput_ring) < 2:
            return {cls: 0.0 for cls in
                    self.router.metrics.tokens_streamed_by_priority}
        (t0, c0), (t1, c1) = self._goodput_ring[0], self._goodput_ring[-1]
        dt = max(t1 - t0, 1e-9)
        return {cls: (c1.get(cls, 0) - c0.get(cls, 0)) / dt for cls in c1}

    # ------------------------------------------------------- control loop
    def step(self, now: Optional[float] = None) -> ScaleDecision:
        """One control tick (the router calls this once per routing
        round). Progresses any pending spawn, then evaluates the
        hysteresis bands and executes at most one action."""
        now = self._clock() if now is None else float(now)
        self._update_goodput(now)
        self._last_pressure = self.pressure(now)
        self._last_load = self.mean_load()
        decision = self._tick(now)
        self.metrics.decision_ticks[decision.value] += 1
        if decision is not self._last_decision:
            self._tracer.on_fleet_event(
                "autoscale",
                transition=(f"{self._last_decision.value}->"
                            f"{decision.value}"),
                replicas=len(self.router.replicas),
                pressure=round(self._last_pressure, 4))
            self._last_decision = decision
        return decision

    def _tick(self, now: float) -> ScaleDecision:
        if self._pending is not None:
            return self._poll_spawn(now)
        if now < self._cooldown_until:
            # Deaf by design: hold anchors also reset, so a storm that
            # persists past the cooldown re-earns its hold from zero.
            self._above_since = self._below_since = None
            return ScaleDecision.COOLDOWN
        n = len(self._pool())
        want_up = self._last_pressure >= self.up_pressure or (
            self.up_load is not None and self._last_load >= self.up_load)
        want_down = (self._last_pressure <= self.down_pressure
                     and self._last_load <= self.down_load)
        if want_up:
            self._below_since = None
            if n >= self.max_replicas:  # _pending is None past the top
                return ScaleDecision.HOLD
            if self._above_since is None:
                self._above_since = now
            if now - self._above_since < self.up_hold_s:
                return ScaleDecision.HOLD
            if now < self._spawn_retry_at:
                return ScaleDecision.HOLD  # backing off a failed spawn
            return self._start_spawn(now)
        if want_down:
            self._above_since = None
            if n <= self.min_replicas:
                return ScaleDecision.HOLD
            if self._below_since is None:
                self._below_since = now
            if now - self._below_since < self.down_hold_s:
                return ScaleDecision.HOLD
            return self._retire_one(now)
        self._above_since = self._below_since = None
        return ScaleDecision.HOLD

    # ------------------------------------------------------------ scale up
    def _start_spawn(self, now: float) -> ScaleDecision:
        if self._id_alloc is not None:
            rid = int(self._id_alloc())
        else:
            rid = self._next_id
            self._next_id += 1
        self.metrics.scale_up_started += 1
        try:
            driver = self._factory(rid)
        except Exception as e:  # noqa: BLE001 - factory failure = attempt
            self._spawn_failed(now, rid, e)    # failed, backoff applies
            return ScaleDecision.HOLD
        self._pending = driver
        self._tracer.on_fleet_event("autoscale_spawn", replica=rid)
        return self._poll_spawn(now, just_started=True)

    def _poll_spawn(self, now: float,
                    just_started: bool = False) -> ScaleDecision:
        driver = self._pending
        poll = getattr(driver, "poll_ready", None)
        try:
            ready = poll() if poll is not None else True
        except ReplicaSpawnTimeout as e:
            self.metrics.spawn_timeouts += 1
            self._spawn_failed(now, driver.replica_id, e)
            return ScaleDecision.HOLD
        except ReplicaDied as e:
            self._spawn_failed(now, driver.replica_id, e)
            return ScaleDecision.HOLD
        if not ready:
            # Warm-start in flight: the fleet serves on, the controller
            # answers SCALE_UP on the starting tick (the transition the
            # trace marks) and HOLD while the compile finishes.
            return (ScaleDecision.SCALE_UP if just_started
                    else ScaleDecision.HOLD)
        self._pending = None
        self.router.scale_up(driver)
        self.metrics.scale_up_completed += 1
        self._spawn_backoff_s = self._spawn_backoff_base_s
        self._spawn_retry_at = float("-inf")
        self._arm_cooldown(now)
        return ScaleDecision.SCALE_UP

    def _spawn_failed(self, now: float, rid: int,
                      cause: BaseException) -> None:
        self.metrics.scale_up_failed += 1
        self._pending = None
        interval = self._spawn_backoff_s
        if self._spawn_jitter_frac > 0.0:
            interval *= 1.0 - self._spawn_jitter_frac \
                * self._spawn_rng.random()
        self._spawn_retry_at = now + interval
        self._spawn_backoff_s = min(self._spawn_backoff_s * 2.0,
                                    self._spawn_backoff_max_s)
        self._above_since = None  # re-earn the hold before retrying
        self._tracer.on_fleet_event(
            "autoscale_spawn_failed", replica=rid,
            error=type(cause).__name__,
            retry_in_s=round(self._spawn_retry_at - now, 3))

    # ---------------------------------------------------------- scale down
    def _retire_one(self, now: float) -> ScaleDecision:
        avail = [s for s in self._pool() if s.available]
        if len(avail) < 2 and self.role is None:
            return ScaleDecision.HOLD  # migration needs a survivor
        if self.role is not None:
            # A role-scoped retirement needs a survivor for the WORK
            # (any available replica elsewhere qualifies — the router
            # checks) but must also never empty its own pool below
            # min_replicas, which the n-bound in _tick already holds;
            # an empty or singleton pool simply has nothing optional
            # to retire when min_replicas >= 1.
            if not avail or len(self.router.replicas) < 2:
                return ScaleDecision.HOLD
        victim = min(avail, key=lambda s: s.load)
        if self.up_load is not None and len(avail) >= 2:
            # Projection guard: survivors must absorb the victim's work
            # without re-crossing the scale-up band — a shrink that
            # causes the next grow is flapping with extra steps.
            projected = sum(s.load for s in avail) / (len(avail) - 1)
            if projected >= self.up_load:
                self.metrics.scale_down_vetoed += 1
                self._below_since = None
                return ScaleDecision.HOLD
        try:
            self.router.scale_down(victim.replica_id)
        except ValueError:
            # No other available replica fleet-wide to absorb the
            # victim's work (possible for a role-scoped controller
            # whose siblings' pools all died): a retirement must never
            # orphan work, so hold and re-earn the band.
            self._below_since = None
            return ScaleDecision.HOLD
        self.metrics.scale_down_completed += 1
        self._arm_cooldown(now)
        return ScaleDecision.SCALE_DOWN

    def _arm_cooldown(self, now: float) -> None:
        self._cooldown_until = now + self.cooldown_s
        self._above_since = self._below_since = None

    def close(self) -> None:
        """Put down an in-flight spawn: a warming worker whose fleet is
        shutting down will never be read by anyone — without this, a
        scale-up racing a teardown leaks a replica-worth of process
        until the parent exits. The router's ``close()`` calls this."""
        driver, self._pending = self._pending, None
        if driver is None:
            return
        kill = getattr(driver, "kill", None)  # SIGKILL beats a close()
        try:                                  # that would wait out a
            (kill if kill is not None else driver.close)()  # shutdown
        except Exception:  # noqa: BLE001 - teardown is best-effort
            pass

    @property
    def pending_spawns(self) -> int:
        """Spawns in flight (0 or 1 — one scale op at a time). A
        spawning worker burns a replica's worth of resources before it
        serves a token, so honest replica-hour accounting (the replay
        harness's ``replica_seconds``) charges for it."""
        return 1 if self._pending is not None else 0

    # ------------------------------------------------------ observability
    def gauges(self) -> Dict[str, object]:
        """Live controller gauges for the exposition: fleet size, spawn
        state, the raw signals, and the per-class goodput rates as a
        labeled series."""
        return {
            "replicas": len(self._pool()),
            "pending_spawns": 1 if self._pending is not None else 0,
            "pressure": self._last_pressure,
            "mean_load_per_replica": self._last_load,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "spawn_backoff_s": self._spawn_backoff_s,
            "cooldown_active": 1 if self._clock() < self._cooldown_until
            else 0,
            "goodput_tokens_per_s": {
                cls: round(rate, 3)
                for cls, rate in self.goodput_tokens_per_s().items()},
        }
