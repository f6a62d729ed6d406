"""Fleet admission control: rate limits, overload detection, brownout.

The port's own copy of :mod:`pddl_tpu.serve.fleet.admission` (host
Python, no JAX): the same names, error texts, literal tables and wire
shapes.

The router's failover machinery makes the fleet robust to
FAULTS; this module makes it robust to OVERLOAD — the difference
between "a replica died" and "everyone showed up at once". Three
pieces, composed by :meth:`FleetRouter.submit`:

- :class:`TokenBucket` — per-priority rate limits at the front door.
  A class that exceeds its configured requests/s is rejected BEFORE
  any engine queue is consulted, with an honest ``retry_after_s`` (the
  bucket's own refill time), so a misbehaving batch client cannot
  starve interactive traffic of queue slots.
- :class:`OverloadDetector` — a sliding-window pressure score fed by
  the signals the fleet already emits: engine ``QueueFull``s (the
  reroutes they force and the fleet-wide rejections they end in) and
  replicas reporting DEGRADED (the OOM machinery — memory pressure
  IS overload pressure, which is how the brownout ladder composes
  with degraded mode). Pressure is the rejected/shed fraction of
  recent submits, boosted while any replica is degraded.
- :class:`BrownoutController` — the ladder. Sustained pressure above
  the high-water mark climbs one rung at a time; recovery is
  HYSTERETIC: pressure must hold below the low-water mark for
  ``recover_hold_s`` before stepping DOWN one rung (never straight to
  NORMAL), so a flapping load pattern cannot oscillate the fleet.

  The rungs shed the RIGHT work, cheapest first:

  1. ``SHED_BEST_EFFORT`` — reject ``best_effort`` submissions with a
     hint covering the whole remaining ladder unwind (they re-enter
     last).
  2. ``CAP_OUTPUT`` — additionally clamp every admitted request's
     ``max_new_tokens`` to ``output_cap``: shorter streams drain the
     queue faster without rejecting anyone.
  3. ``REJECT_COLD`` — additionally reject COLD prompts (no prefix
     affinity, no sticky session): a cold prompt costs a full prefill,
     the most expensive admission the fleet can buy under overload,
     while warm traffic rides the caches it already paid for.

Every decision returns an honest ``retry_after_s``: a rejected class
is told how long the ladder needs to unwind to re-admit it, scaled by
how many rungs stand between it and service — which is what makes a
``best_effort`` hint under brownout LONGER than an ``interactive``
one, and keeps polite clients from hammering a browned-out fleet.
"""

from __future__ import annotations

import enum
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from pddl_tpu_torch.serve.request import Priority


class TokenBucket:
    """Classic token bucket: ``rate_per_s`` tokens/s up to ``burst``.

    ``None`` rate means unlimited (the default for ``interactive``).
    Refill is lazy (computed at ``take()``), so an idle bucket costs
    nothing and a fake clock drives it deterministically in tests."""

    def __init__(self, rate_per_s: Optional[float], burst: float):
        if rate_per_s is not None and rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0 or None, got "
                             f"{rate_per_s}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate_per_s = rate_per_s
        self.burst = float(burst)
        self._tokens = float(burst)
        self._stamp: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._stamp is not None and self.rate_per_s is not None:
            self._tokens = min(
                self.burst,
                self._tokens + (now - self._stamp) * self.rate_per_s)
        self._stamp = now

    def take(self, now: float) -> bool:
        """Consume one token if available."""
        if self.rate_per_s is None:
            return True
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def time_until_token(self, now: float) -> float:
        """Seconds until one token exists — the honest retry hint for
        a rate-limit rejection. 0 when a token is already there."""
        if self.rate_per_s is None:
            return 0.0
        self._refill(now)
        if self._tokens >= 1.0:
            return 0.0
        return (1.0 - self._tokens) / self.rate_per_s


class OverloadDetector:
    """Sliding-window pressure over recent submit outcomes.

    ``observe(now, rejected=...)`` records one routing outcome
    (rejected covers engine QueueFulls that forced a reroute AND
    fleet-wide sheds); ``pressure(now)`` is the rejected fraction of
    the window, raised to at least ``degraded_floor`` while any
    replica reports DEGRADED (``set_degraded``) — the OOM state is
    an overload signal even when the queues look calm, because the
    cold path serves slower than the caches the fleet is sized for."""

    def __init__(self, *, window_s: float = 2.0, min_samples: int = 8,
                 degraded_floor: float = 0.5):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self.min_samples = int(min_samples)
        self.degraded_floor = float(degraded_floor)
        self._events: Deque[Tuple[float, bool]] = deque()
        self._degraded_replicas = 0

    def set_degraded(self, n_replicas: int) -> None:
        self._degraded_replicas = int(n_replicas)

    def observe(self, now: float, *, rejected: bool) -> None:
        self._events.append((now, bool(rejected)))
        self._trim(now)

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def pressure(self, now: float) -> float:
        """Rejected/shed fraction of the window in [0, 1]; 0 before
        ``min_samples`` outcomes exist (a cold fleet is not
        overloaded, however its first submit went)."""
        self._trim(now)
        p = 0.0
        if len(self._events) >= self.min_samples:
            p = sum(r for _, r in self._events) / len(self._events)
        if self._degraded_replicas > 0:
            p = max(p, self.degraded_floor)
        return p


class BrownoutRung(enum.IntEnum):
    """The ladder, ordered: each rung includes every rung below it."""

    NORMAL = 0
    SHED_BEST_EFFORT = 1
    CAP_OUTPUT = 2
    REJECT_COLD = 3


class BrownoutController:
    """Hysteretic ladder over the detector's pressure signal.

    Escalation: pressure >= ``high`` continuously for
    ``escalate_hold_s`` climbs ONE rung (and re-arms the hold, so a
    storm walks the ladder a rung at a time, not to the top in one
    step). Recovery: pressure <= ``low`` continuously for
    ``recover_hold_s`` steps DOWN one rung. The gap between ``high``
    and ``low`` plus the holds is the hysteresis — a load level
    hovering at the threshold cannot flap the fleet between states.

    ``update(now, pressure)`` returns the (possibly new) rung;
    ``decide(...)`` answers one admission question."""

    def __init__(self, *, high: float = 0.3, low: float = 0.1,
                 escalate_hold_s: float = 0.5,
                 recover_hold_s: float = 3.0,
                 output_cap: int = 32,
                 on_transition=None):
        if not 0.0 <= low < high <= 1.0:
            raise ValueError(
                f"need 0 <= low < high <= 1, got low={low} high={high}")
        if output_cap < 1:
            raise ValueError(f"output_cap must be >= 1, got {output_cap}")
        self.high = float(high)
        self.low = float(low)
        self.escalate_hold_s = float(escalate_hold_s)
        self.recover_hold_s = float(recover_hold_s)
        self.output_cap = int(output_cap)
        self.on_transition = on_transition
        self.rung = BrownoutRung.NORMAL
        self.escalations = 0
        self.deescalations = 0
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None

    def _move(self, new: BrownoutRung) -> None:
        old, self.rung = self.rung, new
        if new > old:
            self.escalations += 1
        else:
            self.deescalations += 1
        if self.on_transition is not None:
            self.on_transition(old, new)

    def update(self, now: float, pressure: float) -> BrownoutRung:
        if pressure >= self.high:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if (now - self._above_since >= self.escalate_hold_s
                    and self.rung < BrownoutRung.REJECT_COLD):
                self._move(BrownoutRung(self.rung + 1))
                self._above_since = now  # one rung per hold, not a jump
        elif pressure <= self.low:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if (now - self._below_since >= self.recover_hold_s
                    and self.rung > BrownoutRung.NORMAL):
                self._move(BrownoutRung(self.rung - 1))
                self._below_since = now  # hysteresis: one rung per hold
        else:
            # The dead band: neither escalate nor recover accumulates.
            self._above_since = None
            self._below_since = None
        return self.rung

    # ------------------------------------------------------- decisions
    def recovery_hint_s(self, rungs_to_unwind: int) -> float:
        """Honest retry hint: each rung needs at least
        ``recover_hold_s`` of calm before it unwinds, so a class
        blocked behind N rungs waits at least N holds."""
        return max(1, rungs_to_unwind) * self.recover_hold_s

    def decide(self, priority: Priority, *,
               cold: bool) -> Tuple[bool, Optional[str], float]:
        """(admit, reject_reason, retry_after_s) for one submission.
        ``cold`` = no prefix affinity and no sticky session — the
        full-prefill admission the top rung refuses to buy."""
        if (self.rung >= BrownoutRung.SHED_BEST_EFFORT
                and priority is Priority.BEST_EFFORT):
            # best_effort re-enters only at NORMAL: the whole ladder
            # must unwind, hence the longest hint of any rejection.
            return False, "brownout_shed", self.recovery_hint_s(
                int(self.rung))
        if self.rung >= BrownoutRung.REJECT_COLD and cold:
            # Cold prompts re-enter one rung down.
            return False, "brownout_cold", self.recovery_hint_s(
                int(self.rung) - int(BrownoutRung.CAP_OUTPUT))
        return True, None, 0.0

    def cap_new_tokens(self, max_new_tokens: int) -> int:
        if self.rung >= BrownoutRung.CAP_OUTPUT:
            return min(int(max_new_tokens), self.output_cap)
        return int(max_new_tokens)


class AdmissionControl:
    """The composed front door the router consults per submit.

    Args:
      rates: ``{Priority: requests/s}`` token-bucket rates (``None`` or
        a missing class = unlimited); ``burst`` scales each bucket's
        burst allowance.
      detector / brownout: constructed from ``detector_kw`` /
        ``brownout_kw`` overrides.
    """

    def __init__(self, *, rates: Optional[Dict[Priority, float]] = None,
                 burst: float = 8.0,
                 detector_kw: Optional[Dict[str, object]] = None,
                 brownout_kw: Optional[Dict[str, object]] = None,
                 on_transition=None):
        rates = rates or {}
        self.buckets: Dict[Priority, TokenBucket] = {
            p: TokenBucket(rates.get(p), burst) for p in Priority}
        self.detector = OverloadDetector(**(detector_kw or {}))
        self.brownout = BrownoutController(
            on_transition=on_transition, **(brownout_kw or {}))

    @property
    def rung(self) -> BrownoutRung:
        return self.brownout.rung

    def update(self, now: float, degraded_replicas: int = 0) -> BrownoutRung:
        """Periodic re-evaluation (the router calls this once per
        routing round): feed the degraded gauge, advance the ladder on
        current pressure."""
        self.detector.set_degraded(degraded_replicas)
        return self.brownout.update(now, self.detector.pressure(now))

    def admit(self, now: float, priority: Priority, *,
              cold: bool) -> Tuple[bool, Optional[str], float]:
        """(admit, reject_reason, retry_after_s). Order matters: the
        rate limit is per-class and independent of load; the brownout
        rungs apply after it."""
        bucket = self.buckets[priority]
        if not bucket.take(now):
            hint = bucket.time_until_token(now)
            if self.brownout.rung > BrownoutRung.NORMAL:
                hint = max(hint, self.brownout.recovery_hint_s(1))
            return False, "rate_limit", hint
        return self.brownout.decide(priority, cold=cold)

    def observe(self, now: float, *, rejected: bool) -> None:
        """One routing outcome (engine-level shed/reject or success)
        into the detector."""
        self.detector.observe(now, rejected=rejected)
