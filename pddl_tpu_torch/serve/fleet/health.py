"""Replica health: circuit breaker + heartbeat bookkeeping.

The port's own copy of :mod:`pddl_tpu.serve.fleet.health` (host Python,
no JAX): the same names, error texts, literal tables and wire shapes.

A fleet's defining property is that any replica can die at any moment —
and a router that keeps sending traffic at a dying replica converts one
machine's failure into every caller's latency. The standard defense
(Nygard's *Release It!*, the pattern every service mesh ships) is the
CIRCUIT BREAKER, one per replica:

- **CLOSED** — healthy: traffic flows; consecutive failures count up.
- **OPEN** — tripped (``failure_threshold`` consecutive failures, or an
  outright replica death): no traffic, no probes, until a bounded
  exponential backoff expires (``backoff_base_s * 2**n``, capped at
  ``backoff_max_s`` — each failed recovery attempt doubles the wait, so
  a flapping replica cannot make the router spend its time probing).
- **HALF_OPEN** — the backoff expired: exactly one probe is allowed (a
  respawn attempt — fresh engine for an in-process replica, fresh
  worker process for a process replica). Success closes the circuit,
  failure re-opens it with the doubled backoff.

The breaker is pure host-side state with an injectable clock, so every
transition is unit-testable without sleeping. Heartbeats are the
FAILURE DETECTOR feeding it: the shared-FS beat pattern of
:class:`pddl_tpu_torch.parallel.multiworker.HeartbeatMonitor` applied to the
serving tier — a local replica "beats" by completing a step, a process
replica by answering pipe pings — and a beat older than
``heartbeat_timeout_s`` counts as a failure exactly like an explicit
error does.

The breaker answers DEAD-or-alive; Gray Failure (Huang et al.,
HotOS '17) argues the component that actually takes production down is
the one that is neither — alive enough to pass every ping, degraded
enough to drag every request it touches. :class:`GrayDetector` is the
second detector for exactly that differential: a per-replica latency-
quantile drift monitor (recent p95 vs the replica's own established
baseline, a z-score band with a consecutive-strike debounce) whose
SUSPECTED verdict the router acts on PROACTIVELY — hedging interactive
submissions to a healthy sibling and draining the suspect through the
``scale_down`` live-migration path before it hard-fails — instead
of waiting for the breaker's threshold that a gray replica, by
definition, never trips.
"""

from __future__ import annotations

import enum
import random
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-replica circuit breaker (CLOSED → OPEN → HALF_OPEN → ...).

    Args:
      failure_threshold: consecutive failures that trip CLOSED → OPEN.
      backoff_base_s: first OPEN interval; doubles per re-open.
      backoff_max_s: backoff cap (bounded exponential).
      jitter_frac: seeded desynchronization — each OPEN
        interval is scaled by ``1 - jitter_frac * U[0, 1)``, so a
        mass-kill does not schedule every replica's HALF_OPEN probe at
        the same instant (the synchronized respawn herd). Subtractive
        on purpose: a jittered probe never fires LATER than the
        deterministic schedule, so backoff bounds still hold. Default
        0.0 (exact doubling — the unit-testable schedule); the router
        arms it fleet-wide with a per-replica seed.
      seed: PRNG seed for the jitter draws (deterministic per replica).
      on_transition: optional ``fn(old: BreakerState, new: BreakerState)``
        — the router wires this to its metrics/tracer so every
        transition is observable.
    """

    def __init__(self, *, failure_threshold: int = 3,
                 backoff_base_s: float = 0.5, backoff_max_s: float = 30.0,
                 jitter_frac: float = 0.0, seed: Optional[int] = None,
                 on_transition: Optional[Callable] = None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if backoff_base_s <= 0 or backoff_max_s < backoff_base_s:
            raise ValueError(
                f"need 0 < backoff_base_s <= backoff_max_s, got "
                f"{backoff_base_s}/{backoff_max_s}")
        if not 0.0 <= jitter_frac < 1.0:
            raise ValueError(
                f"jitter_frac must be in [0, 1), got {jitter_frac}")
        self.failure_threshold = int(failure_threshold)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter_frac = float(jitter_frac)
        self._rng = random.Random(seed)
        self.on_transition = on_transition
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.open_until_s = 0.0
        self._backoff_s = self.backoff_base_s

    def _to(self, new: BreakerState) -> None:
        if new is self.state:
            return
        old, self.state = self.state, new
        if self.on_transition is not None:
            self.on_transition(old, new)

    # ------------------------------------------------------------ queries
    @property
    def allows_traffic(self) -> bool:
        """Route new requests here? Only a CLOSED circuit takes traffic
        (HALF_OPEN carries exactly the probe, nothing else)."""
        return self.state is BreakerState.CLOSED

    def probe_due(self, now_s: float) -> bool:
        """OPEN and past the backoff: one recovery probe may fire."""
        return self.state is BreakerState.OPEN and now_s >= self.open_until_s

    # ---------------------------------------------------------- recording
    def begin_probe(self, now_s: float) -> None:
        """OPEN → HALF_OPEN: the single allowed probe is in flight."""
        if self.state is not BreakerState.OPEN:
            raise RuntimeError(
                f"begin_probe from {self.state.value} (must be open)")
        self._to(BreakerState.HALF_OPEN)

    def record_success(self, now_s: float) -> None:
        """A successful call (or probe): close the circuit, reset the
        failure count AND the backoff (a recovered replica earns a
        fresh slate — the next incident starts at the base interval)."""
        self.consecutive_failures = 0
        self._backoff_s = self.backoff_base_s
        self._to(BreakerState.CLOSED)

    def record_failure(self, now_s: float) -> None:
        """One failure/timeout. CLOSED trips at the threshold; a
        HALF_OPEN probe failure re-opens immediately with the doubled
        (capped) backoff."""
        self.consecutive_failures += 1
        if self.state is BreakerState.HALF_OPEN:
            self._reopen(now_s)
        elif (self.state is BreakerState.CLOSED
                and self.consecutive_failures >= self.failure_threshold):
            self._reopen(now_s)

    def trip(self, now_s: float) -> None:
        """Unconditional → OPEN (the router saw the replica die; no
        threshold debate needed)."""
        if self.state is not BreakerState.OPEN:
            self._reopen(now_s)

    def _reopen(self, now_s: float) -> None:
        interval = self._backoff_s
        if self.jitter_frac > 0.0:
            interval *= 1.0 - self.jitter_frac * self._rng.random()
        self.open_until_s = now_s + interval
        self._backoff_s = min(self._backoff_s * 2.0, self.backoff_max_s)
        self._to(BreakerState.OPEN)


class GrayDetector:
    """Latency-quantile degradation detector: per-replica per-tick
    wall samples, recent-window p95 judged against the SAME replica's
    own baseline window via a z-score band, with a consecutive-strike
    debounce. Self-relative on purpose — a fleet-relative comparison
    degenerates at N=2 (the slow replica drags the fleet statistic
    with it), while "this replica drifted from what it used to be" is
    the gray-failure differential itself.

    Pure host-side state, no clock: feed it samples, read
    :attr:`suspected`. The router observes each replica's ``step()``
    wall per round — LATENCY faults in a replica's engine (the
    `utils/faults.py` taxonomy) surface there, which is what makes a
    gray replica injectable in tier-1.

    Args:
      window: recent samples whose p95 is judged.
      baseline: older samples forming the replica's own baseline
        (mean/std). Judging starts once a replica has
        ``window + baseline`` samples — before that it is unknown,
        never suspected.
      z_threshold: strikes accrue while
        ``(recent_p95 - baseline_mean) / baseline_std`` exceeds this.
      min_excess_s: absolute drift floor — the band also requires
        ``recent_p95 >= baseline_mean + min_excess_s``, so a replica
        with a near-zero-variance baseline (std ~ 0 makes any wiggle
        an infinite z) is not condemned over microseconds.
      consecutive: strikes in a row before SUSPECTED (debounce), and
        symmetrically the in-band samples in a row that CLEAR it.
        While suspected the baseline is FROZEN — otherwise a
        persistently slow replica would launder its own degradation
        into the sliding baseline and absolve itself; recovery means
        returning to the band of what it USED to be, after which its
        history restarts fresh.
      smooth: median-of-``smooth`` prefilter:
        raw samples collect in groups of ``smooth`` and only each
        group's MEDIAN enters the windows. With a small ``window`` the
        recent p95 is effectively the max, so one real scheduler
        hiccup on a loaded host either falsely suspects a healthy
        replica or inflates a baseline's std enough to never suspect
        a gray one; a median absorbs the isolated spike while a
        genuine slow-wall (every sample slow) passes straight
        through. ``1`` (default) judges every raw sample unchanged.
    """

    def __init__(self, *, window: int = 16, baseline: int = 32,
                 z_threshold: float = 4.0, min_excess_s: float = 0.0,
                 consecutive: int = 3, smooth: int = 1):
        if window < 4 or baseline < 4:
            raise ValueError(
                f"need window >= 4 and baseline >= 4, got "
                f"{window}/{baseline}")
        if consecutive < 1:
            raise ValueError(
                f"consecutive must be >= 1, got {consecutive}")
        if smooth < 1:
            raise ValueError(f"smooth must be >= 1, got {smooth}")
        self.window = int(window)
        self.baseline = int(baseline)
        self.z_threshold = float(z_threshold)
        self.min_excess_s = float(min_excess_s)
        self.consecutive = int(consecutive)
        self.smooth = int(smooth)
        self._pending: Dict[int, List[float]] = {}
        self._samples: Dict[int, Deque[float]] = {}
        self._strikes: Dict[int, int] = {}
        self._recovery: Dict[int, int] = {}
        # rid -> (baseline_mean, baseline_std) frozen at suspicion.
        self._frozen: Dict[int, tuple] = {}
        self.suspected: Set[int] = set()

    def observe(self, replica_id: int, seconds: float) -> None:
        """One per-tick wall sample; re-judges the replica when enough
        history exists."""
        rid = int(replica_id)
        seconds = float(seconds)
        if self.smooth > 1:
            pend = self._pending.setdefault(rid, [])
            pend.append(seconds)
            if len(pend) < self.smooth:
                return
            pend.sort()
            seconds = pend[len(pend) // 2]
            self._pending[rid] = []
        if rid in self.suspected:
            # Frozen baseline: the sample itself must return to the
            # band of what the replica USED to be, `consecutive` times
            # in a row, to clear suspicion — then history restarts.
            mean, std = self._frozen[rid]
            band = mean + max(self.min_excess_s,
                              self.z_threshold * (std + 1e-9))
            if seconds <= band:
                self._recovery[rid] = self._recovery.get(rid, 0) + 1
                if self._recovery[rid] >= self.consecutive:
                    self.forget(rid)
            else:
                self._recovery[rid] = 0
            return
        dq = self._samples.setdefault(
            rid, deque(maxlen=self.window + self.baseline))
        dq.append(seconds)
        if len(dq) < self.window + self.baseline:
            return
        samples = list(dq)
        base = samples[:self.baseline]
        recent = sorted(samples[self.baseline:])
        p95 = recent[min(len(recent) - 1,
                         int(0.95 * (len(recent) - 1) + 0.5))]
        mean = sum(base) / len(base)
        var = sum((x - mean) ** 2 for x in base) / len(base)
        std = var ** 0.5
        z = (p95 - mean) / (std + 1e-9)
        if z > self.z_threshold and p95 >= mean + self.min_excess_s:
            self._strikes[rid] = self._strikes.get(rid, 0) + 1
            if self._strikes[rid] >= self.consecutive:
                self.suspected.add(rid)
                self._frozen[rid] = (mean, std)
                self._recovery[rid] = 0
        else:
            self._strikes[rid] = 0

    def forget(self, replica_id: int) -> None:
        """Drop a replica's history and suspicion (death, retirement,
        respawn, recovery — a fresh process re-earns a fresh
        baseline)."""
        rid = int(replica_id)
        self._pending.pop(rid, None)
        self._samples.pop(rid, None)
        self._strikes.pop(rid, None)
        self._recovery.pop(rid, None)
        self._frozen.pop(rid, None)
        self.suspected.discard(rid)

    def is_suspected(self, replica_id: int) -> bool:
        return int(replica_id) in self.suspected
