"""Seeded deterministic fault injection — the shared core (the port's own
copy of :mod:`pddl_tpu.utils.faults`, the device-fault half).

A :class:`FaultPlan` hooks every guarded device-call boundary of a host
loop (the serving engine's ``_device_call``) and fires transient errors,
allocation failures, latency spikes or hard kill-points at chosen or
randomly drawn ``(step, site)`` coordinates. The rate draws come from one
``np.random.default_rng(seed)`` stream, one draw per :meth:`FaultPlan.check`
call, so the same seed against the same call sequence fires at the same
coordinates as the JAX package's plan does. The site vocabulary belongs
to each subsystem: :class:`pddl_tpu_torch.serve.faults.FaultPlan` pins the
serving engine's.

Fault taxonomy and the caller's contract for each:

- **TRANSIENT** (raises :class:`InjectedTransientError`): retried with
  bounded exponential backoff; past ``max_retries`` the affected device
  state is declared lost and the caller's replay path runs.
- **OOM** (raises :class:`InjectedResourceExhausted`, the stand-in for
  the CUDA caching allocator's ``torch.OutOfMemoryError``): never
  blind-retried — memory must be shed first.
- **LATENCY**: the call is delayed (``sleep_fn``), nothing raises.
- **KILL** (raises :class:`KillPoint`, a ``BaseException``): abrupt
  termination mid-step; nothing catches it.

Injection happens BEFORE the wrapped call runs, so an injected fault
never leaves a tensor half-written, which is what makes a retry sound. A
real error from a call that writes its cache in place escalates straight
to the rebuild path instead (``serve/engine._device_call``).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class FaultKind(enum.Enum):
    TRANSIENT = "transient"  # retryable device error
    OOM = "oom"              # allocation failure: shed/rebuild, don't retry
    LATENCY = "latency"      # slow call, nothing raised
    KILL = "kill"            # hard termination mid-step (BaseException)


class InjectedTransientError(RuntimeError):
    """Stand-in for a retryable device error: the call failed but nothing
    about the caller's resident state is invalidated."""


class InjectedResourceExhausted(RuntimeError):
    """Stand-in for an allocation failure (``torch.OutOfMemoryError``):
    retrying the same call without shedding memory is pointless."""


class KillPoint(BaseException):
    """Simulated hard kill at a (step, site) coordinate. A
    ``BaseException`` so no retry or ``except Exception`` path can swallow
    it: it unwinds through the host loop as a real SIGKILL would end the
    process mid-dispatch."""

    def __init__(self, site: str, step: int):
        self.site = site
        self.step = step
        super().__init__(f"injected kill-point at step {step}, site {site!r}")


def classify(err: BaseException) -> Optional[str]:
    """``"transient"`` / ``"oom"`` / ``None`` (not a device fault: let it
    propagate, a shape error or a bug must stay loud).

    The counterpart of the JAX package's status-string markers, in
    torch's vocabulary. The injected types classify as there; the CUDA
    caching allocator's ``torch.OutOfMemoryError`` is ``"oom"`` — it is
    raised on the host at the allocation, before any kernel of the call
    ran, and the context stays usable once memory is shed. Every other
    exception, every other CUDA error included, is ``None``: after an
    illegal address or a launch failure the CUDA context is unusable, so
    retrying in the same process cannot succeed, and such an error
    surfaces asynchronously (at the next synchronization), not at the
    call that caused it."""
    if isinstance(err, InjectedResourceExhausted):
        return "oom"
    if isinstance(err, InjectedTransientError):
        return "transient"
    if isinstance(err, torch.OutOfMemoryError):
        return "oom"
    return None


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``kind`` on the next ``count``
    invocations of ``site`` during host-loop step ``step``. ``count
    <= max_retries`` of TRANSIENT recovers inside the retry loop, ``count
    > max_retries`` forces the replay path."""

    step: int
    site: str
    kind: FaultKind
    count: int = 1


class FaultPlan:
    """Seeded fault schedule over a host loop's device-call sites.

    Two deterministic layers: ``scheduled`` :class:`FaultSpec`
    coordinates, and per-check Bernoulli rate draws from one
    ``np.random.default_rng(seed)`` stream. Subclasses pin :attr:`SITES`;
    construction validates every site against it.

    Args:
      seed: the PRNG seed.
      transient_rate / oom_rate / latency_rate: per-call probabilities
        (must sum to <= 1).
      latency_s: injected delay per LATENCY fault.
      sites: optional allowlist for the rate-drawn faults (scheduled specs
        are never filtered).
      scheduled: :class:`FaultSpec` sequence.
      max_random_injections: cap on rate-drawn faults; ``None`` =
        unbounded.
      sleep_fn: how LATENCY waits.
    """

    SITES: Tuple[str, ...] = ()

    def __init__(self, seed: int = 0, *, transient_rate: float = 0.0,
                 oom_rate: float = 0.0, latency_rate: float = 0.0,
                 latency_s: float = 0.005,
                 sites: Optional[Sequence[str]] = None,
                 scheduled: Sequence[FaultSpec] = (),
                 max_random_injections: Optional[int] = None,
                 sleep_fn=time.sleep):
        for name, rate in (("transient_rate", transient_rate),
                           ("oom_rate", oom_rate),
                           ("latency_rate", latency_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        if transient_rate + oom_rate + latency_rate > 1.0:
            raise ValueError("fault rates must sum to <= 1")
        if sites is not None:
            unknown = set(sites) - set(self.SITES)
            if unknown:
                raise ValueError(
                    f"unknown fault site(s) {sorted(unknown)}; valid "
                    f"sites are {self.SITES}")
        for spec in scheduled:
            if spec.site not in self.SITES:
                raise ValueError(
                    f"unknown scheduled site {spec.site!r}; valid sites "
                    f"are {self.SITES}")
            if spec.count < 1:
                raise ValueError(f"FaultSpec.count must be >= 1: {spec}")
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._rates = (float(transient_rate), float(oom_rate),
                       float(latency_rate))
        self.latency_s = float(latency_s)
        self._sites = frozenset(sites) if sites is not None else None
        self._sched: Dict[Tuple[int, str], List[FaultKind]] = {}
        for spec in scheduled:
            self._sched.setdefault((spec.step, spec.site), []).extend(
                [spec.kind] * spec.count)
        self._max_random = max_random_injections
        self._random_fired = 0
        self._sleep = sleep_fn
        self.step_idx = -1  # the host loop stamps this at the top of a step
        self.injected: Dict[FaultKind, int] = {k: 0 for k in FaultKind}
        # Injection observer ``fn(step, site, kind_value)``: every
        # injection, LATENCY included (which raises nothing), with the
        # exact (step, site) coordinate it fired at.
        self.on_inject = None

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def on_step(self, step_idx: int) -> None:
        """Host-loop hook: the current step coordinate for scheduled specs
        (retries within a step re-check the same coordinate, which is how
        ``FaultSpec.count`` consumes consecutive invocations)."""
        self.step_idx = int(step_idx)

    def check(self, site: str) -> None:
        """Called by the host loop immediately before dispatching
        ``site``. Raises / sleeps per the schedule; returns normally
        otherwise."""
        key = (self.step_idx, site)
        pending = self._sched.get(key)
        if pending:
            kind = pending.pop(0)
            if not pending:
                del self._sched[key]
            self._fire(kind, site)
            return
        t, o, lat = self._rates
        if t + o + lat <= 0.0:
            return
        if self._sites is not None and site not in self._sites:
            return
        if (self._max_random is not None
                and self._random_fired >= self._max_random):
            return
        u = self._rng.random()
        if u < t:
            kind = FaultKind.TRANSIENT
        elif u < t + o:
            kind = FaultKind.OOM
        elif u < t + o + lat:
            kind = FaultKind.LATENCY
        else:
            return
        self._random_fired += 1
        self._fire(kind, site)

    def _fire(self, kind: FaultKind, site: str) -> None:
        self.injected[kind] += 1
        if self.on_inject is not None:
            self.on_inject(self.step_idx, site, kind.value)
        where = f"at step {self.step_idx}, site {site!r}"
        if kind is FaultKind.TRANSIENT:
            raise InjectedTransientError(
                f"injected transient device error {where}")
        if kind is FaultKind.OOM:
            raise InjectedResourceExhausted(
                f"injected allocation failure {where}")
        if kind is FaultKind.KILL:
            raise KillPoint(site, self.step_idx)
        self._sleep(self.latency_s)  # LATENCY: slow, not broken
