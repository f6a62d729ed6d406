"""Seeded deterministic fault injection — the shared core (the port's own
copy of :mod:`pddl_tpu.utils.faults`: the device faults, and the storage
faults the fleet router's journal injects through its file-operation
shim).

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
import errno
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


class StorageFaultKind(enum.Enum):
    EIO = "eio"          # transient-or-persistent I/O error (``errno.EIO``)
    ENOSPC = "enospc"    # disk full (``errno.ENOSPC``): reclaim, don't retry
    TORN = "torn"        # write persists a prefix, then fails (power-cut model)
    SLOW = "slow"        # slow fsync/write — the gray disk; nothing raised


@dataclasses.dataclass(frozen=True)
class StorageFaultSpec:
    """One scheduled storage fault: fire ``kind`` on the next ``count``
    invocations of file operation ``op``, starting at the ``seq``-th
    call of that op (a per-op invocation counter, 0-based — the storage
    analog of :class:`FaultSpec`'s ``(step, site)`` coordinate, because
    a journal has no step clock of its own)."""

    op: str
    seq: int
    kind: StorageFaultKind
    count: int = 1


class StorageFaultPlan:
    """Seeded fault schedule over a journal's file-operation sites.

    The storage sibling of :class:`FaultPlan`: same two deterministic
    layers (explicit :class:`StorageFaultSpec` coordinates + per-call
    Bernoulli rate draws from one seeded stream), but coordinates are
    ``(op, seq)`` — the op name and its per-op invocation index —
    because file ops have no host-loop step to hang a schedule on.

    The consumer is a VFS shim (``journal._JournalVFS``) that calls
    :meth:`check` immediately BEFORE each real ``os`` call:

    - **EIO** raises ``OSError(errno.EIO)`` before the op runs — the
      retryable class; persistent storms drive the journal into its
      NON_DURABLE degraded mode.
    - **ENOSPC** raises ``OSError(errno.ENOSPC)`` — not retried; the
      journal's contract is to reclaim space (emergency checkpoint +
      rotate) before writing again.
    - **TORN** is *returned* to the shim rather than raised: only the
      write path can model it (persist a prefix of the buffer, then
      raise EIO), which is exactly the torn-tail shape
      ``_readable_prefix_len`` truncates at recovery.
    - **SLOW** sleeps ``slow_s`` and returns — the gray disk; fsync
      deadlines and tick cadence must survive it.

    :meth:`quiesce` clears rates and pending schedule in place — how a
    test "repairs the disk" so re-arm probes can restore durability.
    """

    SITES: Tuple[str, ...] = ("open", "write", "fsync", "replace", "fstat")

    def __init__(self, seed: int = 0, *, eio_rate: float = 0.0,
                 enospc_rate: float = 0.0, torn_rate: float = 0.0,
                 slow_rate: float = 0.0, slow_s: float = 0.005,
                 ops: Optional[Sequence[str]] = None,
                 scheduled: Sequence[StorageFaultSpec] = (),
                 max_random_injections: Optional[int] = None,
                 sleep_fn=time.sleep):
        for name, rate in (("eio_rate", eio_rate),
                           ("enospc_rate", enospc_rate),
                           ("torn_rate", torn_rate),
                           ("slow_rate", slow_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        if eio_rate + enospc_rate + torn_rate + slow_rate > 1.0:
            raise ValueError("storage fault rates must sum to <= 1")
        if ops is not None:
            unknown = set(ops) - set(self.SITES)
            if unknown:
                raise ValueError(
                    f"unknown storage op(s) {sorted(unknown)}; valid ops "
                    f"are {self.SITES}")
        for spec in scheduled:
            if spec.op not in self.SITES:
                raise ValueError(
                    f"unknown scheduled op {spec.op!r}; valid ops are "
                    f"{self.SITES}")
            if spec.seq < 0:
                raise ValueError(f"StorageFaultSpec.seq must be >= 0: {spec}")
            if spec.count < 1:
                raise ValueError(
                    f"StorageFaultSpec.count must be >= 1: {spec}")
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._rates = (float(eio_rate), float(enospc_rate),
                       float(torn_rate), float(slow_rate))
        self.slow_s = float(slow_s)
        self._ops = frozenset(ops) if ops is not None else None
        self._sched: Dict[Tuple[str, int], List[StorageFaultKind]] = {}
        for spec in scheduled:
            for i in range(spec.count):
                self._sched.setdefault((spec.op, spec.seq + i), []).append(
                    spec.kind)
        self._max_random = max_random_injections
        self._random_fired = 0
        self._sleep = sleep_fn
        # Per-op invocation counters: the ``seq`` axis of the schedule.
        self.calls: Dict[str, int] = {op: 0 for op in self.SITES}
        self.injected: Dict[StorageFaultKind, int] = {
            k: 0 for k in StorageFaultKind}
        # Observer ``fn(seq, op, kind_value)``, mirroring FaultPlan's
        # ``on_inject`` so injections land in traces with coordinates.
        self.on_inject = None

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def quiesce(self) -> None:
        """Repair the disk: clear rates and any pending schedule so
        every later :meth:`check` passes (re-arm probes succeed)."""
        self._rates = (0.0, 0.0, 0.0, 0.0)
        self._sched.clear()

    def check(self, op: str) -> Optional[StorageFaultKind]:
        """Called by the VFS shim immediately before the real ``os``
        op. Raises ``OSError`` (EIO/ENOSPC), sleeps (SLOW), or returns
        :data:`StorageFaultKind.TORN` for the shim to half-write;
        returns ``None`` when the op should proceed untouched."""
        if op not in self.calls:
            raise ValueError(
                f"unknown storage op {op!r}; valid ops are {self.SITES}")
        seq = self.calls[op]
        self.calls[op] = seq + 1
        pending = self._sched.get((op, seq))
        if pending:
            kind = pending.pop(0)
            if not pending:
                del self._sched[(op, seq)]
            return self._fire(kind, op, seq)
        e, n, t, s = self._rates
        if e + n + t + s <= 0.0:
            return None
        if self._ops is not None and op not in self._ops:
            return None
        if (self._max_random is not None
                and self._random_fired >= self._max_random):
            return None
        u = self._rng.random()
        if u < e:
            kind = StorageFaultKind.EIO
        elif u < e + n:
            kind = StorageFaultKind.ENOSPC
        elif u < e + n + t:
            kind = StorageFaultKind.TORN
        elif u < e + n + t + s:
            kind = StorageFaultKind.SLOW
        else:
            return None
        self._random_fired += 1
        return self._fire(kind, op, seq)

    def _fire(self, kind: StorageFaultKind, op: str,
              seq: int) -> Optional[StorageFaultKind]:
        self.injected[kind] += 1
        if self.on_inject is not None:
            self.on_inject(seq, op, kind.value)
        where = f"at op {op!r} seq {seq}"
        if kind is StorageFaultKind.EIO:
            raise OSError(errno.EIO, f"injected I/O error {where}")
        if kind is StorageFaultKind.ENOSPC:
            raise OSError(errno.ENOSPC,
                          f"injected no-space-on-device {where}")
        if kind is StorageFaultKind.TORN:
            return kind  # the write path half-writes, then raises EIO
        self._sleep(self.slow_s)  # SLOW: gray disk, not a broken one
        return None
