"""Open-loop trace replay with honest backpressure handling.

The port's own copy of :mod:`pddl_tpu.serve.fleet.replay` (host Python,
no JAX): the same names, error texts, literal tables and wire shapes.

The one replay client the fleet benches and tests share, replacing the
per-bench submit loops. Two disciplines the old loops got wrong:

- **Unwind hints are honored.** The fleet's rejections are TYPED and
  carry an honest ``retry_after_s`` (`serve/request.py`: QueueFull's
  queue-drain estimate, AdmissionRejected's brownout-ladder unwind
  horizon). An earlier harness dropped rejected events (or busy-retried on
  a fixed sleep), understating how well the brownout recovers polite
  clients; this client re-enqueues a rejected event at
  ``now + retry_after_s`` — the behavior a well-behaved caller actually
  has — and only counts it shed after ``max_attempts`` unwinds.
- **Resource-hours are metered.** Each poll tick integrates the live
  replica count (plus any spawn in flight — a warming worker burns a
  replica before it serves a token) into ``replica_seconds``, and the
  time the brownout ladder spends above NORMAL into ``rung_seconds``.
  ``goodput_per_replica_hour`` — delivered tokens of FINISHED requests
  per replica-hour — is the one end-to-end production metric the
  autoscale bench (and every future scheduling/caching change) is
  judged on, AlpaServe's per-resource-hour framing made concrete.

The replay runs in REAL time (event ``t`` offsets from the start), so
TTFT includes genuine queue wait; a ``hang_s`` deadline guarantees the
loop reports stragglers instead of spinning on a regression forever.
"""

from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, Tuple

from pddl_tpu_torch.serve.fleet.router import NoHealthyReplica, ReplicaLifecycle
from pddl_tpu_torch.serve.request import Priority, QueueFull


class ReplayReport:
    """One replay's outcome: the fleet handles (paired with their
    events), terminal shed counts per class, retry bookkeeping, and the
    integrated resource/rung meters."""

    def __init__(self):
        self.handles: List[Tuple[Dict[str, object], object]] = []
        self.rejects: Dict[str, int] = {p.value: 0 for p in Priority}
        self.retried_after_hint = 0
        self.hinted_rejects = 0
        self.wall_s = 0.0
        self.replica_seconds = 0.0
        self.rung_seconds = 0.0
        self.all_terminal = True
        self.stragglers = 0

    @property
    def delivered_tokens(self) -> int:
        return sum(len(h.tokens) for _, h in self.handles)

    @property
    def goodput_tokens(self) -> int:
        """Tokens of requests that FINISHED (a timed-out or failed
        stream's partial output is delivered work, not good work)."""
        return sum(len(h.tokens) for _, h in self.handles
                   if h.state.value == "finished")

    @property
    def replica_hours(self) -> float:
        return self.replica_seconds / 3600.0

    @property
    def goodput_per_replica_hour(self) -> float:
        """THE production metric: finished tokens per replica-hour."""
        return self.goodput_tokens / max(self.replica_hours, 1e-12)


def _live_replicas(fleet) -> int:
    n = sum(1 for s in fleet.replicas
            if s.state is ReplicaLifecycle.UP)
    scaler = fleet.autoscaler
    if scaler is not None:
        n += scaler.pending_spawns
    return n


def replay_trace(fleet, schedule, *, honor_hints: bool = True,
                 max_attempts: int = 5, default_retry_s: float = 0.1,
                 hang_s: float = 300.0, idle_sleep_s: float = 0.0005,
                 clock: Callable[[], float] = time.monotonic,
                 on_tick=None) -> ReplayReport:
    """Replay ``schedule`` (tracegen events, ``t``-sorted) through a
    :class:`~.router.FleetRouter` in real time.

    A rejection (``QueueFull`` — ``AdmissionRejected`` included) with
    ``honor_hints`` re-enqueues the event at ``now + retry_after_s``
    (``default_retry_s``, doubled per attempt, when no hint came);
    after ``max_attempts`` submissions the event counts as terminally
    shed in ``rejects``. ``on_tick(now, fleet)`` runs once per poll
    loop — the bench's chaos-injection hook."""
    report = ReplayReport()
    # (due_time, seq, attempt, event): seq breaks ties deterministically.
    pending: List[Tuple[float, int, int, Dict[str, object]]] = []
    for seq, ev in enumerate(schedule):
        heapq.heappush(pending, (float(ev["t"]), seq, 1, ev))
    seq = len(schedule)
    t0 = clock()
    deadline = t0 + hang_s
    last = t0
    while pending or fleet.has_work:
        now_abs = clock()
        if now_abs > deadline:
            break  # stranded work: report it, don't hang
        dt, last = now_abs - last, now_abs
        report.replica_seconds += dt * _live_replicas(fleet)
        if fleet.admission is not None and int(fleet.admission.rung) > 0:
            report.rung_seconds += dt
        now = now_abs - t0
        while pending and pending[0][0] <= now:
            _due, _, attempt, ev = heapq.heappop(pending)
            try:
                h = fleet.submit(ev["prompt"], ev["new_tokens"],
                                 priority=ev["priority"],
                                 deadline_s=ev.get("deadline_s"),
                                 session=ev.get("session"),
                                 adapter=ev.get("adapter"))
                report.handles.append((ev, h))
            except QueueFull as e:  # AdmissionRejected included
                if e.retry_after_s is not None:
                    report.hinted_rejects += 1
                if honor_hints and attempt < max_attempts:
                    hint = (e.retry_after_s
                            if e.retry_after_s is not None
                            else default_retry_s * (2 ** (attempt - 1)))
                    seq += 1
                    heapq.heappush(pending,
                                   (now + float(hint), seq,
                                    attempt + 1, ev))
                    report.retried_after_hint += 1
                else:
                    report.rejects[ev["priority"].value] += 1
            except NoHealthyReplica:
                # A momentary total outage (every breaker open) is the
                # hintless transient a polite client retries too; only
                # this — a genuinely unexpected error (a malformed
                # event, a submit regression) must CRASH the replay,
                # never masquerade as a plausible shed count.
                if honor_hints and attempt < max_attempts:
                    seq += 1
                    heapq.heappush(pending,
                                   (now + default_retry_s
                                    * (2 ** (attempt - 1)), seq,
                                    attempt + 1, ev))
                    report.retried_after_hint += 1
                else:
                    report.rejects[ev["priority"].value] += 1
        if on_tick is not None:
            on_tick(now, fleet)
        if fleet.step() == 0 and idle_sleep_s > 0:
            time.sleep(idle_sleep_s)
    report.wall_s = clock() - t0
    report.stragglers = sum(1 for _, h in report.handles if not h.done)
    report.all_terminal = report.stragglers == 0
    return report
