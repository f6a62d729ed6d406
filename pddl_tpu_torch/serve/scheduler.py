"""Admission control for the serving engine: SLO-aware pop order (the
port's own copy of :mod:`pddl_tpu.serve.scheduler`).

- **max_queue_depth** sheds load: a full queue rejects at ``submit()``
  with a typed :class:`~pddl_tpu_torch.serve.request.QueueFull`.
- **prefill_token_budget** bounds each tick's admission burst by the
  admitted prompts' combined (``cost_fn``-priced) length; at least one
  request is always admitted when a slot is free.
- Pop order: priority class first (``interactive`` > ``batch`` >
  ``best_effort``), earliest deadline first within a class, FIFO among
  equals; a queued request's effective class rises one rank per
  ``aging_s`` waited (the anti-starvation bound). Cancelled queued
  handles are dropped at pop time, expired ones shed before they cost a
  prefill.
- Replayed handles bypass the ordering entirely (a separate front lane:
  they were admitted once already and are owed the next free slots
  regardless of class); a preempted one re-enters the normal queue.
- A drain pops everything queued (the bypass lane first, then submit
  order); a restore puts the snapshot's handles in the bypass lane, in
  its order, with no depth limit.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque, List, Optional, Tuple

from pddl_tpu_torch.serve.request import (
    FinishReason,
    Priority,
    QueueFull,
    RequestHandle,
    RequestState,
)


class SLOScheduler:
    """Priority + EDF + aging admission with load shedding and a per-tick
    prefill budget.

    Args:
      max_queue_depth: queue cap; beyond it ``submit()`` raises
        :class:`~pddl_tpu_torch.serve.request.QueueFull`.
      prefill_token_budget: per-``admit()`` cap on the admitted prompts'
        combined (cost_fn-priced) length.
      aging_s: seconds of queue wait per effective-rank promotion;
        ``None`` disables aging (pure priority + EDF, which can starve).
    """

    def __init__(self, *, max_queue_depth: int = 64,
                 prefill_token_budget: Optional[int] = None,
                 aging_s: Optional[float] = 30.0):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        if prefill_token_budget is not None and prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget must be >= 1, got "
                f"{prefill_token_budget}")
        if aging_s is not None and aging_s <= 0:
            raise ValueError(f"aging_s must be > 0 or None, got {aging_s}")
        self.max_queue_depth = max_queue_depth
        self.prefill_token_budget = prefill_token_budget
        self.aging_s = float(aging_s) if aging_s is not None else None
        # (seq, handle): seq is the FIFO tie-break inside an equal
        # (effective rank, deadline) key.
        self._queue: List[Tuple[int, RequestHandle]] = []
        self._seq = 0
        # The bypass lane for replayed handles: popped before any key is
        # computed (they were admitted once already).
        self._front: Deque[RequestHandle] = deque()

    @property
    def depth(self) -> int:
        return len(self._queue) + len(self._front)

    def depth_at_or_above(self, priority: Priority) -> int:
        """Queued handles an arrival of ``priority`` would wait behind:
        everything at its own or a more urgent class (the bypass lane
        outranks every class)."""
        rank = priority.rank
        return len(self._front) + sum(
            1 for _, h in self._queue if h.request.priority.rank <= rank)

    def submit(self, handle: RequestHandle) -> None:
        """Enqueue, or shed load with a typed rejection."""
        if self.depth >= self.max_queue_depth:
            raise QueueFull(self.depth, self.max_queue_depth,
                            priority=handle.request.priority)
        self._queue.append((self._seq, handle))
        self._seq += 1

    def _key(self, seq: int, handle: RequestHandle,
             now: Optional[float]) -> Tuple[int, float, int]:
        """(effective rank, absolute deadline, seq) — ascending pop. A
        deadline-less request sorts on a synthetic horizon of
        ``4*aging_s`` past its arrival (``inf`` with aging off)."""
        req = handle.request
        rank = req.priority.rank
        if self.aging_s is not None and now is not None:
            rank = max(0, rank - int((now - handle.arrival_s)
                                     / self.aging_s))
        if req.deadline_s is not None:
            deadline = handle.arrival_s + req.deadline_s
        elif self.aging_s is not None:
            deadline = handle.arrival_s + 4.0 * self.aging_s
        else:
            deadline = math.inf
        return rank, deadline, seq

    def _peek_best(self, now: Optional[float]) -> Tuple[int, RequestHandle]:
        """Index (into the main queue; -1 = the front lane) and handle of
        the next pop, WITHOUT removing it — an over-budget head must stay
        exactly where it is."""
        if self._front:
            return -1, self._front[0]
        best_i = 0
        best_key = self._key(*self._queue[0], now)
        for i in range(1, len(self._queue)):
            key = self._key(*self._queue[i], now)
            if key < best_key:
                best_i, best_key = i, key
        return best_i, self._queue[best_i][1]

    def _pop_at(self, index: int) -> RequestHandle:
        if index < 0:
            return self._front.popleft()
        return self._queue.pop(index)[1]

    def admit(self, free_slots: int, on_cancelled=None, on_expired=None,
              now_fn=None, cost_fn=None) -> List[RequestHandle]:
        """Pop up to ``free_slots`` admissible handles in SLO order,
        bounded by the prefill token budget. Cancelled queued handles are
        dropped (CANCELLED, ``on_cancelled`` called); with ``now_fn``, a
        handle whose deadline already expired is shed (TIMED_OUT /
        DEADLINE, ``on_expired`` called) before it costs anything.
        ``cost_fn(handle)`` prices a request against the budget (default:
        its prompt length; the prefix-cache engine charges the uncached
        suffix)."""
        admitted: List[RequestHandle] = []
        budget = self.prefill_token_budget
        spent = 0
        now = now_fn() if now_fn is not None else None
        while self.depth and len(admitted) < free_slots:
            idx, head = self._peek_best(now)
            if head.cancelled:
                self._pop_at(idx)
                head.state = RequestState.CANCELLED
                head.finish_reason = FinishReason.CANCELLED
                if on_cancelled is not None:
                    on_cancelled(head)
                continue
            if (now is not None and head.request.deadline_s is not None
                    and now - head.arrival_s > head.request.deadline_s):
                self._pop_at(idx)
                head.state = RequestState.TIMED_OUT
                head.finish_reason = FinishReason.DEADLINE
                if on_expired is not None:
                    on_expired(head)
                continue
            cost = (cost_fn(head) if cost_fn is not None
                    else len(head.request.prompt))
            if budget is not None and admitted and spent + cost > budget:
                break  # leave the head in place: next tick re-ranks it
            self._pop_at(idx)
            head.state = RequestState.RUNNING
            admitted.append(head)
            spent += cost
        return admitted

    def queued_of_class(self, priority: Priority) -> int:
        """Main-queue handles whose ACTUAL class is ``priority`` (the
        bypass lane and aging promotions excluded): the engine's
        preemption trigger, so a replayed best_effort handle in the bypass
        lane cannot preempt its own class."""
        return sum(1 for _, h in self._queue
                   if h.request.priority is priority)

    def requeue(self, handle: RequestHandle) -> None:
        """Re-enter a PREEMPTED running handle through the NORMAL queue
        (not the bypass lane: it must not outrank the interactive work it
        was parked for). Depth limits do not apply: it was admitted once."""
        handle.state = RequestState.QUEUED
        self._queue.append((self._seq, handle))
        self._seq += 1

    def requeue_front(self, handles: List[RequestHandle]) -> None:
        """Put replayed handles back in the bypass lane in the given order,
        ahead of every class. Bypasses ``max_queue_depth``: these requests
        were accepted once, and shedding them now would turn a device
        fault into a visible rejection."""
        for handle in reversed(handles):
            handle.state = RequestState.QUEUED
            self._front.appendleft(handle)

    def drain(self) -> List[RequestHandle]:
        """Pop every queued handle for a drain snapshot: the bypass lane
        first, then submit order. The queue is left empty, so a step after
        the drain admits nothing."""
        out = list(self._front)
        out.extend(h for _, h in self._queue)
        self._front.clear()
        self._queue.clear()
        return out

    def restore(self, handles: List[RequestHandle]) -> None:
        """Re-enqueue restored handles in snapshot order ahead of any new
        traffic (the bypass lane). Depth limits do not apply: the drained
        engine admitted every one of them."""
        self._front.extend(handles)


# The JAX package's other name for it: the SLO scheduler with every
# request at the default class and no deadlines is FCFS.
FCFSScheduler = SLOScheduler
