"""Admission control for the serving engine: SLO-aware pop order (the
port's own copy of :mod:`pddl_tpu.serve.scheduler`, without the
preemption and drain/restore lanes, which the port's engine does not
have yet).

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
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

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

    @property
    def depth(self) -> int:
        return len(self._queue)

    def depth_at_or_above(self, priority: Priority) -> int:
        """Queued handles an arrival of ``priority`` would wait behind:
        everything at its own or a more urgent class."""
        rank = priority.rank
        return sum(1 for _, h in self._queue
                   if h.request.priority.rank <= rank)

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

    def _peek_best(self, now: Optional[float]) -> int:
        """Index of the next pop, WITHOUT removing it — an over-budget
        head must stay exactly where it is."""
        best_i = 0
        best_key = self._key(*self._queue[0], now)
        for i in range(1, len(self._queue)):
            key = self._key(*self._queue[i], now)
            if key < best_key:
                best_i, best_key = i, key
        return best_i

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
        while self._queue and len(admitted) < free_slots:
            idx = self._peek_best(now)
            head = self._queue[idx][1]
            if head.cancelled:
                self._queue.pop(idx)
                head.state = RequestState.CANCELLED
                head.finish_reason = FinishReason.CANCELLED
                if on_cancelled is not None:
                    on_cancelled(head)
                continue
            if (now is not None and head.request.deadline_s is not None
                    and now - head.arrival_s > head.request.deadline_s):
                self._queue.pop(idx)
                head.state = RequestState.TIMED_OUT
                head.finish_reason = FinishReason.DEADLINE
                if on_expired is not None:
                    on_expired(head)
                continue
            cost = (cost_fn(head) if cost_fn is not None
                    else len(head.request.prompt))
            if budget is not None and admitted and spent + cost > budget:
                break  # leave the head in place: next tick re-ranks it
            self._queue.pop(idx)
            head.state = RequestState.RUNNING
            admitted.append(head)
            spent += cost
        return admitted
