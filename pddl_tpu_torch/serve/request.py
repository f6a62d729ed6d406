"""Request lifecycle for the online serving engine (the port's own copy
of :mod:`pddl_tpu.serve.request`).

The engine is single-threaded and caller-driven (``engine.step()``), so
handles need no locking — cancellation is a flag the engine honors at its
next tick. Sampling parameters are PER-REQUEST runtime values batched
into ``[slots]`` arrays each tick, hence the array sentinels on
:class:`SamplingParams`. The multi-tenant request fields (adapter,
constraint) and the replay/preemption/speculation bookkeeping belong to
engine features not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional, Sequence


class Priority(enum.Enum):
    """SLO class of a request — the scheduler's pop order keys off it."""

    INTERACTIVE = "interactive"
    BATCH = "batch"
    BEST_EFFORT = "best_effort"

    @property
    def rank(self) -> int:
        """0 = most urgent. The scheduler sorts ascending on this."""
        return _PRIORITY_RANK[self]


_PRIORITY_RANK = {Priority.INTERACTIVE: 0, Priority.BATCH: 1,
                  Priority.BEST_EFFORT: 2}


class QueueFull(RuntimeError):
    """Typed admission-control rejection: the engine's queue is at its
    ``max_queue_depth``. Carries the depth and, once the engine has seen
    two admissions, a priority-aware ``retry_after_s`` hint."""

    def __init__(self, queue_depth: int, max_queue_depth: int,
                 retry_after_s: Optional[float] = None,
                 priority: Optional[Priority] = None):
        self.queue_depth = queue_depth
        self.max_queue_depth = max_queue_depth
        self.retry_after_s = retry_after_s
        self.priority = priority
        hint = (f"; retry after ~{retry_after_s:.3f}s"
                if retry_after_s is not None else "")
        super().__init__(
            f"serving queue full ({queue_depth}/{max_queue_depth}); "
            f"shed load upstream or raise max_queue_depth{hint}")


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"


class FinishReason(enum.Enum):
    LENGTH = "length"        # emitted max_new_tokens
    EOS = "eos"              # hit the engine's eos token (included)
    GRAMMAR = "grammar"      # a constrained stream completed its grammar
    CANCELLED = "cancelled"  # handle.cancel()
    TIMED_OUT = "timed_out"  # deadline_s exceeded while running
    DEADLINE = "deadline"    # deadline already expired at pop time
    ERROR = "error"          # device faults outlasted the replay budget


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration. ``temperature <= 0`` is
    greedy; ``top_k``/``top_p`` then must be unset."""

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None

    def __post_init__(self):
        if self.top_k is not None and int(self.top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0.0 < float(self.top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature <= 0 and (self.top_k is not None
                                      or self.top_p is not None):
            raise ValueError(
                "top_k/top_p require temperature > 0 (greedy decoding "
                "would silently ignore them)")

    def as_arrays(self) -> tuple:
        """Array-side sentinels (see ``gpt.batched_filtered_logits``)."""
        return (float(self.temperature),
                int(self.top_k) if self.top_k is not None else 0,
                float(self.top_p) if self.top_p is not None else 2.0)


_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One generate request as the scheduler sees it."""

    prompt: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    deadline_s: Optional[float] = None  # wall budget from submit()
    priority: Priority = Priority.INTERACTIVE
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))


class RequestHandle:
    """The caller's view of a submitted request: ``tokens`` grows as the
    engine streams (eos included when hit); ``state``/``finish_reason``
    settle when the request leaves its slot; ``cancel()`` is honored at
    the engine's next step."""

    def __init__(self, request: Request, arrival_s: float):
        self.request = request
        self.arrival_s = arrival_s
        self.tokens: List[int] = []
        self.state = RequestState.QUEUED
        self.finish_reason: Optional[FinishReason] = None
        self.ttft_s: Optional[float] = None  # submit -> first token
        self.finish_s: Optional[float] = None
        self._cancel = False

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
        return (f"RequestHandle(id={self.request.request_id}, "
                f"state={self.state.value}, tokens={len(self.tokens)})")
