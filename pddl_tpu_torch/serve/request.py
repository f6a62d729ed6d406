"""Request lifecycle for the online serving engine (the port's own copy
of :mod:`pddl_tpu.serve.request`).

The engine is single-threaded and caller-driven (``engine.step()``), so
handles need no locking — cancellation is a flag the engine honors at its
next tick. Sampling parameters are PER-REQUEST runtime values batched
into ``[slots]`` arrays each tick, hence the array sentinels on
:class:`SamplingParams`. A handle carries the engine's replay and
preemption bookkeeping (:class:`RequestHandle`).
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


class AdmissionRejected(QueueFull):
    """Router-level admission-control rejection (a :class:`QueueFull`
    subclass, so every backpressure path handles it): the request was
    refused before any engine queue was consulted — a per-priority token
    bucket ran dry, or a brownout is shedding this class (``reason`` says
    which). Carries the same ``retry_after_s`` contract."""

    def __init__(self, reason: str, retry_after_s: Optional[float] = None,
                 priority: Optional[Priority] = None,
                 queue_depth: int = 0, max_queue_depth: int = 0):
        super().__init__(queue_depth, max_queue_depth,
                         retry_after_s=retry_after_s, priority=priority)
        self.reason = reason
        hint = (f"; retry after ~{retry_after_s:.3f}s"
                if retry_after_s is not None else "")
        # Replace the queue-full message: no engine queue was involved.
        self.args = (
            f"fleet admission rejected ({reason}"
            f"{', ' + priority.value if priority is not None else ''})"
            f"{hint}",)


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
    """One generate request as the scheduler sees it.

    ``adapter``/``constraint`` are the multi-tenant fields
    (`serve/tenant/`): the NAME of a registered LoRA adapter (``None`` =
    base model) and a JSON-able constraint spec dict (``{"kind":
    "regex"|"json_schema", ...}``, the input of
    :func:`pddl_tpu_torch.serve.tenant.compile_constraint`; ``None`` =
    unconstrained)."""

    prompt: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    deadline_s: Optional[float] = None  # wall budget from submit()
    priority: Priority = Priority.INTERACTIVE
    adapter: Optional[str] = None       # registered LoRA adapter name
    constraint: Optional[dict] = None   # grammar/schema spec dict
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))


class RequestHandle:
    """The caller's view of a submitted request: ``tokens`` grows as the
    engine streams (eos included when hit); ``state``/``finish_reason``
    settle when the request leaves its slot; ``cancel()`` is honored at
    the engine's next step.

    ``replays`` counts the engine's rebuilds of this request's slot state
    after a device fault (each re-prefills the prompt and re-feeds
    ``tokens`` through the ticks: the caller's stream never repeats or
    loses a token); past the engine's ``max_replays`` the request settles
    FAILED/ERROR. ``replay_pending`` is engine-internal: the emitted
    tokens still to re-feed. ``preemptions`` counts slot evictions in
    favour of queued interactive work (the stream resumes through the
    same replay); the engine's ``preempt_cap`` bounds it."""

    def __init__(self, request: Request, arrival_s: float):
        self.request = request
        self.arrival_s = arrival_s
        self.tokens: List[int] = []
        self.state = RequestState.QUEUED
        self.finish_reason: Optional[FinishReason] = None
        self.ttft_s: Optional[float] = None  # submit -> first token
        self.finish_s: Optional[float] = None
        self.replays = 0
        self.replay_pending: List[int] = []
        self.preemptions = 0
        # Speculative serving (engine ``spec_k > 0``): draft tokens offered
        # for this stream's acceptance and the ones the verifier accepted;
        # zero on a non-speculative engine.
        self.spec_drafted = 0
        self.spec_accepted = 0
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
