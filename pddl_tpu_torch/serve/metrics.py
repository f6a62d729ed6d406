"""Serving telemetry: the numbers an online engine is judged by (the
port's own copy of :mod:`pddl_tpu.serve.metrics`, covering what the
paged engine records).

- **TTFT** (time to first token, queue wait included), p50/p99;
- **per-token latency** — the inter-token gap once streaming;
- **queue depth / slot occupancy** — the load signals;
- **tokens/s** over the engine's active window;
- the prefix-cache and paged-sharing counters.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional

import numpy as np

from pddl_tpu_torch.serve.request import Priority

# Every class is always present in the per-priority splits (zeros
# included), so the label sets never appear or vanish with traffic.
PRIORITY_CLASSES = tuple(p.value for p in Priority)


def format_table(title: str, rows: Dict[str, Any]) -> str:
    """Aligned two-column text table (the port's copy of
    ``pddl_tpu.utils.summary.format_table``): thousands separators for
    numbers, 3 decimals for floats."""
    def _fmt(v: Any) -> str:
        if isinstance(v, bool):
            return str(v)
        if isinstance(v, int):
            return f"{v:,}"
        if isinstance(v, float):
            return f"{v:,.3f}"
        return str(v)

    lines = [title]
    width = max((len(k) for k in rows), default=10)
    for key, value in rows.items():
        lines.append(f"  {key:<{width}}  {_fmt(value):>14}")
    return "\n".join(lines)


def _pct(values, q: float) -> Optional[float]:
    vals = list(values)
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


class Reservoir:
    """Fixed-capacity uniform sample of an unbounded stream (Vitter's
    algorithm R), seeded, so percentiles over the buffer estimate the
    whole stream while memory stays capped."""

    __slots__ = ("cap", "count", "_buf", "_rng")

    def __init__(self, cap: int = 8192, seed: int = 0):
        if cap < 1:
            raise ValueError(f"reservoir cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.count = 0
        self._buf: List[float] = []
        self._rng = random.Random(seed)

    def append(self, value) -> None:
        self.count += 1
        if len(self._buf) < self.cap:
            self._buf.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self._buf[j] = value

    def extend(self, values: Iterable) -> None:
        for v in values:
            self.append(v)

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)


class ServeMetrics:
    """Accumulates engine telemetry: a few host floats per tick, never a
    device sync of its own. Per-sample series live in capped
    :class:`Reservoir`\\ s."""

    def __init__(self, reservoir_cap: int = 8192) -> None:
        self.reservoir_cap = int(reservoir_cap)
        self.ttft_s = Reservoir(self.reservoir_cap, seed=0)
        self.token_latency_s = Reservoir(self.reservoir_cap, seed=1)
        self.queue_depth = Reservoir(self.reservoir_cap, seed=2)
        self.occupancy = Reservoir(self.reservoir_cap, seed=3)
        self.ttft_by_priority: Dict[str, Reservoir] = {
            cls: Reservoir(self.reservoir_cap, seed=10 + i)
            for i, cls in enumerate(PRIORITY_CLASSES)}
        self.finished_by_priority = dict.fromkeys(PRIORITY_CLASSES, 0)
        self.deadline_shed_by_priority = dict.fromkeys(PRIORITY_CLASSES, 0)
        self.rejected_by_priority = dict.fromkeys(PRIORITY_CLASSES, 0)
        self.tokens_emitted = 0
        self.requests_finished = 0
        self.requests_rejected = 0
        self.requests_timed_out = 0
        self.requests_cancelled = 0
        self.requests_deadline_shed = 0
        # Prefix cache: one lookup per admission; `prefill_tokens_saved`
        # is the cached-token total the engine did NOT re-prefill.
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefill_tokens_saved = 0
        self.prefix_evictions = 0
        self.prefix_blocks_live = 0  # gauge, engine-stamped per admission
        # Paged sharing: gather bytes a prefix hit did NOT copy, pool
        # blocks referenced by >1 live slot, mean table fill.
        self.copy_bytes_avoided = 0
        self.blocks_shared = 0       # gauge, engine-stamped per tick
        self.block_table_fill = 0.0  # gauge, engine-stamped per tick
        self._admission_times: Deque[float] = deque(maxlen=32)
        self._first_activity_s: Optional[float] = None
        self._last_activity_s: Optional[float] = None

    def record_tick(self, now_s: float, queue_depth: int, live_slots: int,
                    total_slots: int, new_tokens: int,
                    tick_seconds: float) -> None:
        self.queue_depth.append(queue_depth)
        self.occupancy.append(live_slots / max(total_slots, 1))
        self.tokens_emitted += new_tokens
        if new_tokens:
            # One fused tick serves every live slot: the inter-token gap
            # each stream sees is the whole tick's wall time.
            self.token_latency_s.extend([tick_seconds] * new_tokens)
        if self._first_activity_s is None:
            self._first_activity_s = now_s
        self._last_activity_s = now_s

    def record_first_token(self, ttft_s: float,
                           priority: Optional[str] = None) -> None:
        self.ttft_s.append(ttft_s)
        if priority in self.ttft_by_priority:
            self.ttft_by_priority[priority].append(ttft_s)
        self.tokens_emitted += 1

    def record_finish(self, reason_value: str,
                      priority: Optional[str] = None) -> None:
        """One request departed; ``requests_finished`` counts only
        successful completions, every other reason its own counter."""
        if reason_value == "timed_out":
            self.requests_timed_out += 1
        elif reason_value == "deadline":
            self.requests_deadline_shed += 1
            if priority in self.deadline_shed_by_priority:
                self.deadline_shed_by_priority[priority] += 1
        elif reason_value == "cancelled":
            self.requests_cancelled += 1
        else:
            self.requests_finished += 1
            if priority in self.finished_by_priority:
                self.finished_by_priority[priority] += 1

    def record_rejected(self, priority: Optional[str] = None) -> None:
        self.requests_rejected += 1
        if priority in self.rejected_by_priority:
            self.rejected_by_priority[priority] += 1

    def record_admission(self, now_s: float) -> None:
        self._admission_times.append(float(now_s))

    def estimate_retry_after_s(self, queue_depth: int) -> Optional[float]:
        """The QueueFull hint: the queue ahead of a new arrival times the
        recent per-admission interval; ``None`` before two admissions."""
        times = self._admission_times
        if len(times) < 2:
            return None
        interval = (times[-1] - times[0]) / (len(times) - 1)
        return max(interval, 0.0) * max(int(queue_depth), 1)

    def record_prefix_lookup(self, tokens_saved: int, *, blocks_live: int,
                             evictions: int) -> None:
        self.prefix_lookups += 1
        if tokens_saved > 0:
            self.prefix_hits += 1
            self.prefill_tokens_saved += int(tokens_saved)
        self.prefix_blocks_live = int(blocks_live)
        self.prefix_evictions = int(evictions)

    def record_copy_avoided(self, nbytes: int) -> None:
        self.copy_bytes_avoided += int(nbytes)

    def record_paged_gauges(self, blocks_shared: int,
                            block_table_fill: float) -> None:
        self.blocks_shared = int(blocks_shared)
        self.block_table_fill = float(block_table_fill)

    def snapshot(self) -> Dict[str, object]:
        """The dashboard dict: counters plus latency percentiles (None
        where nothing was recorded yet)."""
        window = None
        if (self._first_activity_s is not None
                and self._last_activity_s is not None):
            window = self._last_activity_s - self._first_activity_s
        return {
            "requests_finished": self.requests_finished,
            "requests_rejected": self.requests_rejected,
            "requests_timed_out": self.requests_timed_out,
            "requests_cancelled": self.requests_cancelled,
            "requests_deadline_shed": self.requests_deadline_shed,
            "tokens_emitted": self.tokens_emitted,
            "tokens_per_s": (self.tokens_emitted / window
                             if window else None),
            "ttft_p50_s": _pct(self.ttft_s, 50),
            "ttft_p99_s": _pct(self.ttft_s, 99),
            "token_latency_p50_s": _pct(self.token_latency_s, 50),
            "token_latency_p99_s": _pct(self.token_latency_s, 99),
            "mean_queue_depth": (float(np.mean(list(self.queue_depth)))
                                 if self.queue_depth else None),
            "mean_slot_occupancy": (float(np.mean(list(self.occupancy)))
                                    if self.occupancy else None),
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_lookups
                                if self.prefix_lookups else None),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefix_blocks_live": self.prefix_blocks_live,
            "prefix_evictions": self.prefix_evictions,
            "copy_bytes_avoided": self.copy_bytes_avoided,
            "blocks_shared": self.blocks_shared,
            "block_table_fill": round(self.block_table_fill, 6),
            "requests_finished_by_priority": dict(self.finished_by_priority),
            "requests_deadline_shed_by_priority": dict(
                self.deadline_shed_by_priority),
            "requests_rejected_by_priority": dict(self.rejected_by_priority),
            "ttft_p50_s_by_priority": {
                cls: _pct(r, 50) for cls, r in self.ttft_by_priority.items()},
            "ttft_p99_s_by_priority": {
                cls: _pct(r, 99) for cls, r in self.ttft_by_priority.items()},
        }

    def summary(self) -> str:
        """Human-readable table (per-priority mappings flatten to one
        ``key[class]`` row each)."""
        rows = {}
        for k, v in self.snapshot().items():
            if isinstance(v, dict):
                for cls, cv in v.items():
                    rows[f"{k}[{cls}]"] = "-" if cv is None else cv
            else:
                rows[k] = "-" if v is None else v
        return format_table("Serving metrics:", rows)
