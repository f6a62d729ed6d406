"""Fixed-capacity per-tick telemetry ring for the serving engine (the
port's own copy of :mod:`pddl_tpu.obs.ring`).

The engine appends one record per ``step()`` (occupancy, queue depth,
tokens emitted, tick wall time); capacity is fixed at construction and
the oldest record is overwritten in place. Host-side only: records are
plain dicts of scalars the engine already computed.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class TelemetryRing:
    """Ring buffer of per-tick telemetry records: a preallocated slot
    list plus a rolling write index, so memory is ``capacity`` records
    forever."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._slots: List[Optional[Dict[str, object]]] = \
            [None] * self.capacity
        self._next = 0          # write position
        self._count = 0         # total records ever appended

    def __len__(self) -> int:
        return min(self._count, self.capacity)

    @property
    def total_appended(self) -> int:
        """Records ever appended (>= ``len`` once the ring wrapped)."""
        return self._count

    def append(self, record: Dict[str, object]) -> None:
        self._slots[self._next] = record
        self._next = (self._next + 1) % self.capacity
        self._count += 1

    def snapshot(self) -> List[Dict[str, object]]:
        """Oldest→newest copy of the current window (safe to mutate)."""
        if self._count < self.capacity:
            window = self._slots[:self._count]
        else:
            window = self._slots[self._next:] + self._slots[:self._next]
        return [dict(r) for r in window]

    def last(self) -> Optional[Dict[str, object]]:
        """Newest record, copied."""
        if self._count == 0:
            return None
        return dict(self._slots[(self._next - 1) % self.capacity])

    def summary(self) -> Dict[str, object]:
        """The window collapsed to gauges: tick-wall percentiles, mean
        queue/occupancy and totals."""
        window = self.snapshot()
        if not window:
            return {"ticks": 0}
        walls = sorted(float(r.get("tick_wall_s", 0.0)) for r in window)
        n = len(walls)
        return {
            "ticks": n,
            "window_first_step": window[0].get("step"),
            "window_last_step": window[-1].get("step"),
            "tick_wall_p50_s": walls[n // 2],
            "tick_wall_p99_s": walls[min(n - 1, int(0.99 * n))],
            "mean_queue_depth": (sum(float(r.get("queue_depth", 0))
                                     for r in window) / n),
            "mean_live_slots": (sum(float(r.get("live_slots", 0))
                                    for r in window) / n),
            "tokens_emitted": sum(int(r.get("tokens", 0)) for r in window),
        }
