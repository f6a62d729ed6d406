"""Seeded scenario-diversity trace generator for fleet-scale replay.

The port's own copy of :mod:`pddl_tpu.serve.fleet.tracegen` (host
Python, no JAX): the same names, error texts, literal tables and wire
shapes.

The committed benches each invented their own workload shape (Poisson
for the failover tests, one bursty multi-turn schedule for overload);
none can answer
"is this change better FOR PRODUCTION", because production traffic has
structure those shapes miss. This module is the one generator the
replay harness (`fleet/replay.py`) and the autoscale bench leg feed on,
with the three structures that matter baked in and SEEDED (every trace
is reproducible from its arguments):

- **Diurnal load curve.** Session arrivals follow a sinusoidal
  intensity with a configurable peak:trough ratio over a configurable
  number of periods — the day/night swing that makes static capacity
  either waste the trough or brown out the peak, i.e. exactly the
  regime an autoscaler is judged in. Arrival times come from
  inverse-CDF sampling of the integrated intensity, so the curve is
  exact, not a binned approximation.
- **Heavy-tail session mix, fitted from the trace.** Multi-turn
  sessions over shared system prompts: the conversation grows per
  turn, think time is exponential, and output lengths draw from the
  bounded Pareto the schedule used (``base + pareto(tail)*scale``,
  capped) — most replies short, a heavy tail of long ones. Priorities
  split interactive/batch/best_effort by a configurable mix, the
  interactive class deadlined.
- **Tenant/adapter popularity skew.** Sessions optionally carry a LoRA
  adapter (`serve/tenant/`) drawn Zipf-style over the adapter list —
  a few hot tenants, a long cold tail — which is what exercises
  adapter affinity and pool churn the way a real multi-tenant fleet
  sees them.

Events are plain dicts (``t``/``session``/``prompt``/``new_tokens``/
``priority``/``deadline_s``/``adapter``) on an absolute timeline of
``duration_s`` seconds, ready for :func:`~.replay.replay_trace`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pddl_tpu_torch.serve.request import Priority


def diurnal_intensity(t, duration_s: float, *, periods: float = 2.0,
                      peak_to_trough: float = 6.0):
    """Relative arrival intensity at time ``t`` (array-ok): a sinusoid
    with mean 1 whose max/min ratio is ``peak_to_trough``, starting at
    the trough (the trace opens in the quiet hours, so an autoscaled
    fleet demonstrably STARTS small)."""
    if peak_to_trough < 1.0:
        raise ValueError(
            f"peak_to_trough must be >= 1, got {peak_to_trough}")
    a = (peak_to_trough - 1.0) / (peak_to_trough + 1.0)
    phase = 2.0 * np.pi * periods * np.asarray(t) / duration_s
    return 1.0 + a * np.sin(phase - np.pi / 2.0)


def _arrival_times(rng, n: int, duration_s: float, periods: float,
                   peak_to_trough: float) -> np.ndarray:
    """``n`` arrival times on [0, duration_s] following the diurnal
    curve, by inverse-CDF sampling over the integrated intensity."""
    grid = np.linspace(0.0, duration_s, 4096)
    lam = diurnal_intensity(grid, duration_s, periods=periods,
                            peak_to_trough=peak_to_trough)
    cdf = np.cumsum(lam)
    cdf = cdf / cdf[-1]
    return np.interp(rng.random(n), cdf, grid)


def diurnal_trace(n_requests: int, vocab: int, seed: int, *,
                  duration_s: float = 120.0,
                  periods: float = 2.0,
                  peak_to_trough: float = 6.0,
                  n_system_prompts: int = 4,
                  prompt_base: int = 16, prompt_cap: int = 60,
                  priority_mix: Tuple[float, float, float] =
                  (0.35, 0.15, 0.50),
                  interactive_deadline_s: Optional[float] = 8.0,
                  adapters: Optional[Sequence[str]] = None,
                  adapter_skew: float = 1.1,
                  adapter_frac: float = 0.75,
                  max_turns: int = 3,
                  think_time_s: float = 0.8,
                  new_tokens_base: int = 4, new_tokens_scale: float = 4.0,
                  new_tokens_tail: float = 1.3, new_tokens_cap: int = 48,
                  ) -> Tuple[List[Dict[str, object]], float]:
    """The scaled replay trace: ``(events, mean_new_tokens)``.

    Exactly ``n_requests`` events (turns), sorted by time over
    ``duration_s`` seconds. ``priority_mix`` is the
    interactive/batch/best_effort session split (best_effort is the
    remainder — the sheddable bulk a brownout eats first). With
    ``adapters`` given, ``adapter_frac`` of sessions carry one, chosen
    with Zipf(``adapter_skew``) popularity; sessions keep their tenant
    across turns (tenancy is a property of the caller, not the turn).
    """
    if sum(priority_mix[:2]) > 1.0:
        raise ValueError(f"priority_mix fractions exceed 1: "
                         f"{priority_mix}")
    rng = np.random.default_rng(seed)
    sys_prompts = [rng.integers(0, vocab, size=prompt_base)
                   for _ in range(n_system_prompts)]
    adapter_p = None
    if adapters:
        ranks = np.arange(1, len(adapters) + 1, dtype=np.float64)
        adapter_p = ranks ** -float(adapter_skew)
        adapter_p /= adapter_p.sum()
    events: List[Dict[str, object]] = []
    s = 0
    # Heavy-tail turn counts mean ~2 events/session at the default
    # max_turns; oversample sessions, then truncate to n_requests.
    while len(events) < n_requests:
        n_sessions = max(8, (n_requests - len(events)) // 2)
        starts = np.sort(_arrival_times(rng, n_sessions, duration_s,
                                        periods, peak_to_trough))
        for t0 in starts:
            s += 1
            r = rng.random()
            pr = (Priority.INTERACTIVE if r < priority_mix[0]
                  else Priority.BATCH
                  if r < priority_mix[0] + priority_mix[1]
                  else Priority.BEST_EFFORT)
            adapter = None
            if adapter_p is not None and rng.random() < adapter_frac:
                adapter = adapters[int(rng.choice(len(adapter_p),
                                                  p=adapter_p))]
            sysp = sys_prompts[int(rng.integers(0, n_system_prompts))]
            convo: List[int] = []
            tt = float(t0)
            for _turn in range(int(rng.integers(1, max_turns + 1))):
                convo = convo + rng.integers(
                    0, vocab, size=int(rng.integers(6, 13))).tolist()
                prompt = np.concatenate(
                    [sysp, np.asarray(convo)]).astype(np.int32)
                new = int(min(new_tokens_base
                              + rng.pareto(new_tokens_tail)
                              * new_tokens_scale, new_tokens_cap))
                events.append(dict(
                    t=tt, session=f"s{s}",
                    prompt=prompt[:prompt_cap].tolist(),
                    new_tokens=new, priority=pr,
                    deadline_s=(interactive_deadline_s
                                if pr is Priority.INTERACTIVE else None),
                    adapter=adapter))
                tt += float(rng.exponential(think_time_s))
    # Down-sample the overshoot UNIFORMLY, not by truncating the sorted
    # tail: cutting the latest events would amputate the final
    # trough/peak and bend the diurnal shape the curve promises.
    if len(events) > n_requests:
        keep = rng.choice(len(events), size=n_requests, replace=False)
        events = [events[i] for i in sorted(keep)]
    events = sorted(events, key=lambda e: e["t"])
    mean_new = float(np.mean([e["new_tokens"] for e in events]))
    return events, mean_new
