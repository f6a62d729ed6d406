"""Deterministic fault injection for the serving engine (the port of
:mod:`pddl_tpu.serve.faults`).

The machinery (seeded schedule and rate draws, the fault taxonomy, the
injection-before-dispatch discipline, :func:`classify`) lives in
:mod:`pddl_tpu_torch.utils.faults`; this module pins the SERVING site
vocabulary: a :class:`FaultPlan` hooks every device-call boundary of
:class:`~pddl_tpu_torch.serve.engine.ServeEngine` and fires transient
errors, allocation failures, latency spikes or hard kill-points at chosen
or randomly drawn ``(step, site)`` coordinates.

The engine's contract per fault kind (``engine._device_call``):

- **TRANSIENT**: bounded-backoff retry; past ``max_retries`` the slot
  K/V is declared lost and the request(s) REPLAY token-exactly.
- **OOM**: never blind-retried — DEGRADED mode (prefix-cache donations
  off, unpinned pool blocks flushed), re-armed after a cool-down.
- **LATENCY**: the call is delayed; deadlines keep working.
- **KILL**: unwinds through ``step()`` like a real crash.
"""

from __future__ import annotations

from pddl_tpu_torch.utils.faults import (  # noqa: F401 - the serve surface
    FaultKind,
    FaultSpec,
    InjectedResourceExhausted,
    InjectedTransientError,
    KillPoint,
    classify,
)
from pddl_tpu_torch.utils.faults import FaultPlan as _BaseFaultPlan


class FaultPlan(_BaseFaultPlan):
    """Seeded fault schedule over the engine's device-call sites — the
    same 13 sites, in the same order, as the JAX engine's.

    Each site names one guarded call of the port's engine: ``prefill``
    (the one-shot prefill with the prefix cache off), ``gather`` (pool to
    admission row), ``chunk_prefill`` / ``chunk_prefill_wide`` (a narrow
    or wide suffix chunk), ``donate`` (admission row to pool), ``insert``
    (admission row to slot), ``tick`` (the fused decode step),
    ``sample_first`` (an admission's first token), ``adapter_load`` (a
    cold LoRA factor load), ``draft`` (the n-gram lookup or the draft
    model's steps: a lost draft call falls back to repeat-last-token
    drafts), ``verify`` (the speculative window, which replaces ``tick``),
    ``draft_prefill`` (the draft model's admission chunk) and
    ``host_promote`` (a host-tier chain's scatter into the pool).
    Demotion is not a site: a failed spill degrades to free-and-recompute.
    """

    SITES = ("prefill", "gather", "chunk_prefill", "chunk_prefill_wide",
             "donate", "insert", "tick", "sample_first", "adapter_load",
             "draft", "verify", "draft_prefill", "host_promote")
