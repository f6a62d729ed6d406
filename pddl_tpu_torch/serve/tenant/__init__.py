"""Multi-tenant serving: per-request LoRA adapters + constrained decoding
(the port of :mod:`pddl_tpu.serve.tenant`).

Two subsystems sharing one admission path, both built on the engine's
rule that all per-slot variation lives in RUNTIME tensors:

- **Paged LoRA** (`adapters.py` + `ops/lora.py`): a registry of host-
  resident adapters, a fixed-shape device pool with pin-on-admit
  refcounts and LRU eviction (the KV block pool's discipline applied to
  weights), per-slot adapter rows gathered inside the fused tick, and a
  cold load charged against the prefill budget like an uncached prompt
  suffix.
- **Constrained decoding** (`grammar.py`): regex / JSON schema →
  Brzozowski-derivative DFA → token FSM whose per-state allow mask is
  stamped as a ``[S, V]`` tensor ahead of the batched sampler.

Enable with ``ServeEngine(..., tenant=TenantConfig(...))``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from pddl_tpu_torch.serve.tenant.adapters import (
    AdapterPool,
    AdapterPoolExhausted,
    AdapterRegistry,
    LoRAAdapter,
)
from pddl_tpu_torch.serve.tenant.grammar import (
    TokenFSM,
    compile_constraint,
    constraint_key,
    decode_tokens,
    encode_text,
    json_schema_to_regex,
    token_fsm_from_regex,
)


@dataclasses.dataclass
class TenantConfig:
    """Multi-tenancy knobs for
    :class:`~pddl_tpu_torch.serve.engine.ServeEngine`.

    Args:
      registry: the deployment's :class:`AdapterRegistry`; ``None``
        builds an empty one sized to the model (adapters can be
        registered before traffic). Its ``embed_dim``/``vocab_size``
        must match the engine's model, which the engine checks at
        construction.
      adapter_pool_slots: device pool rows INCLUDING the reserved
        identity row 0: how many distinct adapters can be resident at
        once. ``None`` (default) sizes it to the engine's
        ``max_slots + 4``. An explicit size must cover the floor
        ``max_slots + 1`` (every slot on a distinct adapter plus the
        identity row); the headroom above it is the hit-rate knob.
      token_strings: token-id → string vocabulary for grammar
        compilation (index = token id; an empty string makes a token
        never legal under any constraint). Required before a
        constrained ``submit()``; adapters-only tenancy may leave it
        ``None``.
      adapter_load_tokens: prefill-budget tokens a COLD adapter load is
        charged at admission (a resident adapter charges nothing).
    """

    registry: Optional[AdapterRegistry] = None
    adapter_pool_slots: Optional[int] = None
    token_strings: Optional[Sequence[str]] = None
    adapter_load_tokens: int = 8


__all__ = [
    "AdapterPool",
    "AdapterPoolExhausted",
    "AdapterRegistry",
    "LoRAAdapter",
    "TenantConfig",
    "TokenFSM",
    "compile_constraint",
    "constraint_key",
    "decode_tokens",
    "encode_text",
    "json_schema_to_regex",
    "token_fsm_from_regex",
]
