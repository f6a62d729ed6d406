"""The paged KV pool: the storage half of the paged serving engine (the
port of :mod:`pddl_tpu.serve.kvcache.block_pool`'s paged subset).

Every layer's K and V live in a pool ``[N, H_kv, block_size, D]``; block
``j`` of a row's table holds the K/V of its tokens
``[j*block_size, (j+1)*block_size)`` at their ABSOLUTE positions (Llama
caches post-RoPE keys), so a prefix block computed by one request is
bit-valid for every later request sharing those prompt tokens.

Block id 0 is the reserved WRITE SINK (scratch): parked rows' tables are
all scratch, padded writes past a table land there, and the radix index
(``radix.py``) never hands it out.
"""

from __future__ import annotations

import torch

# The reserved write-sink block id (see module docstring).
SCRATCH_BLOCK = 0


def paged_decode_cache(model, num_blocks: int, block_size: int) -> dict:
    """The PAGED serving cache: the pool IS the cache.

    A tree mirroring the JAX package's cache collection —
    ``{"block<i>": {"attn": {"cached_key": pool, "cached_value": pool}}}``
    with zero pools ``[num_blocks, H_kv, block_size, D]`` in the model's
    dtype on its device — minus the position counters and block tables,
    which the port passes to the forward as arguments
    (``models/gpt.py``)."""
    if getattr(model, "uses_ring_cache", False):
        raise NotImplementedError(
            f"sliding_window={model.sliding_window} needs a rolling ring "
            "cache in decode, which is not ported yet: ROADMAP.md queue 1 "
            "item 2 (the resident-row engine)")
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block 0 is the reserved scratch "
            f"sink), got {num_blocks}")
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    shape = (num_blocks, model.num_kv_heads, block_size, model.head_dim)

    def _pool():
        return torch.zeros(shape, dtype=model.dtype, device=model.device)

    return {f"block{i}": {"attn": {"cached_key": _pool(),
                                   "cached_value": _pool()}}
            for i in range(model.depth)}


def _leaves(tree):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def pool_nbytes(pool: dict) -> int:
    """Device bytes a pool tree's tensors occupy."""
    return sum(t.numel() * t.element_size() for t in _leaves(pool))
