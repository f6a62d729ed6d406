"""The KV block pool: the storage half of the prefix cache and of the
paged serving engine (the port of :mod:`pddl_tpu.serve.kvcache.block_pool`).

Every layer's K and V live in a pool ``[N, H_kv, block_size, D]``; block
``j`` of a cached prefix holds the K/V of its tokens
``[j*block_size, (j+1)*block_size)`` at their ABSOLUTE positions (Llama
caches post-RoPE keys), so a prefix block computed by one request is
bit-valid for every later request sharing those prompt tokens.

Two engines use it. The resident-row engine (``paged=False``) keeps each
live request in a slot row of its own cache and copies through the pool:
a prefix hit gathers pool blocks into the admission row
(:func:`gather_prefix_into_row`) and a finished prefill donates its
prompt's full blocks (:func:`donate_prefix_blocks`) — copy-on-write by
construction. The paged engine (``paged=True``) has no rows: the pool IS
the cache (:func:`paged_decode_cache`) and block tables point into it.

Block id 0 is the reserved WRITE SINK (scratch): parked rows' tables are
all scratch, padded writes past a table land there, and the radix index
(``radix.py``) never hands it out.
"""

from __future__ import annotations

import torch

from pddl_tpu_torch.ops.attention import (
    cache_blocks_gather,
    cache_blocks_scatter,
)

# The reserved write-sink block id (see module docstring).
SCRATCH_BLOCK = 0


def kv_block_pool(model, num_blocks: int, block_size: int) -> dict:
    """A zero block pool for ``model``: a tree mirroring its decode cache
    (``models/gpt.decode_cache``) —
    ``{"block<i>": {"attn": {"cached_key": pool, "cached_value": pool}}}``
    with pools ``[num_blocks, H_kv, block_size, D]`` in the model's dtype
    on its device. The JAX tree's position counters have no counterpart:
    the port passes positions to the forward as arguments."""
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


def paged_decode_cache(model, num_blocks: int, block_size: int) -> dict:
    """The PAGED serving cache: the pool IS the cache (a
    :func:`kv_block_pool`; the JAX tree's block tables are arguments of
    the port's forward, ``models/gpt.py``). A model whose decode needs a
    rolling ring cache is refused, as the JAX package's paged attention
    refuses it."""
    if getattr(model, "uses_ring_cache", False):
        raise NotImplementedError(
            "paged attention requires a full-length cache; rolling "
            f"sliding-window caches are not paged (sliding_window="
            f"{model.sliding_window})")
    return kv_block_pool(model, num_blocks, block_size)


def _leaves(tree):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def kv_leaf_items(tree: dict):
    """``(key, leaf)`` for every K/V leaf of a cache or pool tree. ``key``
    is the leaf's path in the JAX package's ``keystr`` form
    (``"['block0']['attn']['cached_key']"``) and the items come in that
    package's flattening order (sorted keys), so a host-tier payload, and
    a prefix chain on the wire, carries the same keys in the same order
    in both packages."""
    return sorted(((f"['{blk}']['attn']['{name}']", leaf)
                   for blk, leaves in tree.items()
                   for name, leaf in leaves["attn"].items()),
                  key=lambda item: item[0])


def _kv_pairs(pool: dict, row_cache: dict):
    """``(pool_leaf, row_leaf)`` for every K/V leaf of two cache trees of
    one model."""
    for blk, leaves in pool.items():
        for name, leaf in leaves["attn"].items():
            yield leaf, row_cache[blk]["attn"][name]


def pool_nbytes(pool: dict) -> int:
    """Device bytes a pool tree's tensors occupy."""
    return sum(t.numel() * t.element_size() for t in _leaves(pool))


def gather_prefix_into_row(pool: dict, row_cache: dict, block_ids) -> dict:
    """Copy pool blocks ``block_ids [M]`` into positions
    ``[0, M*block_size)`` of every K/V leaf of a batch-1 row cache, in
    place, and return the row. What lies beyond is stale: the suffix
    prefill overwrites it, or it parks past the position the slot insert
    stamps. (The JAX engine pads the ids to a fixed length with the
    scratch block, for one compiled program; the port gathers the matched
    blocks only.)"""
    for pool_leaf, row_leaf in _kv_pairs(pool, row_cache):
        pre = cache_blocks_gather(pool_leaf, block_ids)
        row_leaf[..., :pre.shape[-2], :] = pre.to(row_leaf.dtype)
    return row_cache


def donate_prefix_blocks(pool: dict, row_cache: dict, block_ids,
                         start_block: int) -> dict:
    """Write row-cache tokens ``[start_block*bs, (start_block+M)*bs)``
    into pool blocks ``block_ids [M]`` on every K/V leaf, in place — a
    finished prefill donating its prompt's uncached full blocks — and
    return the pool."""
    for pool_leaf, row_leaf in _kv_pairs(pool, row_cache):
        cache_blocks_scatter(pool_leaf, row_leaf, block_ids, start_block)
    return pool
