"""Host-side radix index over prompt token ids → KV block chains (the
port's own copy of :mod:`pddl_tpu.serve.kvcache.radix`, same block-id and
LRU-eviction behaviour, with the host tier's demotion hook ``on_evict``).

A tree whose every node owns exactly ONE pool block — the K/V of
``block_size`` tokens — keyed by those tokens, so a root-to-node path
spells a prompt prefix and the path's block ids are the chain a paged
slot's block table points at. Host-side only: ids and token tuples, never
device tensors.

Invariants:

- **Accounting**: every non-scratch pool block is either on the free
  list or owned by exactly one live node (or by a slot that allocated it
  and has not handed it to the index); ``blocks_live + blocks_free ==
  num_blocks - 1``.
- **Refcounts**: ``pin(node)`` increments every node on the root path,
  ``unpin`` decrements it; a request pins the deepest node it matched or
  extended for its whole slot residency.
- **Eviction**: only LEAF nodes with ``ref == 0`` are evictable, least
  recently accessed first, so a stored chain never loses an ancestor
  block while a descendant or a pinned user remains.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from pddl_tpu_torch.serve.kvcache.block_pool import SCRATCH_BLOCK


class _Node:
    """One cached block: ``key`` is its block's token tuple, ``block_id``
    its pool row. The root is a sentinel (no key, no block)."""

    __slots__ = ("key", "block_id", "parent", "children", "ref",
                 "last_access")

    def __init__(self, key: Optional[tuple], block_id: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.ref = 0
        self.last_access = 0


@dataclasses.dataclass
class PrefixMatch:
    """Longest stored chain for a prompt: ``node`` is the deepest match
    (the root for a full miss), ``block_ids`` its root path's blocks."""

    node: _Node
    block_ids: List[int]

    @property
    def n_blocks(self) -> int:
        return len(self.block_ids)


class RadixPrefixCache:
    """Refcounted, LRU-evicted radix index over a block pool.

    Args:
      block_size: tokens per block.
      num_blocks: pool rows INCLUDING the reserved scratch sink (id 0),
        so ``num_blocks - 1`` blocks are allocatable.
    """

    def __init__(self, block_size: int, num_blocks: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block {SCRATCH_BLOCK} is the "
                f"scratch sink), got {num_blocks}")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self._free: Deque[int] = deque(range(1, num_blocks))
        self._root = _Node(None, None, None)
        self._clock = itertools.count(1)
        self.evictions = 0
        # Demotion hook (``kvcache/hosttier.py``): called once per reclaim
        # with the LIST of victims BEFORE their ids are freed — each still
        # attached, its chain walkable — so the engine can spill their K/V
        # to the host tier in one batched gather. It must not touch this
        # index. ``None`` keeps eviction a plain free; the degraded flush
        # never calls it (``flush_unpinned``).
        self.on_evict = None

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_live(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def _key(self, tokens: Sequence[int], j: int) -> tuple:
        bs = self.block_size
        return tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])

    def match(self, tokens: Sequence[int],
              max_blocks: Optional[int] = None) -> PrefixMatch:
        """Walk the longest stored chain of full-block matches of
        ``tokens`` (optionally capped at ``max_blocks``), refreshing the
        chain's LRU stamps. Never pins — callers pin explicitly."""
        now = next(self._clock)
        node = self._root
        ids: List[int] = []
        limit = len(tokens) // self.block_size
        if max_blocks is not None:
            limit = min(limit, max_blocks)
        for j in range(limit):
            child = node.children.get(self._key(tokens, j))
            if child is None:
                break
            node = child
            node.last_access = now
            ids.append(node.block_id)
        return PrefixMatch(node, ids)

    def descend(self, node: _Node, tokens: Sequence[int],
                start_block: int) -> Tuple[_Node, int]:
        """Walk already-stored children of ``node`` along ``tokens`` from
        ``start_block`` on, refreshing LRU stamps; returns the deepest
        stored node and its block depth (the donation-side dedup)."""
        now = next(self._clock)
        j = start_block
        while True:
            key = self._key(tokens, j)
            if len(key) != self.block_size:
                break
            child = node.children.get(key)
            if child is None:
                break
            node = child
            node.last_access = now
            j += 1
        return node, j

    def chain_tokens(self, node: _Node) -> List[int]:
        """Root-path token ids of ``node`` (``depth * block_size`` of them):
        the chain identity the host tier keys a demoted block under."""
        keys: List[tuple] = []
        while node is not self._root:
            keys.append(node.key)
            node = node.parent
        keys.reverse()
        return [int(t) for key in keys for t in key]

    def chain_depth(self, node: _Node) -> int:
        """Block count of ``node``'s root path (0 for the root)."""
        depth = 0
        while node is not self._root:
            depth += 1
            node = node.parent
        return depth

    def chain_ids(self, node: _Node) -> List[int]:
        """Root-path block ids of ``node``, root-first."""
        ids: List[int] = []
        while node is not self._root:
            ids.append(node.block_id)
            node = node.parent
        ids.reverse()
        return ids

    def pin(self, node: _Node) -> None:
        """Protect ``node`` and its whole root path from eviction (one
        live user). Pinning the root is a no-op."""
        while node is not self._root:
            node.ref += 1
            node = node.parent

    def unpin(self, node: _Node) -> None:
        while node is not self._root:
            if node.ref <= 0:
                raise RuntimeError(
                    "unpin without a matching pin (refcount underflow) — "
                    "an engine slot released its prefix chain twice")
            node.ref -= 1
            node = node.parent

    def flush_unpinned(self) -> int:
        """Degraded-mode flush: evict EVERY unpinned block (chains live
        slots still pin stay). Returns the number of blocks freed. It
        bypasses demotion: this runs inside the OOM response, where a
        spill per evicted block would spend transfers and host memory
        exactly when the engine is shedding work."""
        before = self.blocks_free
        self._reclaim(self.blocks_live, demote=False)
        return self.blocks_free - before

    def release(self, block_ids: List[int]) -> None:
        """Return ids from :meth:`allocate` that were never attached via
        :meth:`extend` (a slot's private blocks)."""
        for bid in block_ids:
            if bid == SCRATCH_BLOCK:
                raise ValueError("the scratch block is never allocated")
            self._free.append(bid)

    def allocate(self, n: int) -> List[int]:
        """Up to ``n`` free block ids, LRU-evicting unpinned leaves as
        needed. May return FEWER than asked (everything else is pinned)."""
        if len(self._free) < n:
            self._reclaim(n - len(self._free))
        take = min(n, len(self._free))
        return [self._free.popleft() for _ in range(take)]

    def _reclaim(self, need: int, demote: bool = True) -> None:
        """Evict up to ``need`` unpinned LEAVES, least recently accessed
        first. One DFS collects the evictable set per pass; evicting a
        leaf can expose its parent as a new leaf, so passes repeat until
        satisfied or nothing is evictable. Victims are marked between
        passes and detached together at the end. With ``on_evict`` set
        (and ``demote``), the whole reclaim's victim set, in eviction
        order, is offered to it in ONE call before any id is freed."""
        call_hook = demote and self.on_evict is not None
        all_taken: List[_Node] = []
        marked = set()
        while need > 0:
            victims = []
            stack = [self._root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if (node is not self._root and node.ref == 0
                        and id(node) not in marked
                        and all(id(c) in marked
                                for c in node.children.values())):
                    victims.append(node)
            if not victims:
                break
            victims.sort(key=lambda v: v.last_access)
            taken = victims[:need]
            all_taken.extend(taken)
            marked.update(id(v) for v in taken)
            need -= min(need, len(victims))
        if all_taken and call_hook:
            self.on_evict(all_taken)
        for victim in all_taken:
            del victim.parent.children[victim.key]
            self._free.append(victim.block_id)
            self.evictions += 1

    def extend(self, node: _Node, tokens: Sequence[int],
               block_ids: Sequence[int]) -> _Node:
        """Attach ``len(block_ids)`` new child blocks under ``node``, one
        per consecutive ``block_size``-token chunk of ``tokens``, in chain
        order. Returns the new chain tip. A chunk already stored keeps
        the existing node and frees the offered id."""
        now = next(self._clock)
        for j, bid in enumerate(block_ids):
            if bid == SCRATCH_BLOCK:
                raise ValueError("the scratch block cannot join the index")
            key = self._key(tokens, j)
            if len(key) != self.block_size:
                raise ValueError(
                    f"chunk {j} has {len(key)} tokens, need a full "
                    f"{self.block_size}-token block")
            if key in node.children:
                self._free.append(bid)
                node = node.children[key]
            else:
                child = _Node(key, bid, node)
                node.children[key] = child
                node = child
            node.last_access = now
        return node
