"""Host-RAM spill tier under the device radix index (the port's own copy
of :mod:`pddl_tpu.serve.kvcache.hosttier`).

The missing tier between "in device memory" and "recompute": with a tier
armed, the radix index's LRU eviction becomes a DEMOTION — the evicted
block's K/V is copied device to host into a byte-budgeted host pool
tracked by a second token-keyed index — and an admission that misses the
device pool but hits the tier PROMOTES the chain back with one
host-to-device scatter, charged against the prefill budget instead of
re-running the model.

Division of labour (mirroring ``radix.py`` / ``block_pool.py``):

- :class:`HostTierCache` here is host-side ONLY and framework-free: it
  holds OPAQUE per-leaf block payloads — anything with ``.shape``,
  ``.dtype`` and ``.nbytes``; the engine stores CPU torch tensors, since
  ``torch.bfloat16`` has no numpy dtype — under a token-keyed tree with
  radix-style root-path refcounts and a byte-budgeted LRU. Its byte
  arithmetic is the JAX tier's, payload for payload.
- The ENGINE owns the transfers: demotion gathers a reclaim's victims
  with one ``ops.attention.cache_blocks_gather`` per leaf and one
  device-to-host copy; promotion is one host-to-device copy of the
  stacked chain and one ``ops.attention.cache_blocks_scatter`` per leaf
  (the ``host_promote`` fault site).

Tree shape: every node owns exactly one ``block_size``-token chunk, keyed
by its tokens, so a root path spells a prefix. Nodes are STRUCTURAL
(``data is None``) when their block lives elsewhere (still on the
device, or already shed from the tier): device eviction is leaf-first,
so chains spill tip-first while their roots stay resident. A host match
therefore EXTENDS a device match: :meth:`HostTierCache.match_from` walks
from the device-matched depth and stops at the first hole in the chain.

Recency survives demotion for free: the device reclaim evicts the least
recently used leaves first, so they receive the earliest host LRU stamps
and are the first the byte budget sheds. A promotion PINS the host chain
(:meth:`HostTierCache.pin_chain`) for the span of its transfer, and every
fault or unwind path releases it through :meth:`HostTierCache.unpin`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HostTierConfig:
    """Engine-facing host-tier knobs (``ServeEngine(host_tier=...)``).

    Args:
      byte_budget: host bytes the tier may hold resident; ``0`` disables
        the tier entirely — the engine is then bit-identical to one
        built without the argument.
      promote_tokens_per_block: prefill-budget charge per PROMOTED
        block, through the scheduler's tenancy-aware ``cost_fn`` — the
        H2D transfer is admission-path work like a cold adapter load,
        but far cheaper than prefilling ``block_size`` tokens, so the
        default prices one block of promotion well under one block of
        prefill.
      min_chain_blocks: spill-worthiness floor — an evicted chain
        shorter than this many blocks is freed, not demoted (short
        chains repay a D2H+H2D round trip worst; recency needs no knob
        because LRU eviction order IS the recency score and it carries
        into the tier's own LRU, see the module docstring).
    """

    byte_budget: int
    promote_tokens_per_block: int = 2
    min_chain_blocks: int = 1

    def __post_init__(self):
        if self.byte_budget < 0:
            raise ValueError(
                f"byte_budget must be >= 0, got {self.byte_budget}")
        if self.promote_tokens_per_block < 0:
            raise ValueError(
                f"promote_tokens_per_block must be >= 0, got "
                f"{self.promote_tokens_per_block}")
        if self.min_chain_blocks < 1:
            raise ValueError(
                f"min_chain_blocks must be >= 1, got "
                f"{self.min_chain_blocks}")


class _HostNode:
    """One host-tier block: ``key`` its token tuple, ``data`` the
    per-leaf payloads (``None`` = structural), ``depth`` its block count
    from the root (root = 0)."""

    __slots__ = ("key", "parent", "children", "ref", "last_access",
                 "depth", "data", "nbytes")

    def __init__(self, key: Optional[tuple], parent: Optional["_HostNode"],
                 depth: int):
        self.key = key
        self.parent = parent
        self.children: Dict[tuple, "_HostNode"] = {}
        self.ref = 0
        self.last_access = 0
        self.depth = depth
        self.data: Optional[Dict[str, Any]] = None
        self.nbytes = 0


class HostTierCache:
    """Byte-budgeted host-memory tier under the device radix index (module
    docstring).

    Args:
      block_size: tokens per block — must match the device index's.
      byte_budget: resident-payload cap; the LRU sheds beyond it.
      min_chain_blocks: see :class:`HostTierConfig`.
      leaf_spec: ``{leaf_key: (shape, dtype)}`` of one block's payload
        per KV leaf (the dtype is compared with ``==`` to each payload's
        ``.dtype``: a torch dtype for the engine's tensors) — the engine
        derives it from its pool tree, and :meth:`store` validates every
        payload against it, so a malformed payload is refused here
        instead of corrupting a later promotion.
    """

    def __init__(self, block_size: int, byte_budget: int, *,
                 min_chain_blocks: int = 1,
                 leaf_spec: Optional[Dict[str, Tuple[tuple, object]]]
                 = None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if byte_budget < 1:
            raise ValueError(
                f"byte_budget must be >= 1 (0 disables the tier at the "
                f"engine, not here), got {byte_budget}")
        self.block_size = int(block_size)
        self.byte_budget = int(byte_budget)
        self.min_chain_blocks = int(min_chain_blocks)
        self.leaf_spec = dict(leaf_spec) if leaf_spec is not None else None
        self._root = _HostNode(None, None, 0)
        self._now = 0
        self.bytes_resident = 0
        self.blocks_resident = 0
        self.spills = 0      # blocks that entered the tier (ever)
        self.evictions = 0   # blocks the byte budget hard-freed
        self.pins_outstanding = 0  # live pin_chain/pin acquisitions

    # ------------------------------------------------------------ clock
    def _tick(self) -> int:
        self._now += 1
        return self._now

    # ------------------------------------------------------------ policy
    def spill_worthy(self, depth_blocks: int) -> bool:
        """The demotion policy's length score (recency is implicit:
        LRU eviction order carries into the tier's own LRU, so colder
        chains are shed first without a second knob)."""
        return depth_blocks >= self.min_chain_blocks

    # ------------------------------------------------------------- walk
    def _descend(self, tokens: Sequence[int], blocks: int,
                 create: bool) -> Optional[_HostNode]:
        """Walk (optionally creating structural nodes) ``blocks`` levels
        along ``tokens``; None when a level is missing and ``create``
        is off."""
        node = self._root
        bs = self.block_size
        for j in range(blocks):
            key = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            if len(key) != bs:
                return None
            child = node.children.get(key)
            if child is None:
                if not create:
                    return None
                child = _HostNode(key, node, j + 1)
                node.children[key] = child
            node = child
        return node

    def has_block(self, tokens: Sequence[int]) -> bool:
        """True when the tier already holds the payload of the chain's
        DEEPEST block (``len(tokens)`` must be a block multiple) — the
        engine's demotion hook checks this before paying a D2H gather
        for a block the tier kept across a promotion."""
        node = self._descend(tokens, len(tokens) // self.block_size,
                             create=False)
        return node is not None and node.data is not None

    # ------------------------------------------------------------- store
    def store(self, tokens: Sequence[int], data: Dict[str, Any]) -> bool:
        """Attach one demoted block's payload at the chain's deepest
        node (structural ancestors created as needed), LRU-evicting
        unpinned payloads past the byte budget. Returns False — and
        stores nothing — when the node is already populated, the
        payload fails the ``leaf_spec`` validation, or the budget
        cannot fit it even empty (demotion is opportunistic: a refused
        spill degrades to the old free-and-recompute path, never to an
        error)."""
        blocks = len(tokens) // self.block_size
        if blocks < 1 or len(tokens) % self.block_size != 0:
            return False
        if self.leaf_spec is not None:
            if set(data) != set(self.leaf_spec):
                return False
            for key, arr in data.items():
                shape, dtype = self.leaf_spec[key]
                if tuple(arr.shape) != tuple(shape) or arr.dtype != dtype:
                    return False
        nbytes = sum(int(arr.nbytes) for arr in data.values())
        if nbytes > self.byte_budget:
            return False
        existing = self._descend(tokens, blocks, create=False)
        if existing is not None and existing.data is not None:
            existing.last_access = self._tick()
            return False
        if self.bytes_resident + nbytes > self.byte_budget:
            self._evict_bytes(self.bytes_resident + nbytes
                              - self.byte_budget)
            if self.bytes_resident + nbytes > self.byte_budget:
                return False  # everything else is pinned
        # Create the target AFTER the eviction pass: ``_evict_bytes``
        # prunes empty structural nodes, so a node created first could
        # be deleted out of the tree mid-store (demotion is leaf-first,
        # so at a full budget the LRU victim is exactly the incoming
        # block's own descendant) — the payload would then attach to a
        # detached node: unreachable, unevictable, budget leaked.
        node = self._descend(tokens, blocks, create=True)
        node.data = dict(data)
        node.nbytes = nbytes
        node.last_access = self._tick()
        self.bytes_resident += nbytes
        self.blocks_resident += 1
        self.spills += 1
        return True

    def _evict_bytes(self, need: int) -> None:
        """Hard-free unpinned payloads, least recently used first,
        until ``need`` bytes are recovered or everything left is
        pinned. Data-less leaves prune so the structural skeleton
        cannot outgrow the payloads it once carried."""
        victims: List[_HostNode] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.data is not None and node.ref == 0:
                victims.append(node)
        victims.sort(key=lambda v: v.last_access)
        for victim in victims:
            if need <= 0:
                break
            need -= victim.nbytes
            self.bytes_resident -= victim.nbytes
            self.blocks_resident -= 1
            self.evictions += 1
            victim.data = None
            victim.nbytes = 0
            self._prune(victim)

    def _prune(self, node: _HostNode) -> None:
        while (node is not self._root and node.data is None
               and not node.children and node.ref == 0):
            parent = node.parent
            del parent.children[node.key]
            node = parent

    # ------------------------------------------------------------- match
    def match_from(self, tokens: Sequence[int], start_block: int,
                   max_blocks: int) -> Optional[_HostNode]:
        """Deepest node reachable from depth ``start_block`` through
        consecutive DATA-bearing children (at most ``max_blocks`` of
        them), refreshing LRU stamps; None on a miss. Depths up to
        ``start_block`` need only exist structurally — those blocks are
        the device match the promotion extends."""
        if max_blocks < 1:
            return None
        anchor = self._descend(tokens, start_block, create=False)
        if anchor is None:
            return None
        now = self._tick()
        bs = self.block_size
        node, depth = anchor, start_block
        while depth - start_block < max_blocks:
            key = tuple(int(t) for t in tokens[depth * bs:
                                               (depth + 1) * bs])
            if len(key) != bs:
                break
            child = node.children.get(key)
            if child is None or child.data is None:
                break
            node = child
            node.last_access = now
            depth += 1
        return node if depth > start_block else None

    def match_depth(self, tokens: Sequence[int], start_block: int,
                    max_blocks: int) -> int:
        """Promotable block count (the scheduler cost estimator's view
        — no pin, no stamp mutation beyond the LRU refresh)."""
        node = self.match_from(tokens, start_block, max_blocks)
        return 0 if node is None else node.depth - start_block

    # --------------------------------------------------------- refcounts
    def pin_chain(self, tokens: Sequence[int], start_block: int,
                  max_blocks: int) -> Optional[_HostNode]:
        """Match AND pin in one step — THE host-tier acquire: the returned
        tip (``.depth`` tells the caller how far it reaches) must be
        :meth:`unpin`-ed exactly once on every path out of the
        promotion, fault-unwind included. None acquires nothing."""
        node = self.match_from(tokens, start_block, max_blocks)
        if node is not None:
            self.pin(node)
        return node

    def pin(self, node: _HostNode) -> None:
        """Protect ``node`` and its root path from the byte budget's
        eviction (one live user, radix-style)."""
        self.pins_outstanding += 1
        while node is not self._root:
            node.ref += 1
            node = node.parent

    def unpin(self, node: _HostNode) -> None:
        self.pins_outstanding -= 1
        while node is not self._root:
            if node.ref <= 0:
                raise RuntimeError(
                    "host-tier unpin without a matching pin (refcount "
                    "underflow) — a promotion released its chain twice")
            node.ref -= 1
            node = node.parent

    # --------------------------------------------------------- payloads
    def chain_data(self, tip: _HostNode,
                   n_blocks: int) -> List[Dict[str, Any]]:
        """Payloads of the ``n_blocks`` deepest blocks ending at
        ``tip``, root-first — what the promotion scatters H2D. Raises
        if any of them is structural (callers hold the pin from
        :meth:`pin_chain`, whose match guaranteed contiguous data)."""
        out: List[Dict[str, Any]] = []
        node = tip
        for _ in range(n_blocks):
            if node is None or node.data is None:
                raise RuntimeError(
                    "host-tier chain lost a payload under a pin "
                    "(tier bug)")
            out.append(node.data)
            node = node.parent
        out.reverse()
        return out
