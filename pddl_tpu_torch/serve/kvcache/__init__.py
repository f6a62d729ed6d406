"""KV cache for the serving engine: the device block pool
(``block_pool.py``), the host-side radix index over it (``radix.py``) and
the host-RAM spill tier under both (``hosttier.py``)."""

from pddl_tpu_torch.serve.kvcache.block_pool import (
    SCRATCH_BLOCK,
    donate_prefix_blocks,
    gather_prefix_into_row,
    kv_block_pool,
    kv_leaf_items,
    paged_decode_cache,
    pool_nbytes,
)
from pddl_tpu_torch.serve.kvcache.hosttier import (
    HostTierCache,
    HostTierConfig,
)
from pddl_tpu_torch.serve.kvcache.radix import PrefixMatch, RadixPrefixCache

__all__ = ["SCRATCH_BLOCK", "HostTierCache", "HostTierConfig",
           "PrefixMatch", "RadixPrefixCache",
           "donate_prefix_blocks", "gather_prefix_into_row", "kv_block_pool",
           "kv_leaf_items",
           "paged_decode_cache", "pool_nbytes"]
