"""Paged KV cache for the serving engine: the device block pool
(``block_pool.py``) and the host-side radix index over it (``radix.py``)."""

from pddl_tpu_torch.serve.kvcache.block_pool import (
    SCRATCH_BLOCK,
    paged_decode_cache,
    pool_nbytes,
)
from pddl_tpu_torch.serve.kvcache.radix import PrefixMatch, RadixPrefixCache

__all__ = ["SCRATCH_BLOCK", "PrefixMatch", "RadixPrefixCache",
           "paged_decode_cache", "pool_nbytes"]
