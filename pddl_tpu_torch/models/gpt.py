"""Sampling and serving hooks shared by the decoder families, and the
fused LM loss (subset of :mod:`pddl_tpu.models.gpt`, in PyTorch).

The JAX package keeps the decode cache in a flax collection and stamps
the engine-owned per-slot positions and block tables into it
(``set_cache_positions`` / ``set_cache_block_tables``). Here the cache
is an explicit object — per-layer K/V pools
(``serve/kvcache/block_pool.paged_decode_cache``) — and the positions and
tables are ARGUMENTS of the model's forward, named by the registry
constants below.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pddl_tpu_torch.ops.large_vocab import chunked_cross_entropy

# The names of the engine-owned per-slot state a paged forward takes:
# position counters (``cache_index``; GPT's embed calls its ``pos_index``)
# and the block table. In the JAX package they are cache-tree leaves; in
# the port they are the keyword arguments of the model's forward, and the
# cache tree holds K/V pools only.
CACHE_INDEX_KEYS = frozenset({"pos_index", "cache_index"})
BLOCK_TABLE_KEY = "block_table"


def filtered_logits(logits: torch.Tensor, *, temperature: float,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature warp + top-k + nucleus filter WITHOUT the draw: f32
    logits whose softmax is the exact sampling distribution."""
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p is not None:
        sort_idx = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = logits.gather(-1, sort_idx)
        cdf = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Smallest set whose mass >= top_p: keep entries whose CDF
        # *before* them is < top_p (the first token is always kept); the
        # stable sort resolves boundary ties toward lower vocab ids.
        keep_sorted = torch.cat(
            [torch.zeros_like(cdf[..., :1]), cdf[..., :-1]], dim=-1) < top_p
        keep = keep_sorted.gather(-1, torch.argsort(sort_idx, dim=-1))
        logits = torch.where(keep, logits, -torch.inf)
    return logits


def batched_filtered_logits(logits: torch.Tensor, *, temperature, top_k,
                            top_p) -> torch.Tensor:
    """Per-ROW warp + filter with the sampling parameters as ``[B]``
    arrays (the serving engine's per-slot path). Sentinels: ``top_k <= 0``
    disables top-k for that row, ``top_p >= 1`` disables nucleus;
    ``temperature <= 0`` rows are warped at 1.0 to stay finite (greedy
    selection for them happens in :func:`sample_logits_batched`)."""
    logits = logits.float()
    b, v = logits.shape
    dev = logits.device
    t = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(b)
    kk = torch.as_tensor(top_k, dtype=torch.long, device=dev).expand(b)
    pp = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(b)
    warped = logits / torch.where(t > 0, t, 1.0)[:, None]
    sort_idx = torch.argsort(-warped, dim=-1, stable=True)
    sorted_l = warped.gather(-1, sort_idx)
    # Top-k: the per-row k-th sorted value is the threshold (ties at the
    # boundary kept).
    kth = sorted_l.gather(-1, (kk.clamp(1, v) - 1)[:, None])
    keep_topk = (kk[:, None] <= 0) | (warped >= kth)
    warped = torch.where(keep_topk, warped, -torch.inf)
    # Nucleus over the top-k-masked values: masked entries are the tail
    # of the descending order, so the one sort stays valid.
    sorted_m = torch.where(keep_topk.gather(-1, sort_idx), sorted_l,
                           -torch.inf)
    cdf = torch.cumsum(torch.softmax(sorted_m, dim=-1), dim=-1)
    keep_sorted = torch.cat(
        [torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], dim=-1) < pp[:, None]
    keep = (keep_sorted.gather(-1, torch.argsort(sort_idx, dim=-1))
            | (pp[:, None] >= 1.0))
    return torch.where(keep, warped, -torch.inf)


def sample_logits_batched(generator: torch.Generator, logits: torch.Tensor,
                          *, temperature, top_k, top_p) -> torch.Tensor:
    """One sampling step over ``[B, V]`` logits with per-row parameters
    (sentinels as in :func:`batched_filtered_logits`). Rows with
    ``temperature <= 0`` take the greedy argmax of the raw logits; the
    rest draw from their filtered distribution by the Gumbel-max trick
    with noise from ``generator``. When no row samples, nothing is
    drawn. Returns int32 ``[B]``."""
    logits = logits.float()
    b = logits.shape[0]
    t = torch.as_tensor(temperature, dtype=torch.float32).expand(b)
    greedy = logits.argmax(dim=-1)
    if not bool((t > 0).any()):
        return greedy.to(torch.int32)
    filt = batched_filtered_logits(logits, temperature=temperature,
                                   top_k=top_k, top_p=top_p)
    u = torch.rand(filt.shape, generator=generator, device=logits.device)
    sampled = (filt - torch.log(-torch.log(u))).argmax(dim=-1)
    return torch.where(t.to(logits.device) > 0, sampled,
                       greedy).to(torch.int32)


def prefill_row_from(model, tokens: torch.Tensor, length: int, cache: dict,
                     start: int, block_table: torch.Tensor
                     ) -> Tuple[dict, torch.Tensor]:
    """Chunked prefill CONTINUING a row's paged cache: the admission
    building block.

    The row already holds ``start`` valid tokens of K/V in the pool
    blocks its ``block_table [1, T]`` names (a pinned shared-prefix
    chain, earlier chunks); ``tokens`` is int ``[1, C]`` RIGHT-padded and
    ``length <= C`` its true token count. The chunk's tokens take global
    positions ``start .. start+C-1``, so the caller keeps
    ``start + C <= model.max_len``. Padding junk is harmless: causal
    masking hides it from positions ``< start + length``, its K/V lands
    beyond the position counter the caller stamps (or in the scratch
    block, past the table), and decode overwrites it before the counter
    crosses.

    Returns ``(cache, last_logits [1, V])`` — the cache is written in
    place; the logits row is the one at ``length - 1`` (only the final
    chunk's logits are meaningful to sample from).
    """
    feats = model(tokens, cache=cache, cache_index=int(start),
                  block_table=block_table, features_only=True)
    return cache, model.head_logits(feats[:, length - 1])


def fused_lm_loss(model, tokens: torch.Tensor, targets: torch.Tensor, *,
                  train: bool = True,
                  chunk_size: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy without materializing the ``[B, S, V]``
    logits: the model's ``features_only`` output goes straight into
    :func:`pddl_tpu_torch.ops.large_vocab.chunked_cross_entropy`, which
    saves only per-token logsumexp rows for the backward and recomputes
    chunk logits there.

    The head weight is ``model.head.lm_head.weight[:V]`` (the real columns
    of a padded head), transposed to the JAX package's ``[E, V]`` kernel
    and cast to the compute type as the materialized head casts it; a
    bias, where the head has one, stays f32. ``chunk_size=None`` walks the
    whole unpadded vocab in one step (fastest: one transient
    ``[tokens, V]`` f32 chunk); a smaller chunk is the memory valve for
    long context or a large vocabulary. ``train`` is forwarded to the
    model. The model (a :class:`~pddl_tpu_torch.models.llama.Llama`)
    takes the place of the JAX function's ``model`` and ``variables``.
    """
    feats = model(tokens, train=train, features_only=True)
    head = model.head.lm_head
    v = model.vocab_size
    kernel = head.weight[:v].t().to(model.dtype)
    bias = None if head.bias is None else head.bias[:v].float()
    return chunked_cross_entropy(
        feats, kernel, targets, bias,
        chunk_size=chunk_size if chunk_size is not None else v)
