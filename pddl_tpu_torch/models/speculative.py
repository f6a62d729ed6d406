"""Speculative decoding by prompt-lookup drafting (the port of
:mod:`pddl_tpu.models.speculative`).

An eager decode step on the card is bound by the host: the ~700 ops of
one forward cost the same whether they carry one token or eight. A verify
window of ``draft_len + 1`` tokens runs those ops once, so every accepted
draft is a token that costs almost no host time.

Scheme (no draft model):

1. DRAFT (:func:`ngram_drafts`): find the most recent earlier occurrence
   of the last ``ngram`` tokens and propose the ``draft_len`` tokens that
   followed it (the last token repeated when there is none).
2. VERIFY: one forward over ``[current, d_1..d_k]`` through the row KV
   cache at the running index (the multi-token path chunked prefill
   uses), and ``y_j = argmax(logits_j)`` at every position.
3. ACCEPT the longest prefix with ``d_{j+1} == y_j`` (``m`` drafts, the
   minimum over the batch, whose rows share one index), emit
   ``y_0..y_m`` and move the host-owned index to the position after the
   last accepted token. Rejected positions keep stale K/V past the index;
   the prefix-bounded sweep never reads it and the next window overwrites
   it before the index gets there.

Every emitted token is the argmax of the model given the true prefix, so
greedy output equals :func:`~pddl_tpu_torch.models.gpt.generate`'s. The
verify window and the one-token step are different computations, so at a
near-tie (untrained weights, bf16) the two argmaxes may break differently;
both are then valid greedy decodes. ``temperature > 0`` switches to
speculative SAMPLING (the rejection scheme of :func:`_spec_sample`), which
draws every token from the distribution ``sample_logits`` draws from.

A sliding-window model whose decode needs a ring cache is refused: a
partly rejected window has already overwritten ring slots that the
rewound position still needs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from pddl_tpu_torch.models.gpt import (
    _last_logits,
    decode_cache,
    filtered_logits,
    load_variables,
    sample_logits,
    sharded_model,
)

__all__ = ["generate_speculative", "ngram_drafts"]


def ngram_drafts(toks: torch.Tensor, cur_pos, ngram: int,
                 draft_len: int) -> torch.Tensor:
    """Prompt-lookup draft: ``[B, draft_len]`` continuations of the most
    recent earlier occurrence of each row's trailing ``ngram``.

    ``toks`` is the token buffer ``[B, L]`` (prompt and emitted tokens;
    positions past ``cur_pos`` hold junk) and ``cur_pos`` the position of
    the last known token: an int (the one-shot loop, whose rows share one
    index) or a per-row ``[B]`` tensor or array (the serving engine's
    slots). The one drafter definition: :func:`generate_speculative` and
    the serving engine both call it. A slice start outside the buffer
    moves into it as ``lax.dynamic_slice`` moves it (a negative start
    counts from the end, then the start is clamped): such a start gives
    junk drafts, which verification rejects, never an index error. Returns
    ``toks``' dtype on its device.
    """
    b, length = toks.shape
    dev = toks.device
    n_win = length - ngram + 1
    if isinstance(cur_pos, int):
        # A shared position stays on the host: no copy to the device.
        qs = cur_pos - (ngram - 1)
        qs = min(max(qs + length if qs < 0 else qs, 0), length - ngram)
        query = toks[:, qs:qs + ngram]
        last_start = cur_pos - ngram
    else:
        pos = torch.as_tensor(cur_pos, device=dev).long().reshape(-1)
        pos = pos.expand(b)
        qs = pos - (ngram - 1)
        qs = torch.where(qs < 0, qs + length, qs).clamp(0, length - ngram)
        query = toks.gather(1, qs[:, None] + torch.arange(ngram, device=dev))
        last_start = (pos - ngram)[:, None]
    # hit[b, w]: the window starting at w equals the row's query.
    hit = toks[:, :n_win] == query[:, :1]
    for i in range(1, ngram):
        hit &= toks[:, i:i + n_win] == query[:, i:i + 1]
    # A usable window ends strictly before cur_pos (the window ending AT
    # cur_pos is the query itself).
    starts = torch.arange(n_win, device=dev)
    best = torch.where(hit & (starts[None, :] <= last_start), starts,
                       -1).amax(dim=1)
    found = best >= 0
    take = torch.where(found, best + ngram, 0).clamp(0, length - draft_len)
    drafts = toks.gather(1, take[:, None]
                         + torch.arange(draft_len, device=dev))
    # No match: the last token repeated (free, and sometimes right on
    # run-length text).
    return torch.where(found[:, None], drafts,
                       query[:, -1:].expand(b, draft_len))


def _spec_sample(generator, logits, block, drafts, *, temperature, top_k,
                 top_p):
    """Speculative sampling over one verify window: ``logits [B, W, V]``
    at the window ``block [B, W]`` whose drafts are ``drafts [B, W-1]``.

    Draft ``d_{j+1}`` is accepted with probability ``p_j(d_{j+1})`` under
    the filtered distribution (a point-mass draft). ``accepted`` is the
    minimum over rows of each row's accepted run (one host sync). A row
    whose own coin rejected at ``accepted`` draws the residual there: ``p``
    with the rejected draft masked, or ``p`` itself where the draft held
    all the mass; a row whose every draft survived draws the bonus token
    from ``p``; a row cut short by the minimum keeps its accepted draft.
    Returns ``(window [B, W] int32, accepted)``."""
    b, width, vocab = logits.shape
    draft_len = width - 1
    flog = filtered_logits(logits, temperature=temperature, top_k=top_k,
                           top_p=top_p)
    probs = torch.softmax(flog, dim=-1)
    p_draft = probs[:, :-1].gather(-1, drafts.long()[..., None])[..., 0]
    coins = torch.rand(p_draft.shape, generator=generator,
                       device=logits.device)
    m_row = (coins < p_draft).int().cumprod(dim=1).sum(dim=1)
    accepted = int(m_row.min())  # the tick's one host sync
    flog_last = flog[:, accepted]
    d_next = block[:, min(accepted + 1, draft_len)].long()
    rejected_here = (m_row == accepted) & (accepted < draft_len)
    mask = rejected_here[:, None] & F.one_hot(d_next, vocab).bool()
    masked = torch.where(mask, -torch.inf, flog_last)
    has_mass = (masked > -torch.inf).any(dim=-1, keepdim=True)
    masked = torch.where(has_mass, masked, flog_last)
    u = torch.rand(masked.shape, generator=generator, device=logits.device)
    fix = (masked - torch.log(-torch.log(u))).argmax(dim=-1).int()
    window = torch.cat([drafts, drafts[:, -1:]], dim=1).int()
    window[:, accepted] = torch.where(m_row == accepted, fix,
                                      window[:, accepted])
    return window, accepted


@torch.no_grad()
def generate_speculative(model, prompt, max_new_tokens: int, *,
                         temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         generator: Optional[torch.Generator] = None,
                         draft_len: int = 7, ngram: int = 3,
                         return_stats: bool = False, strategy=None,
                         variables=None, param_transform=None):
    """Speculative generation: equal to ``generate()`` under greedy, its
    distribution under sampling, in fewer forwards (module docstring).

    Args:
      model: a port Llama or GPT with a full-length KV cache; it decodes
        on its own device.
      prompt: int ``[B, P]``, ``P >= 1`` (a tensor or an array).
      max_new_tokens: tokens to append (exactly, as ``generate``).
      temperature / top_k / top_p / generator: ``generate()``'s sampling
        surface; ``generator`` (a ``torch.Generator`` on the model's
        device) takes the JAX ``rng`` key's place. Under sampling the
        draws differ from ``generate``'s: compare distributions.
      draft_len: drafted tokens per tick (the window is ``draft_len + 1``
        wide).
      ngram: the lookup key's length.
      return_stats: also return ``{"ticks", "emitted",
        "tokens_per_tick"}``, counting delivered tokens only.
      strategy: a :class:`~pddl_tpu_torch.parallel.TensorParallelStrategy`
        runs the prefill and every verify forward sharded, as
        ``generate``'s (:func:`~pddl_tpu_torch.models.gpt.sharded_model`).
      variables / param_transform: as ``generate``'s
        (:func:`~pddl_tpu_torch.models.gpt.load_variables`): int8 weights
        with ``param_transform=dequantize``.

    Returns int32 ``[B, P + max_new_tokens]`` on the model's device, or
    ``(tokens, stats)``. The prompt and the token buffer stay on the
    device; each tick's one host sync is its accepted length.
    """
    model = sharded_model(load_variables(model, variables, param_transform),
                          strategy, param_transform)
    dev = model.device
    prompt = torch.as_tensor(prompt).to(dev, torch.int32)
    b, p = prompt.shape
    total = p + max_new_tokens
    if p < 1:
        raise ValueError("generate_speculative() needs a non-empty prompt")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs an rng key (a "
                         "torch.Generator as generator=)")
    if temperature <= 0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p require temperature > 0 (greedy decoding would "
            "silently ignore them)")
    # Cache writes reach draft_len past the last emitted position.
    if total + draft_len > model.max_len:
        raise ValueError(
            f"prompt + new tokens + draft_len {total + draft_len} exceed "
            f"max_len {model.max_len} (speculative blocks write "
            f"draft_len={draft_len} positions of lookahead)")
    if getattr(model, "uses_ring_cache", False):
        raise NotImplementedError(
            "speculative decoding needs a full-length KV cache; "
            f"sliding_window={model.sliding_window} uses a ring cache "
            "whose slots cannot be rewound")
    sampling = temperature > 0
    width = draft_len + 1
    cache = decode_cache(model, b)
    last = _last_logits(model, prompt, p, cache=cache, cache_index=0)
    toks = torch.zeros((b, model.max_len + width), dtype=torch.int32,
                       device=dev)
    toks[:, :p] = prompt
    toks[:, p] = sample_logits(generator, last, temperature=temperature,
                               top_k=top_k, top_p=top_p).to(torch.int32)
    n_out, ticks = 1, 0
    while n_out < max_new_tokens:
        cur_pos = p + n_out - 1  # the last known token's position
        drafts = ngram_drafts(toks, cur_pos, ngram, draft_len)
        block = torch.cat([toks[:, cur_pos:cur_pos + 1], drafts], dim=1)
        logits = model(block, cache=cache, cache_index=cur_pos)
        if sampling:
            window, accepted = _spec_sample(
                generator, logits, block, drafts, temperature=temperature,
                top_k=top_k, top_p=top_p)
        else:
            window = logits.argmax(dim=-1).to(torch.int32)
            match = (block[:, 1:] == window[:, :-1]).int()
            # The tick's one host sync: the batch's accepted length.
            accepted = int(match.cumprod(dim=1).sum(dim=1).min())
        toks[:, p + n_out:p + n_out + width] = window
        n_out += accepted + 1
        ticks += 1
    out = toks[:, :total]
    if not return_stats:
        return out
    emitted = min(n_out, max_new_tokens)
    return out, {"ticks": ticks, "emitted": emitted,
                 "tokens_per_tick": emitted / max(ticks, 1)}
