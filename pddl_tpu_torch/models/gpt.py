"""The GPT family, and the sampling, KV-cache decoding, serving hooks and
fused LM loss shared by the decoder families (the port of
:mod:`pddl_tpu.models.gpt`, in PyTorch).

:class:`GPT` is the decoder-only LM of the JAX package: token and learned
position embeddings, causal :class:`~pddl_tpu_torch.models.vit.TransformerBlock`
(MHA: ``num_kv_heads == num_heads``), a final LayerNorm and a biased LM
head over the ``vocab_multiple``-padded vocabulary, sliced back to
``vocab_size`` before the f32 cast. Its forward takes the decode keywords
of the port's Llama (``cache``, ``cache_index`` — the JAX embed's
``pos_index`` —, ``block_table``, ``max_index``), so ``generate``, the
speculative paths and both serving engines drive either family. A
per-row (``[B]``) position past ``max_len`` — a verify window at the
cache's end — reads the last position's embedding: the JAX ``jnp.take``
fills such rows with NaN, which torch's indexing cannot do (it raises on
the CPU and asserts on the card). Those rows' K/V drop past a row cache
and land in the scratch block of a paged pool, both behind every live
position, and their logits are never sampled.

The JAX package keeps the decode cache in a flax collection and stamps
the engine-owned per-slot positions and block tables into it
(``set_cache_positions`` / ``set_cache_block_tables``). Here the cache
is an explicit tree of K/V tensors — row caches (:func:`decode_cache`)
or per-layer pools (``serve/kvcache/block_pool.paged_decode_cache``) —
written in place by the forward, and the positions and tables are
ARGUMENTS of the model's forward, named by the registry constants below.

:func:`generate` is the JAX package's first serving entry point: one
batched prefill of the whole prompt, then one single-token forward per
new token. The JAX function runs its decode as one compiled
``lax.scan``; here it is a host loop with no host sync per token (the
sampled token stays on the device and feeds the next step).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pddl_tpu_torch.core.collectives import copy_to_group, gather_from_group
from pddl_tpu_torch.device import resolve_device
from pddl_tpu_torch.models.layers import (
    LayerNorm,
    SeqShard,
    check_attention,
    linear,
    vocab_embed,
)
from pddl_tpu_torch.models.gpipe import GPipeModel
from pddl_tpu_torch.models.llama import ring_len
from pddl_tpu_torch.models.vit import (
    TransformerBlock,
    _ViTStage,
    draw_transformer_weights,
    init_transformer_weights,
    moe_of,
    remat_block,
)
from pddl_tpu_torch.ops.attention import cache_slot_insert, host_index
from pddl_tpu_torch.ops.large_vocab import chunked_cross_entropy
from pddl_tpu_torch.ops.quant import with_params

# The names of the engine-owned per-slot state a paged forward takes:
# position counters (``cache_index``; GPT's embed calls its ``pos_index``)
# and the block table. In the JAX package they are cache-tree leaves; in
# the port they are the keyword arguments of the model's forward, and the
# cache tree holds K/V pools only.
CACHE_INDEX_KEYS = frozenset({"pos_index", "cache_index"})
BLOCK_TABLE_KEY = "block_table"


def _padded(vocab_size: int, vocab_multiple: int) -> int:
    return -(-vocab_size // vocab_multiple) * vocab_multiple


class _GPTEmbed(nn.Module):
    """Token + learned position embedding, in the compute dtype."""

    def __init__(self, vocab_size: int, max_len: int, embed_dim: int,
                 vocab_multiple: int, dtype, param_dtype, device):
        super().__init__()
        self.max_len = max_len
        self.dtype = dtype
        self.token_embed = nn.Embedding(_padded(vocab_size, vocab_multiple),
                                        embed_dim, dtype=param_dtype,
                                        device=device)
        # Vocabulary-parallel once bound: this process's first row.
        self.vocab_group = None
        self.vocab_offset = 0
        self.pos_embed = nn.Parameter(torch.zeros(
            1, max_len, embed_dim, dtype=param_dtype, device=device))

    def forward(self, tokens: torch.Tensor,
                index: Union[int, torch.Tensor, None] = None,
                seq: Optional[SeqShard] = None) -> torch.Tensor:
        """``seq`` of ``n`` above 1: ``tokens`` are this process's slice
        of the sequence, at global positions ``my·s + arange(s)``."""
        s = tokens.shape[1]
        if seq is not None and seq.n > 1:
            index = seq.offset(s)
            if seq.n * s > self.max_len:
                raise ValueError(f"sequence {seq.n * s} exceeds max_len "
                                 f"{self.max_len}")
        if s > self.max_len:
            raise ValueError(f"sequence {s} exceeds max_len {self.max_len}")
        x = vocab_embed(self.token_embed, tokens, self.vocab_group,
                        self.vocab_offset)
        if isinstance(index, torch.Tensor) and index.ndim:
            # Per-row positions; past max_len, clamped (module docstring).
            pos = index[:, None] + torch.arange(s, device=tokens.device)
            step = self.pos_embed[0][pos.clamp(max=self.max_len - 1)]
        else:
            i = 0 if index is None else host_index(index)
            if i + s > self.max_len:
                raise ValueError(
                    f"a {s}-token block at position {i} runs past max_len "
                    f"{self.max_len}")
            step = self.pos_embed.narrow(1, i, s)
        return x.to(self.dtype) + step.to(self.dtype)


class _GPTHead(nn.Module):
    """Final LayerNorm + biased LM head; the padded vocabulary is sliced
    off and logits come back in f32."""

    def __init__(self, vocab_size: int, embed_dim: int, vocab_multiple: int,
                 ln_eps: float, dtype, param_dtype, device):
        super().__init__()
        self.vocab_size = vocab_size
        self.dtype = dtype
        self.ln_final = LayerNorm(embed_dim, ln_eps, param_dtype, device)
        self.lm_head = linear(embed_dim, _padded(vocab_size, vocab_multiple),
                              bias=True, dtype=dtype, param_dtype=param_dtype,
                              device=device)
        self.vocab_group = None  # vocabulary-parallel once bound

    def features(self, x):
        return self.ln_final(x).to(self.dtype)

    def forward(self, x):
        """Features then logits (the head after a pipeline)."""
        return self.logits(self.features(x))

    def logits(self, feats):
        """The product, then the bias in the compute dtype, then the slice
        and the f32 cast, as the JAX ``Dense`` and ``lm_head_logits``."""
        head, dt, g = self.lm_head, self.dtype, self.vocab_group
        out = F.linear(copy_to_group(feats, g).to(dt), head.weight.to(dt))
        out = gather_from_group(out + head.bias.to(dt), g)
        return out[..., :self.vocab_size].float()


class GPT(nn.Module):
    """Decoder-only transformer LM: tokens ``[B, S]`` → f32 logits
    ``[B, S, vocab_size]`` (or post-norm features with
    ``features_only=True``; :meth:`head_logits` finishes them).

    Weights come from :func:`~pddl_tpu_torch.models.vit.init_transformer_weights`
    seeded with ``seed`` on ``device`` (``None`` means ``cuda``; a host
    without a card passes ``device="cpu"``). ``dtype`` is the compute type
    and ``param_dtype`` (default: ``dtype``) the parameters' storage type.
    ``ln_eps`` defaults to flax's 1e-6; HF GPT-2 checkpoints use 1e-5.
    ``moe_experts > 0`` routes every ``moe_every``-th block from the back
    (Switch-MoE, as the ViT). ``attention="ring"``/``"ring_flash"``
    with the port's ``mesh`` attends over its ``seq`` axis; with ``seq``
    above 1 each process is fed its slice of the tokens and adds its
    slice of ``pos_embed`` (global positions), as the Llama does.
    """

    def __init__(self, vocab_size: int, max_len: int = 1024,
                 embed_dim: int = 256, depth: int = 4, num_heads: int = 4,
                 mlp_ratio: int = 4, attention: str = "flash", mesh=None,
                 dropout: float = 0.0, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_every: int = 2,
                 remat: str = "none", vocab_multiple: int = 1,
                 ln_eps: float = 1e-6, dtype=torch.float32,
                 param_dtype=None, device=None, seed: int = 0):
        super().__init__()
        check_attention(attention, mesh, moe_experts=moe_experts)
        device = resolve_device(device)
        param_dtype = param_dtype or dtype
        self.mesh = mesh
        self.seq = SeqShard(mesh)
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = self.num_kv_heads = num_heads
        # The decode cache's heads a process (local under tensor
        # parallelism).
        self.cache_kv_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.sliding_window = None
        self.uses_ring_cache = False
        self.attention = attention
        self.remat = remat
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.stem = _GPTEmbed(vocab_size, max_len, embed_dim, vocab_multiple,
                              dtype, param_dtype, device)
        block_cls = remat_block(TransformerBlock, remat)
        self.blocks = nn.ModuleList(
            block_cls(embed_dim, num_heads, mlp_ratio=mlp_ratio,
                      attention=attention, causal=True, dropout=dropout,
                      moe_experts=moe_of(i, depth, moe_experts, moe_every),
                      moe_top_k=moe_top_k, ln_eps=ln_eps, mesh=mesh,
                      dtype=dtype, param_dtype=param_dtype, device=device)
            for i in range(depth))
        self.head = _GPTHead(vocab_size, embed_dim, vocab_multiple, ln_eps,
                             dtype, param_dtype, device)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        # The final norm's scale: 1-D, so never int8 (``ops/quant.py``).
        return self.head.ln_final.weight.device

    def init_weights(self, seed: int) -> None:
        """Redraw every weight from a generator seeded with ``seed``."""
        init_transformer_weights(self, seed)

    def forward(self, tokens: torch.Tensor, *, train: bool = True,
                cache: Optional[dict] = None,
                cache_index: Union[int, torch.Tensor, None] = None,
                block_table: Optional[torch.Tensor] = None,
                max_index: Optional[int] = None,
                features_only: bool = False) -> torch.Tensor:
        """With no cache, the training forward at positions ``arange(S)``
        (``train`` turns dropout on where ``dropout > 0``); with a cache,
        ``cache_index`` is an int or a ``[B]`` tensor with ``max_index``
        its largest entry as a host int, as in the port's Llama."""
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim:
            cache_index = cache_index.to(tokens.device)  # once, not per layer
        x = self.stem(tokens, cache_index if cache is not None else 0,
                      self.seq if cache is None else None)
        for i, block in enumerate(self.blocks):
            if cache is None:
                x = block(x, train)
            else:
                x = block(x, False, cache=cache[f"block{i}"]["attn"],
                          cache_index=cache_index, block_table=block_table,
                          max_index=max_index)
        feats = self.head.features(x)
        return feats if features_only else self.head.logits(feats)

    def head_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """The LM head over ``features_only`` output: vocab logits, f32."""
        return self.head.logits(feats)


class GPipeGPT(GPipeModel):
    """Pipeline-parallel causal LM: token and position embedding
    (replicated) → ``n_stages`` stages of ``blocks_per_stage`` causal
    transformer blocks through the GPipe schedule → LM head (replicated)
    (``models/gpipe.py``). The JAX constructor's arguments plus
    ``device`` and ``seed``; weights are drawn as the GPT's, each part
    from its own generator (:meth:`GPipeModel.materialize`)."""

    def __init__(self, *, vocab_size: int, n_stages: int,
                 blocks_per_stage: int, n_microbatches: int, mesh,
                 max_len: int = 1024, embed_dim: int = 256,
                 num_heads: int = 4, mlp_ratio: int = 4,
                 attention: str = "reference", ln_eps: float = 1e-6,
                 dtype=torch.float32, param_dtype=None, device=None,
                 seed: int = 0):
        if attention not in ("flash", "reference"):
            raise ValueError(f"unknown attention {attention!r}")
        device = resolve_device(device)
        param_dtype = param_dtype or dtype
        shell = torch.device("meta")
        super().__init__(
            embed=_GPTEmbed(vocab_size, max_len, embed_dim, 1, dtype,
                            param_dtype, shell),
            stages=[_ViTStage(embed_dim, num_heads, blocks_per_stage,
                              mlp_ratio=mlp_ratio, attention=attention,
                              causal=True, ln_eps=ln_eps, dtype=dtype,
                              param_dtype=param_dtype, device=shell)
                    for _ in range(n_stages)],
            head=_GPTHead(vocab_size, embed_dim, 1, ln_eps, dtype,
                          param_dtype, shell),
            n_stages=n_stages, n_microbatches=n_microbatches, mesh=mesh)
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.attention = attention
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.materialize(device, draw_transformer_weights, seed)


# GPT-2 small (12 x 768, 12 heads).
GPT_Small = functools.partial(GPT, embed_dim=768, depth=12, num_heads=12)


def tiny_gpt(vocab_size: int = 64, **kwargs) -> GPT:
    """Miniature GPT for tests."""
    kwargs.setdefault("max_len", 128)
    kwargs.setdefault("embed_dim", 32)
    kwargs.setdefault("depth", 2)
    kwargs.setdefault("num_heads", 4)
    kwargs.setdefault("attention", "reference")
    return GPT(vocab_size=vocab_size, **kwargs)




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


def sample_logits(generator: Optional[torch.Generator], logits: torch.Tensor,
                  *, temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sampling step over ``[B, V]`` logits: temperature warps first,
    then top-k, then nucleus (:func:`filtered_logits`), then one draw per
    row from ``generator`` (the Gumbel-max trick). ``temperature <= 0`` is
    the greedy argmax and draws nothing. Returns int64 ``[B]``. The draws
    are not the JAX package's (threefry and torch's generators differ):
    only greedy streams compare token for token. ``noise`` is the ``[B,
    V]`` uniform draw in place of ``generator``'s (the decode artifact's
    programs take it as an input, ``ckpt/export.py``)."""
    if top_k is not None and int(top_k) < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    logits = logits.float()
    if temperature <= 0:
        return logits.argmax(dim=-1)
    filt = filtered_logits(logits, temperature=temperature, top_k=top_k,
                           top_p=top_p)
    u = noise if noise is not None else torch.rand(
        filt.shape, generator=generator, device=logits.device)
    return (filt - torch.log(-torch.log(u))).argmax(dim=-1)


def decode_cache(model, batch: int) -> dict:
    """A zero ROW decode cache for ``model`` at ``batch`` rows (the port of
    ``_decode_cache_shapes``, materialized): per layer
    ``{"cached_key", "cached_value"}`` of ``[batch, H_kv, L, D]`` in the
    model's dtype on its device, ``L`` the ring length
    (:func:`~pddl_tpu_torch.models.llama.ring_len`) or ``max_len``. The
    JAX tree's position counters are the forward's ``cache_index``."""
    length = ring_len(model.sliding_window, model.max_len) or model.max_len
    heads = getattr(model, "cache_kv_heads", model.num_kv_heads)
    shape = (batch, heads, length, model.head_dim)

    def _leaf():
        return torch.zeros(shape, dtype=model.dtype, device=model.device)

    return {f"block{i}": {"attn": {"cached_key": _leaf(),
                                   "cached_value": _leaf()}}
            for i in range(model.depth)}


def slot_decode_cache(model, slots: int) -> dict:
    """The serving engine's pooled cache: one row per request slot, each
    slot at its own depth (the forward's ``[slots]`` ``cache_index``)."""
    return decode_cache(model, slots)


def insert_cache_slot(cache: dict, row_cache: dict, slot: int) -> dict:
    """Copy a finished batch-1 prefill (``row_cache``) into slot ``slot``
    of a pooled cache, whole rows, in place (:func:`~pddl_tpu_torch.ops.
    attention.cache_slot_insert`). The JAX function also stamps the
    slot's position counter; the port's engine owns the positions."""
    for blk, leaves in cache.items():
        for name, leaf in leaves["attn"].items():
            cache_slot_insert(leaf, row_cache[blk]["attn"][name], slot)
    return cache


def _last_features(model, tokens, length: int, **cache_kw
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's features at the one position ``length - 1`` and the
    head over them: ``(logits [B, V] f32, features [B, d])``."""
    feats = model(tokens, features_only=True, **cache_kw)[:, length - 1]
    return model.head_logits(feats), feats


def _last_logits(model, tokens, length: int, **cache_kw) -> torch.Tensor:
    """The head over the forward's features at the one position
    ``length - 1``: ``[B, V]`` f32."""
    return _last_features(model, tokens, length, **cache_kw)[0]


def prefill_row(model, prompt: torch.Tensor, length: int
                ) -> Tuple[dict, torch.Tensor]:
    """One request's prefill on a FRESH batch-1 row cache: the serving
    engine's admission with the prefix cache off.

    ``prompt`` is int ``[1, P_pad]`` RIGHT-padded; ``length`` its true
    token count. Padding is harmless: causal attention hides it from
    positions ``< length``, the logits row is taken at ``length - 1``,
    and its K/V lies past the slot's position counter, which decode
    overwrites position by position. Returns ``(row_cache, last_logits
    [1, V])``."""
    cache = decode_cache(model, 1)
    return cache, _last_logits(model, prompt, length, cache=cache,
                               cache_index=0)


def prefill_row_from(model, tokens: torch.Tensor, length: int, cache: dict,
                     start: int, block_table: Optional[torch.Tensor] = None
                     ) -> Tuple[dict, torch.Tensor]:
    """Chunked prefill CONTINUING a batch-1 cache: the prefix-cache
    admission building block.

    The row already holds ``start`` valid tokens of K/V: in the row cache
    ``cache`` (a gathered shared-prefix chain, earlier chunks), or — with
    ``block_table [1, T]`` — in the paged pool blocks it names. ``tokens``
    is int ``[1, C]`` RIGHT-padded and ``length <= C`` its true token
    count. The chunk's tokens take global positions
    ``start .. start+C-1``, so the caller keeps ``start + C <=
    model.max_len`` (the forward raises past a row cache; a paged write
    past the table lands in the scratch block). Padding junk is harmless:
    causal masking hides it from positions ``< start + length``, its K/V
    lands beyond the position counter the caller stamps, and decode
    overwrites it before the counter crosses.

    Returns ``(cache, last_logits [1, V])`` — the cache is written in
    place; the logits row is the one at ``length - 1`` (only the final
    chunk's logits are meaningful to sample from).
    """
    return cache, _last_logits(model, tokens, length, cache=cache,
                               cache_index=int(start),
                               block_table=block_table)


def prefill_row_features(model, tokens: torch.Tensor, length: int,
                         cache: Optional[dict] = None, start: int = 0,
                         block_table: Optional[torch.Tensor] = None
                         ) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """The tenant twin of :func:`prefill_row` / :func:`prefill_row_from`:
    one prefill chunk that ALSO returns the last position's pre-head
    features, so the caller can add a LoRA delta to the sampled logits.
    ``cache=None`` starts a fresh batch-1 row cache (``prefill_row``);
    otherwise the chunk continues ``cache`` at offset ``start``
    (``prefill_row_from``). The logits are the same ops as theirs, so a
    no-adapter admission is bitwise the plain one.

    Returns ``(cache, last_logits [1, V], last_feats [1, d])``."""
    if cache is None:
        cache = decode_cache(model, 1)
    logits, feats = _last_features(model, tokens, length, cache=cache,
                                   cache_index=int(start),
                                   block_table=block_table)
    return cache, logits, feats


def load_variables(model, variables, param_transform=None, *,
                   role: str = "variables"):
    """The JAX entry points' ``variables`` / ``param_transform`` pair,
    applied to the port's model, which carries its weights: ``None``
    returns ``model``; ``{"params": tree}`` returns a copy of ``model``
    holding the tree (the model's ``state_dict`` names; int8 leaves of
    :func:`~pddl_tpu_torch.ops.quant.quantize_int8` stay int8 on the
    device, ``param_transform`` applied at each use) and sharing every
    other tensor with it: ``model`` itself is left as it was
    (:func:`~pddl_tpu_torch.ops.quant.with_params`). A
    ``param_transform`` without variables raises: it transforms them."""
    if variables is None:
        if param_transform is not None:
            raise ValueError(
                f"param_transform transforms {role}; pass them "
                "({'params': tree})")
        return model
    return with_params(model, variables["params"], param_transform,
                       role=role)


def sharded_model(model, strategy, param_transform=None):
    """``model`` under ``strategy`` for decoding: itself with none, else
    the strategy's bound copy (``model`` itself if it is bound already),
    the cache then split by K/V head. ``param_transform`` raises there,
    as in the JAX package: the rules describe the dense layout."""
    if strategy is None:
        return model
    if param_transform is not None:
        raise NotImplementedError(
            "param_transform (int8 serving) is unsharded-only: the "
            "sharding trees below describe the DENSE params layout")
    return strategy.shard_model(model)


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None, strategy=None,
             variables=None, param_transform=None) -> torch.Tensor:
    """Autoregressive sampling with a KV cache (the port of the JAX
    package's ``generate``).

    Args:
      model: a port Llama or GPT; it decodes on its own device. With
        :attr:`~pddl_tpu_torch.models.llama.Llama.uses_ring_cache` its
        cache is the rolling ring of the window, and its prefill runs K1
        with its LSE on the card.
      prompt: int ``[B, P]`` prompt tokens (``P >= 1``; a tensor or an
        array).
      max_new_tokens: tokens to append.
      temperature: 0 → greedy argmax; > 0 → temperature sampling
        (``generator`` required, a ``torch.Generator`` on the model's
        device in place of the JAX ``rng`` key), optionally filtered by
        ``top_k`` and/or nucleus ``top_p`` (:func:`sample_logits`).
      strategy: a :class:`~pddl_tpu_torch.parallel.TensorParallelStrategy`
        decodes sharded (:func:`sharded_model`): each process holds its
        block of the weights by the strategy's rules and its K/V heads of
        the cache, and samples the same tokens from the gathered logits.
      variables / param_transform: the JAX function's weights and their
        transform, for this call only (:func:`load_variables`: ``model``
        keeps its own weights); ``None`` decodes with the model's own.
        ``variables={"params": quantize_int8(model)}`` with
        ``param_transform=dequantize`` decodes from int8 weights.

    Returns int32 ``[B, P + max_new_tokens]`` (prompt + continuation) on
    the model's device. One batched prefill of the whole prompt, then one
    single-token forward per new token but the last (whose logits would
    never be sampled); no step syncs with the host.
    """
    model = sharded_model(load_variables(model, variables, param_transform),
                          strategy, param_transform)
    dev = model.device
    prompt = torch.as_tensor(prompt).to(dev, torch.int32)
    b, p = prompt.shape
    total = p + max_new_tokens
    if p < 1:
        raise ValueError("generate() needs a non-empty prompt (P >= 1)")
    if total > model.max_len:
        raise ValueError(
            f"prompt+new tokens {total} exceed max_len {model.max_len}")
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs an rng key (a "
                         "torch.Generator as generator=)")
    if temperature <= 0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p require temperature > 0 (greedy decoding would "
            "silently ignore them)")
    cache = decode_cache(model, b)
    logits = _last_logits(model, prompt, p, cache=cache, cache_index=0)
    out = [prompt]
    for t in range(max_new_tokens):
        nxt = sample_logits(generator, logits, temperature=temperature,
                            top_k=top_k, top_p=top_p).to(torch.int32)
        out.append(nxt[:, None])
        if t + 1 < max_new_tokens:
            logits = _last_logits(model, nxt[:, None], 1, cache=cache,
                                  cache_index=p + t)
    return torch.cat(out, dim=1)


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
    model. The model (a :class:`~pddl_tpu_torch.models.llama.Llama` or a
    :class:`GPT`, whose head bias joins the chunks in f32) takes the place
    of the JAX function's ``model`` and ``variables``.
    """
    if model.head.vocab_group is not None:
        raise NotImplementedError(
            "fused_lm_loss over a vocabulary-parallel head (tensor "
            "parallelism): train on the materialized logits")
    feats = model(tokens, train=train, features_only=True)
    head = model.head.lm_head
    v = model.vocab_size
    kernel = head.weight[:v].t().to(model.dtype)
    bias = None if head.bias is None else head.bias[:v].float()
    return chunked_cross_entropy(
        feats, kernel, targets, bias,
        chunk_size=chunk_size if chunk_size is not None else v)
