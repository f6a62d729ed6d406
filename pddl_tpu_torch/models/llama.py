"""Llama family in PyTorch: RoPE + RMSNorm + SwiGLU + grouped-query
attention (the port of :mod:`pddl_tpu.models.llama`, dense blocks).

Parameter layout follows torch idiom — ``nn.Linear`` weights are
``[out, in]`` — and :func:`pddl_tpu_torch.bridge.llama_params_from_jax`
maps a flax parameter tree onto it. As in flax's ``Dense``/``Embed``/
``RMSNorm``, parameters are stored in ``param_dtype`` and cast to the
compute ``dtype`` where they are used (training keeps f32 parameters
under bf16 compute); ``param_dtype`` defaults to ``dtype``, the serving
configuration, whose linears are plain ``nn.Linear`` with no cast.
RMSNorm computes in f32 whatever it is.

Three forward modes, chosen by the cache passed:

- no cache: the training-shaped full forward over ``[B, S]`` tokens at
  positions ``arange(S)``, attention through
  :func:`~pddl_tpu_torch.ops.attention.flash_attention` (the default
  ``attention="flash"``: the CUDA flash kernels on the card, with their
  backward under a gradient) or
  :func:`~pddl_tpu_torch.ops.attention.attention_reference`
  (``attention="reference"``);
- a ROW cache (``models/gpt.decode_cache``: ``[B, H_kv, L, D]`` per
  layer, ``L = ring_len(window, max_len) or max_len``) plus
  ``cache_index`` (an int for a batch-wide position, ``[B]`` for the
  serving engine's slots) — ``generate()`` and the resident-row engine.
  Each layer writes its post-RoPE K/V at its positions (``pos % L`` on a
  ring) and attends through
  :func:`~pddl_tpu_torch.ops.attention.decode_attention`. A multi-token
  block on a ring (the chunked prefill of a sliding-window model) attends
  to itself through :func:`~pddl_tpu_torch.ops.attention.flash_attention_lse`
  (K1 with its LSE on the card) and to the PRE-WRITE ring through
  ``decode_attention(history_only=True)``, the two merged in logsumexp
  space;
- a PAGED cache (``serve/kvcache/block_pool.paged_decode_cache``) plus
  the engine-owned ``cache_index`` (an int for a batch-1 prefill chunk,
  ``[B]`` for the decode tick) and ``block_table`` (``[B, T]``): each
  layer writes its post-RoPE K/V into the pool
  (:func:`~pddl_tpu_torch.ops.attention.paged_cache_insert`) and attends
  through the table (:func:`~pddl_tpu_torch.ops.attention.paged_decode_attention`
  — the CUDA kernel for single-token steps on the card).

Keys are cached post-RoPE at their ABSOLUTE positions, so a cached block
is bit-valid for every row that shares its tokens. A per-row (``[B]``
``cache_index``) block drops its positions at or past the cache's end,
as the JAX module's scatter does: a speculative verify window near
``max_len`` writes the positions before the edge and nothing after it.
A block at a shared (int) index that runs past the cache raises, where
the JAX module clamps its start, which would lose tokens.

``remat`` (``"none"``, ``"dots"``, ``"full"``) wraps every block with
:func:`pddl_tpu_torch.models.vit.remat_block`: under a gradient, with no
cache passed, each block's activations are rematerialized in the backward
per the named policy; the decode paths never remat.

A ``sliding_window`` trains and runs the full forward through the
windowed flash kernels, and decodes through the rolling ring cache when
its window, rounded up to 128, is under ``max_len``
(:attr:`Llama.uses_ring_cache`); the serving engine and the paged cache
refuse such a model, as the JAX package does.

Routed experts (Mixtral): ``moe_experts > 0`` makes every
``moe_every``-th block counted from the back a
:class:`~pddl_tpu_torch.ops.moe.SwitchFFN` of ``moe_experts`` SwiGLU
experts (``moe_top_k``, ``moe_capacity_factor``, ``moe_eval_dropless``
at the JAX semantics); the training forward drops over-capacity tokens,
the eval forward (``train=False``) and every cached forward run dropless
by default, as the JAX decode module does.

Tensor parallelism: bound by
:class:`~pddl_tpu_torch.parallel.TensorParallelStrategy` with
``LLAMA_TP_RULES``, each attention runs its local heads (each process's
query heads read its own K/V heads, so the GQA group stays whole), the
SwiGLU ``mlp_gate``/``mlp_up`` are column-parallel and ``mlp_down``
row-parallel, and the embedding and ``lm_head`` vocabulary-parallel
(``models/layers.py``).

Sequence parallelism: ``attention="ring"`` or ``"ring_flash"`` with the
port's ``mesh`` (:func:`pddl_tpu_torch.core.mesh.build_mesh`, a strategy's
``mesh``) attends through
:func:`~pddl_tpu_torch.ops.ring_attention.sequence_parallel_attention`
over its ``seq`` axis (``"ring_flash"``: K1 per rotation, K2/K3 in the
backward, on the card), the window composing with the ring. With ``seq``
above 1 each process holds its ``S/seq`` slice of the sequence through
the whole model: it is fed its slice of the tokens
(``Strategy.distribute_batch``), its RoPE positions are global
(``my·s + arange(s)``) and its logits are its slice's. Not ported yet
(each raises ``NotImplementedError`` naming ROADMAP.md queue 1 item 7):
routed blocks under such a mesh and decoding a model built with a mesh.
:class:`GPipeLlama` (``models/gpipe.py``) is the pipeline-parallel twin.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from pddl_tpu_torch.core.collectives import copy_to_group, gather_from_group
from pddl_tpu_torch.device import resolve_device
from pddl_tpu_torch.models.gpipe import GPipeModel
from pddl_tpu_torch.models.layers import (
    SeqShard,
    attend_full,
    check_attention,
    paged_attend,
    refuse_mesh_decode,
    row_attend,
    row_linear,
    vocab_embed,
)
from pddl_tpu_torch.models.layers import linear as _linear
from pddl_tpu_torch.models.vit import remat_block
from pddl_tpu_torch.ops.attention import host_index
from pddl_tpu_torch.ops.moe import SwitchFFN
from pddl_tpu_torch.ops.rope import apply_rope_qk


def _default_intermediate_dim(embed_dim: int) -> int:
    """The SwiGLU convention: 2/3 of the 4E classic MLP width, rounded up
    to a multiple of 128."""
    return -(-(8 * embed_dim // 3) // 128) * 128


def ring_len(sliding_window: Optional[int],
             max_decode_len: int) -> Optional[int]:
    """Rolling-cache length for SWA decode (the window rounded up to a
    multiple of 128), or None when a full-length cache is smaller."""
    if sliding_window is None:
        return None
    ring = -(-sliding_window // 128) * 128
    return ring if ring < max_decode_len else None


class _RMSNorm(nn.Module):
    """Family-standard RMSNorm: f32 compute, learned scale (stored in the
    parameter dtype), f32 output."""

    def __init__(self, dim: int, eps: float, param_dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                              device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        var = x.square().mean(dim=-1, keepdim=True)
        return x * (torch.rsqrt(var + self.eps) * self.weight.float())


def _rms_norm(dim: int, eps: float, param_dtype, device) -> _RMSNorm:
    return _RMSNorm(dim, eps, param_dtype, device)


class LlamaAttention(nn.Module):
    """Causal GQA with RoPE: ``query``/``key``/``value``/``out`` linears
    (bias-free except Qwen2-style q/k/v biases), K/V at ``num_kv_heads``
    and consumed unexpanded by every attention path."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int, *,
                 rope_theta: float = 10000.0, attention: str = "flash",
                 sliding_window: Optional[int] = None,
                 qkv_bias: bool = False, max_decode_len: int = 1024,
                 mesh=None, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed dim {embed_dim} not divisible by {num_heads} heads")
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {num_kv_heads}")
        if sliding_window is not None and sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {sliding_window}")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = embed_dim // num_heads
        self.rope_theta = rope_theta
        self.attention = attention
        self.mesh = mesh
        self.seq = SeqShard(mesh)
        self.sliding_window = sliding_window
        self.ring = ring_len(sliding_window, max_decode_len)
        self.dtype = dtype
        # The model axis's group once bound: the heads above are then this
        # process's (``parallel/tensor_parallel.py``).
        self.tp_group = None
        lin = functools.partial(_linear, dtype=dtype,
                                param_dtype=param_dtype or dtype,
                                device=device)
        hd = self.head_dim
        self.query = lin(embed_dim, num_heads * hd, bias=qkv_bias)
        self.key = lin(embed_dim, num_kv_heads * hd, bias=qkv_bias)
        self.value = lin(embed_dim, num_kv_heads * hd, bias=qkv_bias)
        self.out = lin(num_heads * hd, embed_dim, bias=False)
        # The JAX module's q/k/v biases are DenseGeneral [H, D]: 2-D there,
        # flat here (``layers.jax_shapes``).
        self.jax_shapes = ({"query.bias": (num_heads, hd),
                            "key.bias": (num_kv_heads, hd),
                            "value.bias": (num_kv_heads, hd)}
                           if qkv_bias else {})

    def forward(self, x: torch.Tensor, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Union[int, torch.Tensor, None] = None,
                block_table: Optional[torch.Tensor] = None,
                max_index: Optional[int] = None) -> torch.Tensor:
        b, s, _ = x.shape
        hd = self.head_dim
        x = copy_to_group(x, self.tp_group)
        q = self.query(x).view(b, s, self.num_heads, hd).transpose(1, 2)
        k = self.key(x).view(b, s, self.num_kv_heads, hd).transpose(1, 2)
        v = self.value(x).view(b, s, self.num_kv_heads, hd).transpose(1, 2)
        if cache is None:
            first = self.seq.offset(s)
            pos = torch.arange(first, first + s, device=x.device)
            q, k = apply_rope_qk(q, k, pos, theta=self.rope_theta)
            o = attend_full(self.attention, self.mesh, q, k, v, causal=True,
                            window=self.sliding_window)
        else:
            refuse_mesh_decode(self.mesh)
            if isinstance(cache_index, torch.Tensor) and cache_index.ndim:
                i = cache_index.to(x.device)
                if s != 1 and self.ring is not None:
                    raise ValueError(
                        "per-row cache_index over a rolling ring cache "
                        f"supports single-token steps only (got a {s}-token "
                        "block)")
                pos = i[:, None] + torch.arange(s, device=x.device)
            else:
                # A shared offset stays a host int: no copy to the device.
                i = max_index = host_index(cache_index)
                pos = torch.arange(i, i + s, device=x.device)
            q, k = apply_rope_qk(q, k, pos, theta=self.rope_theta)
            k, v = k.to(self.dtype), v.to(self.dtype)
            if block_table is not None:
                o = self._paged(q, k, v, cache, i, block_table, max_index)
            else:
                o = self._row(q, k, v, cache, i, max_index)
        o = o.transpose(1, 2).reshape(b, s, self.num_heads * hd)
        return row_linear(self.out, o, self.tp_group)

    def _paged(self, q, k, v, cache, i, block_table, max_index):
        if self.ring is not None:
            raise NotImplementedError(
                "paged attention requires a full-length cache; rolling "
                "sliding-window caches are not paged")
        return paged_attend(q, k, v, cache, i, block_table, max_index,
                            window=self.sliding_window)

    def _row(self, q, k, v, cache, i, max_index):
        return row_attend(q, k, v, cache, i, max_index, ring=self.ring,
                          window=self.sliding_window)


class LlamaBlock(nn.Module):
    """Pre-RMSNorm residual block: attention then a SwiGLU MLP — dense, or
    routed over ``moe_experts`` SwiGLU experts (the Mixtral block)."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int,
                 intermediate_dim: int, *, rope_theta: float = 10000.0,
                 attention: str = "flash",
                 sliding_window: Optional[int] = None,
                 qkv_bias: bool = False, rms_eps: float = 1e-5,
                 max_decode_len: int = 1024, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 2.0,
                 moe_eval_dropless: bool = True, mesh=None,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.dtype = dtype
        self.ln1 = _rms_norm(embed_dim, rms_eps, param_dtype, device)
        self.attn = LlamaAttention(
            embed_dim, num_heads, num_kv_heads, rope_theta=rope_theta,
            attention=attention, sliding_window=sliding_window,
            qkv_bias=qkv_bias, max_decode_len=max_decode_len, mesh=mesh,
            dtype=dtype, param_dtype=param_dtype, device=device)
        self.ln2 = _rms_norm(embed_dim, rms_eps, param_dtype, device)
        self.tp_group = None  # the MLP's model-axis group once bound
        if moe_experts:
            self.moe = SwitchFFN(
                embed_dim, moe_experts, hidden_dim=intermediate_dim,
                top_k=moe_top_k, capacity_factor=moe_capacity_factor,
                eval_dropless=moe_eval_dropless, expert_act="swiglu",
                dtype=dtype, param_dtype=param_dtype, device=device)
            return
        lin = functools.partial(_linear, bias=False, dtype=dtype,
                                param_dtype=param_dtype, device=device)
        self.mlp_gate = lin(embed_dim, intermediate_dim)
        self.mlp_up = lin(embed_dim, intermediate_dim)
        self.mlp_down = lin(intermediate_dim, embed_dim)

    def forward(self, x, train: bool = True, **cache_kw):
        """``train`` (positional, as the remat wrapper passes it) gates
        the routed block's capacity rule; a cached forward runs as eval."""
        h = self.attn(self.ln1(x).to(self.dtype), **cache_kw)
        x = x + h
        h = self.ln2(x).to(self.dtype)
        if hasattr(self, "moe"):
            return x + self.moe(h, train and not cache_kw)
        h = copy_to_group(h, self.tp_group)
        return x + row_linear(
            self.mlp_down, F.silu(self.mlp_gate(h)) * self.mlp_up(h),
            self.tp_group)


@torch.no_grad()
def init_llama_weights(model: nn.Module, seed: int) -> None:
    """Draw a Llama-family model's weights from a generator seeded with
    ``seed``, in parameter order: normal with std ``fan_in ** -0.5`` for
    every projection and ``embed_dim ** -0.5`` for the embedding, RMSNorm
    scales 1, biases 0, a routed block's experts by
    :meth:`SwitchFFN.reset_parameters`. A model on the ``meta`` device
    (shapes only) draws nothing."""
    if model.device.type == "meta":
        return
    draw_llama_weights(model,
                       torch.Generator(device=model.device).manual_seed(seed))


@torch.no_grad()
def draw_llama_weights(model: nn.Module, gen: torch.Generator) -> None:
    """:func:`init_llama_weights`'s draws from ``gen``, in ``model``'s
    parameter order (a whole model or one part of it)."""
    for name, p in model.named_parameters():
        if ".moe." in name:
            moe = model.get_submodule(name.split(".moe.")[0] + ".moe")
            if name.endswith("moe.router.weight"):
                moe.reset_parameters(gen)
            continue
        if isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                      _RMSNorm):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            fan_in = p.shape[1]
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)


class _LlamaEmbed(nn.Module):
    """Token embedding over the ``vocab_multiple``-padded vocabulary, the
    table in ``param_dtype``, its rows in ``dtype``."""

    def __init__(self, vocab_size: int, embed_dim: int, vocab_multiple: int,
                 dtype, param_dtype, device):
        super().__init__()
        padded_v = -(-vocab_size // vocab_multiple) * vocab_multiple
        self.dtype = dtype
        self.embed = nn.Embedding(padded_v, embed_dim, dtype=param_dtype,
                                  device=device)
        # Vocabulary-parallel once bound: this process's first row.
        self.vocab_group = None
        self.vocab_offset = 0

    def forward(self, tokens):
        return vocab_embed(self.embed, tokens, self.vocab_group,
                           self.vocab_offset).to(self.dtype)


class _LlamaHead(nn.Module):
    """Final RMSNorm + bias-free LM head; the padded vocabulary is sliced
    off and logits come back in f32."""

    def __init__(self, vocab_size: int, embed_dim: int, vocab_multiple: int,
                 rms_eps: float, dtype, param_dtype, device):
        super().__init__()
        self.vocab_size = vocab_size
        self.dtype = dtype
        padded_v = -(-vocab_size // vocab_multiple) * vocab_multiple
        self.ln_final = _rms_norm(embed_dim, rms_eps, param_dtype, device)
        self.lm_head = _linear(embed_dim, padded_v, bias=False, dtype=dtype,
                               param_dtype=param_dtype, device=device)
        self.vocab_group = None  # vocabulary-parallel once bound

    def features(self, x):
        return self.ln_final(x).to(self.dtype)

    def forward(self, x):
        """Features then logits (the head after a pipeline)."""
        return self.logits(self.features(x))

    def logits(self, feats):
        g = self.vocab_group
        out = gather_from_group(self.lm_head(copy_to_group(feats, g)), g)
        return out[..., :self.vocab_size].float()


class Llama(nn.Module):
    """Decoder-only Llama-architecture LM: tokens ``[B, S]`` → f32 logits
    ``[B, S, vocab_size]`` (or post-norm features with
    ``features_only=True``; :meth:`head_logits` finishes them).

    Weights are drawn from a ``torch.Generator`` seeded with ``seed``
    (normal, std ``fan_in ** -0.5`` for every projection and
    ``embed_dim ** -0.5`` for the embedding; RMSNorm scales at 1) on
    ``device`` — ``None`` means ``cuda``, and a host without a card must
    pass ``device="cpu"``. ``dtype`` is the compute type and
    ``param_dtype`` (default: ``dtype``) the parameters' storage type.
    """

    def __init__(self, vocab_size: int, max_len: int = 2048,
                 embed_dim: int = 512, depth: int = 4, num_heads: int = 8,
                 num_kv_heads: Optional[int] = None,
                 intermediate_dim: Optional[int] = None,
                 rope_theta: float = 10000.0, attention: str = "flash",
                 sliding_window: Optional[int] = None,
                 qkv_bias: bool = False, remat: str = "none",
                 vocab_multiple: int = 1, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_every: int = 1,
                 moe_capacity_factor: float = 2.0,
                 moe_eval_dropless: bool = True, mesh=None,
                 rms_eps: float = 1e-5, dtype=torch.float32,
                 param_dtype=None, device=None, seed: int = 0):
        super().__init__()
        check_attention(attention, mesh, moe_experts=moe_experts)
        block_cls = remat_block(LlamaBlock, remat)
        device = resolve_device(device)
        param_dtype = param_dtype or dtype
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        # The decode cache's K/V heads a process (the local ones under
        # tensor parallelism).
        self.cache_kv_heads = self.num_kv_heads
        self.head_dim = embed_dim // num_heads
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.moe_every = moe_every
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_eval_dropless = moe_eval_dropless
        self.sliding_window = sliding_window
        self.attention = attention
        self.mesh = mesh
        self.remat = remat
        self.dtype = dtype
        self.param_dtype = param_dtype
        inter = intermediate_dim or _default_intermediate_dim(embed_dim)
        # The modules are built on ``meta`` and then laid out on
        # ``device`` uninitialised: init_weights draws every parameter, so
        # torch's default init (most of a host build's time) is skipped.
        shell = torch.device("meta")
        self.stem = _LlamaEmbed(vocab_size, embed_dim, vocab_multiple, dtype,
                                param_dtype, shell)
        # Every moe_every-th block from the back is routed (as JAX's).
        self.blocks = nn.ModuleList(
            block_cls(embed_dim, num_heads, self.num_kv_heads, inter,
                       rope_theta=rope_theta, attention=attention,
                       sliding_window=sliding_window, qkv_bias=qkv_bias,
                       rms_eps=rms_eps, max_decode_len=max_len,
                       moe_experts=(moe_experts if (depth - 1 - i) % moe_every
                                    == 0 else 0),
                       moe_top_k=moe_top_k,
                       moe_capacity_factor=moe_capacity_factor,
                       moe_eval_dropless=moe_eval_dropless, mesh=mesh,
                       dtype=dtype, param_dtype=param_dtype, device=shell)
            for i in range(depth))
        self.head = _LlamaHead(vocab_size, embed_dim, vocab_multiple,
                               rms_eps, dtype, param_dtype, shell)
        self.to_empty(device=device)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        # The final norm's scale: 1-D, so never int8 (``ops/quant.py``);
        # reading a quantized weight would dequantize it.
        return self.head.ln_final.weight.device

    @property
    def uses_ring_cache(self) -> bool:
        """True when decode would need a rolling ring cache: the window,
        rounded up to 128, is under ``max_len`` (:func:`ring_len`)."""
        return ring_len(self.sliding_window, self.max_len) is not None

    def init_weights(self, seed: int) -> None:
        """Redraw every weight from a generator seeded with ``seed``
        (:func:`init_llama_weights`)."""
        init_llama_weights(self, seed)

    def forward(self, tokens: torch.Tensor, *, train: bool = True,
                cache: Optional[dict] = None,
                cache_index: Union[int, torch.Tensor, None] = None,
                block_table: Optional[torch.Tensor] = None,
                max_index: Optional[int] = None,
                features_only: bool = False) -> torch.Tensor:
        """``train`` gates the routed blocks' capacity rule (the dense
        blocks have no dropout); a cached forward runs as eval. With a
        cache, ``cache_index``
        is an int or a ``[B]`` tensor, and ``max_index`` the tensor's
        largest entry as a host int, which bounds each layer's sweep to
        the live prefix without a host sync (the serving engine owns its
        positions on the host)."""
        x = self.stem(tokens)
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim:
            cache_index = cache_index.to(x.device)  # once, not per layer
        for i, block in enumerate(self.blocks):
            kw = {}
            if cache is not None:
                kw = {"cache": cache[f"block{i}"]["attn"],
                      "cache_index": cache_index, "block_table": block_table,
                      "max_index": max_index}
            x = block(x, train, **kw)
        feats = self.head.features(x)
        return feats if features_only else self.head.logits(feats)

    def head_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """The LM head over ``features_only`` output: vocab logits, f32."""
        return self.head.logits(feats)


def tiny_llama(vocab_size: int = 64, **kwargs) -> Llama:
    """Miniature Llama for tests (GQA exercised: 4 q / 2 kv heads)."""
    kwargs.setdefault("max_len", 128)
    kwargs.setdefault("embed_dim", 32)
    kwargs.setdefault("depth", 2)
    kwargs.setdefault("num_heads", 4)
    kwargs.setdefault("num_kv_heads", 2)
    kwargs.setdefault("attention", "reference")
    return Llama(vocab_size=vocab_size, **kwargs)


# GPT-2-small-comparable shape (12x768, GQA 12/4).
Llama_Small = functools.partial(
    Llama, embed_dim=768, depth=12, num_heads=12, num_kv_heads=4)

# ~300M-parameter mid-size shape (GQA 20/4), the JAX package's
# f32-against-bf16 convergence shape.
Llama_300M = functools.partial(
    Llama, embed_dim=1280, depth=16, num_heads=20, num_kv_heads=4,
    intermediate_dim=3456)

# Llama-3.2-1B-shaped config (RoPE theta 500k, GQA 32/8, SwiGLU 8192).
Llama_1B = functools.partial(
    Llama, embed_dim=2048, depth=16, num_heads=32, num_kv_heads=8,
    intermediate_dim=8192, rope_theta=500000.0, max_len=4096)


class _LlamaStage(nn.Module):
    """One pipeline stage: a run of dense Llama blocks. The pipeline
    splits layers, never the sequence, so each block's RoPE positions
    are ``arange(S)`` on every stage."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int,
                 intermediate_dim: int, blocks: int, *, rope_theta: float,
                 attention: str, rms_eps: float, dtype, param_dtype,
                 device):
        super().__init__()
        self.blocks = nn.ModuleList(
            LlamaBlock(embed_dim, num_heads, num_kv_heads, intermediate_dim,
                       rope_theta=rope_theta, attention=attention,
                       rms_eps=rms_eps, dtype=dtype, param_dtype=param_dtype,
                       device=device)
            for _ in range(blocks))

    def forward(self, x):
        for block in self.blocks:
            x = block(x, False)
        return x


class GPipeLlama(GPipeModel):
    """Pipeline-parallel modern-decoder LM: token embed (replicated) →
    ``n_stages`` stages of ``blocks_per_stage`` RoPE/RMSNorm/SwiGLU
    blocks through the GPipe schedule → bias-free head (replicated), the
    JAX constructor's arguments (no routed experts, window or q/k/v bias,
    as there) plus ``device`` and ``seed``. ``mesh`` is the port's mesh,
    whose ``stage`` axis must have ``n_stages`` positions. Weights are
    drawn as :class:`Llama`'s (:func:`draw_llama_weights`), each part
    from its own generator (:meth:`GPipeModel.materialize`)."""

    def __init__(self, *, vocab_size: int, n_stages: int,
                 blocks_per_stage: int, n_microbatches: int, mesh,
                 embed_dim: int = 256, num_heads: int = 4,
                 num_kv_heads: Optional[int] = None,
                 intermediate_dim: Optional[int] = None,
                 rope_theta: float = 10000.0,
                 attention: str = "reference", rms_eps: float = 1e-5,
                 remat_stages: bool = False, dtype=torch.float32,
                 param_dtype=None, device=None, seed: int = 0):
        if attention not in ("flash", "reference"):
            raise ValueError(f"unknown attention {attention!r}")
        device = resolve_device(device)
        param_dtype = param_dtype or dtype
        kv = num_kv_heads or num_heads
        inter = intermediate_dim or _default_intermediate_dim(embed_dim)
        shell = torch.device("meta")
        super().__init__(
            embed=_LlamaEmbed(vocab_size, embed_dim, 1, dtype, param_dtype,
                              shell),
            stages=[_LlamaStage(embed_dim, num_heads, kv, inter,
                                blocks_per_stage, rope_theta=rope_theta,
                                attention=attention, rms_eps=rms_eps,
                                dtype=dtype, param_dtype=param_dtype,
                                device=shell)
                    for _ in range(n_stages)],
            head=_LlamaHead(vocab_size, embed_dim, 1, rms_eps, dtype,
                            param_dtype, shell),
            n_stages=n_stages, n_microbatches=n_microbatches, mesh=mesh,
            remat_stages=remat_stages)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_kv_heads = kv
        self.blocks_per_stage = blocks_per_stage
        self.attention = attention
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.materialize(device, draw_llama_weights, seed)
