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

Two forward modes, chosen by whether a cache is passed:

- no cache: the training-shaped full forward over ``[B, S]`` tokens at
  positions ``arange(S)``, attention through
  :func:`~pddl_tpu_torch.ops.attention.flash_attention` (the default
  ``attention="flash"``: the CUDA flash kernels on the card, with their
  backward under a gradient) or
  :func:`~pddl_tpu_torch.ops.attention.attention_reference`
  (``attention="reference"``);
- a PAGED cache (``serve/kvcache/block_pool.paged_decode_cache``) plus
  the engine-owned ``cache_index`` (an int for a batch-1 prefill chunk,
  ``[B]`` for the decode tick) and ``block_table`` (``[B, T]``): each
  layer writes its post-RoPE K/V into the pool
  (:func:`~pddl_tpu_torch.ops.attention.paged_cache_insert`) and attends
  through the table (:func:`~pddl_tpu_torch.ops.attention.paged_decode_attention`
  — the CUDA kernel for single-token steps on the card). Keys are cached
  post-RoPE at their ABSOLUTE positions, so a shared pool block is
  bit-valid for every row whose table references it.

``remat`` (``"none"``, ``"dots"``, ``"full"``) wraps every block with
:func:`pddl_tpu_torch.models.vit.remat_block`: under a gradient, with no
cache passed, each block's activations are rematerialized in the backward
per the named policy; the paged decode path never remats.

Not ported yet (each raises ``NotImplementedError``): routed experts
(``moe_experts > 0``, ROADMAP.md queue 1 item 5), rolling sliding-window
ring caches (queue 1 item 2) and ring / sequence-parallel attention
(queue 1 item 7).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from pddl_tpu_torch.device import resolve_device
from pddl_tpu_torch.models.vit import remat_block
from pddl_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
    paged_cache_insert,
    paged_decode_attention,
)
from pddl_tpu_torch.ops.rope import apply_rope_qk

_NOT_PORTED = "not ported yet: ROADMAP.md queue 1 item {}"


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


class _Linear(nn.Linear):
    """``nn.Linear`` whose parameters live in ``param_dtype`` and whose
    product runs in the compute ``dtype`` (flax ``Dense`` semantics:
    input, kernel and bias cast to ``dtype`` at use)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool,
                 dtype, param_dtype, device):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _linear(in_features: int, out_features: int, *, bias: bool, dtype,
            param_dtype, device) -> nn.Linear:
    """A plain ``nn.Linear`` when the parameters are stored in the compute
    dtype (serving: no casts on the host-bound decode tick), else a
    :class:`_Linear` that casts at use."""
    if param_dtype == dtype:
        return nn.Linear(in_features, out_features, bias=bias, dtype=dtype,
                         device=device)
    return _Linear(in_features, out_features, bias=bias, dtype=dtype,
                   param_dtype=param_dtype, device=device)


class LlamaAttention(nn.Module):
    """Causal GQA with RoPE: ``query``/``key``/``value``/``out`` linears
    (bias-free except Qwen2-style q/k/v biases), K/V at ``num_kv_heads``
    and consumed unexpanded by every attention path."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int, *,
                 rope_theta: float = 10000.0, attention: str = "flash",
                 sliding_window: Optional[int] = None,
                 qkv_bias: bool = False, dtype=torch.float32,
                 param_dtype=None, device=None):
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
        self.sliding_window = sliding_window
        self.dtype = dtype
        lin = functools.partial(_linear, dtype=dtype,
                                param_dtype=param_dtype or dtype,
                                device=device)
        hd = self.head_dim
        self.query = lin(embed_dim, num_heads * hd, bias=qkv_bias)
        self.key = lin(embed_dim, num_kv_heads * hd, bias=qkv_bias)
        self.value = lin(embed_dim, num_kv_heads * hd, bias=qkv_bias)
        self.out = lin(num_heads * hd, embed_dim, bias=False)

    def forward(self, x: torch.Tensor, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Union[int, torch.Tensor, None] = None,
                block_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        hd = self.head_dim
        q = self.query(x).view(b, s, self.num_heads, hd).transpose(1, 2)
        k = self.key(x).view(b, s, self.num_kv_heads, hd).transpose(1, 2)
        v = self.value(x).view(b, s, self.num_kv_heads, hd).transpose(1, 2)
        if cache is None:
            pos = torch.arange(s, device=x.device)
            q, k = apply_rope_qk(q, k, pos, theta=self.rope_theta)
            attend = (flash_attention if self.attention == "flash"
                      else attention_reference)
            o = attend(q, k, v, causal=True, window=self.sliding_window)
        else:
            i = torch.as_tensor(cache_index, device=x.device)
            pos = i[..., None] + torch.arange(s, device=x.device)
            q, k = apply_rope_qk(q, k, pos, theta=self.rope_theta)
            if not isinstance(cache_index, torch.Tensor):
                i = int(cache_index)  # batch-1 chunk: a host offset
            kp = paged_cache_insert(cache["cached_key"], k.to(self.dtype),
                                    block_table, i)
            vp = paged_cache_insert(cache["cached_value"], v.to(self.dtype),
                                    block_table, i)
            o = paged_decode_attention(q, kp, vp, block_table, i,
                                       window=self.sliding_window)
        o = o.transpose(1, 2).reshape(b, s, self.num_heads * hd)
        return self.out(o)


class LlamaBlock(nn.Module):
    """Pre-RMSNorm residual block: attention then a dense SwiGLU MLP."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int,
                 intermediate_dim: int, *, rope_theta: float = 10000.0,
                 attention: str = "flash",
                 sliding_window: Optional[int] = None,
                 qkv_bias: bool = False, rms_eps: float = 1e-5,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.dtype = dtype
        self.ln1 = _rms_norm(embed_dim, rms_eps, param_dtype, device)
        self.attn = LlamaAttention(
            embed_dim, num_heads, num_kv_heads, rope_theta=rope_theta,
            attention=attention, sliding_window=sliding_window,
            qkv_bias=qkv_bias, dtype=dtype, param_dtype=param_dtype,
            device=device)
        self.ln2 = _rms_norm(embed_dim, rms_eps, param_dtype, device)
        lin = functools.partial(_linear, bias=False, dtype=dtype,
                                param_dtype=param_dtype, device=device)
        self.mlp_gate = lin(embed_dim, intermediate_dim)
        self.mlp_up = lin(embed_dim, intermediate_dim)
        self.mlp_down = lin(intermediate_dim, embed_dim)

    def forward(self, x, **cache_kw):
        h = self.attn(self.ln1(x).to(self.dtype), **cache_kw)
        x = x + h
        h = self.ln2(x).to(self.dtype)
        return x + self.mlp_down(F.silu(self.mlp_gate(h)) * self.mlp_up(h))


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

    def forward(self, tokens):
        return self.embed(tokens).to(self.dtype)


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

    def features(self, x):
        return self.ln_final(x).to(self.dtype)

    def logits(self, feats):
        return self.lm_head(feats)[..., :self.vocab_size].float()


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
                 rms_eps: float = 1e-5, dtype=torch.float32,
                 param_dtype=None, device=None, seed: int = 0):
        super().__init__()
        if attention in ("ring", "ring_flash"):
            raise NotImplementedError(
                f"attention={attention!r} (sequence parallelism) is "
                + _NOT_PORTED.format("7 (distributed)"))
        if attention not in ("flash", "reference"):
            raise ValueError(f"unknown attention {attention!r}")
        if moe_experts:
            raise NotImplementedError(
                "moe_experts > 0 is "
                + _NOT_PORTED.format("5 (causal-LM train step, ops/moe.py)"))
        if ring_len(sliding_window, max_len) is not None:
            raise NotImplementedError(
                f"sliding_window={sliding_window} allocates a rolling ring "
                "cache, which is "
                + _NOT_PORTED.format("2 (resident-row engine)"))
        block_cls = remat_block(LlamaBlock, remat)
        device = resolve_device(device)
        param_dtype = param_dtype or dtype
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = embed_dim // num_heads
        self.sliding_window = sliding_window
        self.attention = attention
        self.remat = remat
        self.dtype = dtype
        self.param_dtype = param_dtype
        inter = intermediate_dim or _default_intermediate_dim(embed_dim)
        self.stem = _LlamaEmbed(vocab_size, embed_dim, vocab_multiple, dtype,
                                param_dtype, device)
        self.blocks = nn.ModuleList(
            block_cls(embed_dim, num_heads, self.num_kv_heads, inter,
                       rope_theta=rope_theta, attention=attention,
                       sliding_window=sliding_window, qkv_bias=qkv_bias,
                       rms_eps=rms_eps, dtype=dtype, param_dtype=param_dtype,
                       device=device)
            for _ in range(depth))
        self.head = _LlamaHead(vocab_size, embed_dim, vocab_multiple,
                               rms_eps, dtype, param_dtype, device)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.head.lm_head.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Redraw every weight from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if isinstance(self.get_submodule(name.rsplit(".", 1)[0]),
                          _RMSNorm):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                fan_in = p.shape[1]
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)

    def forward(self, tokens: torch.Tensor, *, train: bool = True,
                cache: Optional[dict] = None,
                cache_index: Union[int, torch.Tensor, None] = None,
                block_table: Optional[torch.Tensor] = None,
                features_only: bool = False) -> torch.Tensor:
        """``train`` is accepted for the JAX signature and changes nothing
        (the dense blocks have no dropout)."""
        x = self.stem(tokens)
        for i, block in enumerate(self.blocks):
            kw = {}
            if cache is not None:
                kw = {"cache": cache[f"block{i}"]["attn"],
                      "cache_index": cache_index, "block_table": block_table}
            x = block(x, **kw)
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

# Llama-3.2-1B-shaped config (RoPE theta 500k, GQA 32/8, SwiGLU 8192).
Llama_1B = functools.partial(
    Llama, embed_dim=2048, depth=16, num_heads=32, num_kv_heads=8,
    intermediate_dim=8192, rope_theta=500000.0, max_len=4096)
