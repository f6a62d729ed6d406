"""Layers shared by the transformer families (Llama, GPT, ViT): the
linear that casts at use, flax's LayerNorm, the tensor-parallel forms of
the products and the embedding, and the cached attention that writes a
block's K/V into a row cache or a paged pool and attends over it.

Tensor parallelism (Megatron, bound by
:class:`~pddl_tpu_torch.parallel.TensorParallelStrategy`): a
column-parallel product takes its input through
:func:`~pddl_tpu_torch.core.collectives.copy_to_group` and keeps its
output's block; a row-parallel one (:func:`row_linear`) sums its partial
products over the group and adds the bias once, after the sum; the
vocabulary-parallel embedding (:func:`vocab_embed`) looks up the tokens
of its rows, zeros the others and sums over the group; the
vocabulary-parallel head gathers its block of the logits
(:func:`~pddl_tpu_torch.core.collectives.gather_from_group`). A group of
``None`` (no tensor parallelism) makes each the plain form.

Sequence parallelism (``mesh`` with a ``seq`` axis above 1): each
process holds its shard of the sequence through the whole model
(:class:`SeqShard`): positions are global (``my·s + arange(s)``), the
attention is the ring (:func:`attend_full`), and a mean over tokens is a
sum over the ``seq`` axis (``collectives.seq_sum``) divided by the global
length.

The attention helpers are the decode half of every attention module:
``LlamaAttention`` (post-RoPE keys, optional window and ring) and the
GPT/ViT ``MultiHeadAttention`` (no window) both hand their projected
``q, k, v`` here once the positions are known.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pddl_tpu_torch.core.collectives import reduce_from_group
from pddl_tpu_torch.ops.attention import (
    attention_reference,
    decode_attention,
    flash_attention,
    flash_attention_lse,
    paged_cache_insert,
    paged_decode_attention,
)

_ITEM_7 = "not ported yet: ROADMAP.md queue 1 item 7 (distributed)"
ATTENTIONS = ("flash", "reference", "ring", "ring_flash")


class SeqShard:
    """A model's place on the ``seq`` axis: ``n`` shards, this process's
    index ``my`` and the axis's ``group`` (``n`` 1: no sharding, whatever
    the mesh)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.n = 1 if mesh is None else mesh.shape["seq"]
        self.my = 0 if self.n == 1 else mesh.axis_index("seq")
        self.group = None if self.n == 1 else mesh.axis_group("seq")

    def offset(self, s_local: int) -> int:
        """The global position of this shard's first token."""
        return self.my * s_local


def check_attention(attention: str, mesh, *, moe_experts: int = 0) -> None:
    """Validate a family's ``attention`` against its ``mesh``: the ring
    needs the mesh (the JAX text), a ``seq`` axis above 1 shards the
    activations and so needs the ring, and a routed block under it is
    not ported (the JAX module routes over the global tokens)."""
    if attention not in ATTENTIONS:
        raise ValueError(f"unknown attention {attention!r}")
    if attention in ("ring", "ring_flash") and mesh is None:
        raise ValueError(f"attention={attention!r} needs the mesh")
    if mesh is not None and mesh.shape["seq"] > 1:
        if attention not in ("ring", "ring_flash"):
            raise ValueError(
                f"a mesh with a seq axis of {mesh.shape['seq']} shards the "
                f"sequence over processes: attention={attention!r} would "
                "attend within the shard; use 'ring' or 'ring_flash'")
        if moe_experts:
            raise NotImplementedError(
                "routed (MoE) blocks under a sequence-sharded mesh are "
                + _ITEM_7)


def attend_full(attention: str, mesh, q, k, v, *, causal: bool,
                window: Optional[int] = None) -> torch.Tensor:
    """The training forward's attention by name: the flash kernels, the
    plain reference, or the ring over ``mesh``'s ``seq`` axis (this
    process's shards in, its shard out)."""
    if attention == "flash":
        return flash_attention(q, k, v, causal=causal, window=window)
    if attention == "reference":
        return attention_reference(q, k, v, causal=causal, window=window)
    from pddl_tpu_torch.ops.ring_attention import (  # noqa: PLC0415
        sequence_parallel_attention,
    )

    return sequence_parallel_attention(
        q, k, v, mesh, causal=causal, window=window,
        use_flash=attention == "ring_flash")


def refuse_mesh_decode(mesh) -> None:
    """A cached forward of a model built with a mesh: not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "decoding a model built with a mesh is " + _ITEM_7)


def jax_shapes(model: nn.Module) -> Dict[str, tuple]:
    """``{parameter name: JAX shape}`` for every parameter whose JAX shape
    has another rank than the port's: modules declare them in a
    ``jax_shapes`` dict of local names (the attention modules' flat q/k/v
    biases, DenseGeneral ``[H, D]`` in JAX). Int8 eligibility and the
    optimizers' matrices-only decay judge a parameter by this shape."""
    out = {}
    for prefix, module in model.named_modules():
        for local, shape in getattr(module, "jax_shapes", {}).items():
            out[f"{prefix}.{local}" if prefix else local] = tuple(shape)
    return out


# A multi-token block over a row cache scores its whole sweep in one pass
# when the f32 scores stay under this many elements (a verify window, a
# short prompt): every 128-key step of the online softmax costs a dozen
# eager ops per layer. Longer prefills sweep in 128-key steps. The JAX
# modules' chunks (512 for a step, 128 for a block) are tuning, not
# semantics: ``decode_attention`` gives the same result at any chunk.
_ONE_PASS_SCORES = 1 << 24


def sweep_chunk(q: torch.Tensor, cache_len: int) -> int:
    b, h, s, _ = q.shape
    if s == 1 or b * h * s * cache_len <= _ONE_PASS_SCORES:
        return cache_len
    return 128


class CastLinear(nn.Linear):
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


def linear(in_features: int, out_features: int, *, bias: bool, dtype,
           param_dtype, device) -> nn.Linear:
    """A plain ``nn.Linear`` when the parameters are stored in the compute
    dtype (serving: no casts on the host-bound decode tick), else a
    :class:`CastLinear` that casts at use."""
    if param_dtype == dtype:
        return nn.Linear(in_features, out_features, bias=bias, dtype=dtype,
                         device=device)
    return CastLinear(in_features, out_features, bias=bias, dtype=dtype,
                      param_dtype=param_dtype, device=device)


def row_linear(lin: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel ``lin`` over ``x``'s block: the partial products
    summed over ``group``, then the bias (``lin(x)`` with no group)."""
    if group is None:
        return lin(x)
    dt = getattr(lin, "compute_dtype", lin.weight.dtype)
    out = reduce_from_group(F.linear(x.to(dt), lin.weight.to(dt)), group)
    return out if lin.bias is None else out + lin.bias.to(dt)


def vocab_embed(emb: nn.Embedding, tokens: torch.Tensor, group,
                offset: int) -> torch.Tensor:
    """The vocabulary-parallel lookup: this member holds rows ``offset ..
    offset + rows - 1``; other tokens read zeros, and the sum over
    ``group`` is the whole lookup (``emb(tokens)`` with no group)."""
    if group is None:
        return emb(tokens)
    rows = emb.weight.shape[0]
    local = tokens - offset
    mine = (local >= 0) & (local < rows)
    out = F.embedding(local.clamp(0, rows - 1), emb.weight)
    return reduce_from_group(out * mine[..., None].to(out.dtype), group)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 statistics by the fast
    variance ``E[x²] - E[x]²`` (clamped at 0, flax's default
    ``use_fast_variance=True``), the scale and bias stored in the
    parameter dtype and cast to f32, an f32 output."""

    def __init__(self, dim: int, eps: float, param_dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = (x.square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean) * mul + self.bias.float()


def paged_attend(q, k, v, cache, i, block_table, max_index, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """Write a block's K/V into the pool through the table, then attend
    (a multi-token block's sweep bounded by ``max_index``, a host int;
    on the card a single-token step runs the paged-decode kernel)."""
    kp = paged_cache_insert(cache["cached_key"], k, block_table, i)
    vp = paged_cache_insert(cache["cached_value"], v, block_table, i)
    return paged_decode_attention(q, kp, vp, block_table, i, window=window,
                                  max_index=max_index)


def row_attend(q, k, v, cache, i, max_index, *, ring: Optional[int] = None,
               window: Optional[int] = None) -> torch.Tensor:
    """Write a block's K/V into the row cache (in place) and attend over
    it.

    ``i`` is an int, or a ``[B]`` tensor with ``max_index`` its deepest
    row as a host int (None: one sync reads it, and the sweep reads the
    whole cache). ``ring`` is the length of a rolling sliding-window
    cache (Llama's), None for a full-length one."""
    ck, cv = cache["cached_key"], cache["cached_value"]
    b, _, s, _ = q.shape
    cache_len = ck.shape[2]
    if isinstance(i, torch.Tensor):
        # Per-row scatter at i[b] + arange(s) (ring rows wrap their slot;
        # s == 1 there). The indexed axes go first: the update is
        # [B, s, H_kv, D].
        rows = torch.arange(b, device=q.device)[:, None]
        slot = i.long()[:, None] + torch.arange(s, device=q.device)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        if ring is not None:
            slot = slot % ring
        elif ((int(i.max()) if max_index is None else max_index) + s
              > cache_len):
            # A row near the edge (a verify window's lookahead): its
            # positions past the cache drop, as the JAX scatter drops
            # them. Selecting the rest takes one sync.
            keep = slot < cache_len
            rows, slot = rows.expand(b, s)[keep], slot[keep]
            kt, vt = kt[keep], vt[keep]
        ck[rows, :, slot] = kt
        cv[rows, :, slot] = vt
        return decode_attention(q, ck, cv, i, window=window,
                                rolling=ring is not None,
                                max_index=max_index,
                                chunk=sweep_chunk(q, cache_len))
    if ring is None:
        if i + s > cache_len:
            raise ValueError(
                f"a {s}-token block at cache_index {i} runs past "
                f"the cache's {cache_len} positions")
        ck.narrow(2, i, s).copy_(k)
        cv.narrow(2, i, s).copy_(v)
        return decode_attention(q, ck, cv, i, window=window,
                                chunk=sweep_chunk(q, cache_len))
    if s == 1:
        ck.narrow(2, i % ring, 1).copy_(k)
        cv.narrow(2, i % ring, 1).copy_(v)
        return decode_attention(q, ck, cv, i, window=window, rolling=True)
    # A block on the ring (chunked prefill of a sliding-window model): it
    # attends to itself through K1 with its LSE and to the history through
    # the ring as it was BEFORE this block's writes, which may overwrite
    # in-window slots that its early queries still need. The two
    # normalized partials merge in logsumexp space; at i == 0 the history
    # lse is ~NEG_INF and its o 0, so it weighs 0.
    o_blk, lse_blk = flash_attention_lse(q, k, v, causal=True, window=window)
    o_hist, lse_hist = decode_attention(
        q, ck, cv, i, window=window, rolling=True, history_only=True,
        return_lse=True, chunk=128)
    keep = min(s, ring)  # only the last `ring` tokens survive
    slots = (i + torch.arange(s - keep, s, device=q.device)) % ring
    ck[:, :, slots] = k[:, :, s - keep:]
    cv[:, :, slots] = v[:, :, s - keep:]
    m = torch.maximum(lse_blk, lse_hist)
    w_blk = torch.exp(lse_blk - m)[..., None]
    w_hist = torch.exp(lse_hist - m)[..., None]
    return ((o_blk.float() * w_blk + o_hist.float() * w_hist)
            / (w_blk + w_hist)).to(q.dtype)
