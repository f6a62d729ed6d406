"""Attention ops of the paged serving path, in PyTorch (subset of
:mod:`pddl_tpu.ops.attention`).

- :func:`attention_reference` — plain causal GQA softmax attention, the
  Llama module's non-decode path and the numerics oracle.
- :func:`paged_cache_insert` — write the current token(s) of every row
  into its table-mapped pool block.
- :func:`paged_decode_attention` — attention over the pool through a
  per-row block table. Its plain path (torch ops) serves multi-token
  prefill chunks on every device and single-token steps on the CPU; a
  single-token step on a CUDA tensor goes to the hand-written kernel
  (:func:`paged_decode_attention_kernel`, ``csrc/paged_decode.cu``).

Safety contract shared with ``serve/kvcache/block_pool.py``: block 0 is
the reserved scratch sink — parked rows' table entries are all scratch,
junk writes land there, and masked reads never reach past a row's
position counter, so scratch content is junk by construction and
harmless by masking.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from pddl_tpu_torch.ops import _kernels

NEG_INF = -1e30

IndexLike = Union[int, torch.Tensor]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _gqa_rep(q: torch.Tensor, k: torch.Tensor) -> int:
    """Query heads per K/V head (``[..., H, S, D]`` layouts)."""
    hq, hkv = q.shape[-3], k.shape[-3]
    if hq == hkv:
        return 1
    if hq % hkv:
        raise ValueError(
            f"query heads {hq} not divisible by kv heads {hkv}")
    return hq // hkv


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain softmax attention over ``[B, H, S, D]`` queries and
    ``[B, H_kv, S, D]`` keys/values (GQA unexpanded: each kv head serves
    ``H/H_kv`` consecutive query heads), computed in f32. ``window``
    (causal only): query t sees keys ``[t-window+1, t]``."""
    b, h, sq, d = q.shape
    sk = k.shape[-2]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding-window "
                             "attention is a causal-LM construct)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    rep = _gqa_rep(q, k)
    hkv = k.shape[-3]
    qg = q.reshape(b, hkv, rep, sq, d).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        mask = q_pos >= k_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def _check_table(block_table: torch.Tensor, b: int) -> None:
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(
            f"block_table must be [B={b}, T], got {tuple(block_table.shape)}")


def paged_cache_insert(pool: torch.Tensor, kv: torch.Tensor,
                       block_table: torch.Tensor,
                       index: IndexLike) -> torch.Tensor:
    """Write ``kv [B, H_kv, s, D]`` at global positions
    ``index (+ arange(s))`` into pool blocks resolved through
    ``block_table [B, T]`` (``pool [N, H_kv, block_size, D]``).

    Unlike the JAX function, which returns a new array, this writes the
    pool IN PLACE (``index_put_``) and returns it — the pool is the
    serving engine's one KV store and is never copied.

    ``index`` is an int (batch-1 chunk prefill) or a per-row ``[B]``
    tensor (the serving tick: every row writes one token at its own
    depth). Positions whose block index falls outside the table are
    deflected to the scratch block, so padded prefill junk beyond a
    prompt's allocated blocks can never reach a real block.

    The multi-token batch-1 path works at block granularity: read the
    span's blocks, splice the chunk in contiguously, write whole blocks
    back.
    """
    n, hkv, bs, d = pool.shape
    b, _, s, _ = kv.shape
    _check_table(block_table, b)
    t = block_table.shape[1]
    kv = kv.to(pool.dtype)
    if s > 1 and b == 1:
        start = int(index)
        first = start // bs
        n_span = -(-s // bs) + 1
        span = first + torch.arange(n_span, device=pool.device)
        ids = torch.where(span < t,
                          block_table[0, span.clamp(max=t - 1)].long(), 0)
        flat = pool[ids].transpose(0, 1).reshape(hkv, n_span * bs, d)
        off = start % bs
        flat[:, off:off + s] = kv[0]
        pool[ids] = flat.reshape(hkv, n_span, bs, d).transpose(0, 1)
        return pool
    index = torch.as_tensor(index, dtype=torch.long, device=pool.device)
    pos = index[..., None] + torch.arange(s, device=pool.device)
    pos = pos.expand(b, s)
    blk = pos // bs
    off = pos % bs
    bid = torch.gather(block_table.long(), 1, blk.clamp(max=t - 1))
    bid = torch.where(blk < t, bid, 0)
    updates = kv.transpose(1, 2).reshape(b * s, hkv, d)
    pool[bid.reshape(-1), :, off.reshape(-1)] = updates
    return pool


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           index: IndexLike, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           kernel: Optional[bool] = None) -> torch.Tensor:
    """Attention over a paged KV pool through a per-row block table.

    Semantically decode attention over the VIRTUAL cache
    ``cache[b, :, j*bs + o] == pool[block_table[b, j], :, o]``: query
    ``i`` of row ``b`` (global position ``index[b] + i``) attends every
    cached position at or before its own (and inside ``window``).

    Args:
      q: ``[B, H, s, D]`` post-RoPE queries (``s == 1`` on the decode
        tick; ``s > 1`` for a chunked prefill continuing at ``index``).
      k_pool/v_pool: ``[N, H_kv, block_size, D]``; the current tokens
        must already be written (:func:`paged_cache_insert` runs first).
      block_table: ``[B, T]`` int32 pool block ids.
      index: tokens in the (virtual) cache before this call; an int or a
        per-row ``[B]`` tensor.
      window: sliding-window mask.
      kernel: ``None`` (default) sends single-token steps to
        :func:`paged_decode_attention_kernel` — the CUDA kernel for CUDA
        tensors, its plain version for CPU tensors — and multi-token
        chunks to the plain path; ``False`` forces the plain path;
        ``True`` forces the kernel wrapper (``s == 1`` only).

    Returns ``[B, H, s, D]`` in q's dtype.
    """
    b, h, s, d = q.shape
    _gqa_rep(q, k_pool)
    _check_table(block_table, b)
    index = torch.as_tensor(index, dtype=torch.int32, device=q.device)
    if index.ndim > 1 or (index.ndim == 1 and index.shape[0] != b):
        raise ValueError(
            f"index must be a scalar or [B]={b} vector, "
            f"got {tuple(index.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale_v = (1.0 / math.sqrt(d)) if scale is None else scale
    if kernel is None:
        kernel = s == 1
    if kernel:
        if s != 1:
            raise ValueError(
                "the paged decode kernel serves single-token decode steps "
                f"only (got a {s}-token block); multi-token prefill takes "
                "the plain path (kernel=False)")
        return paged_decode_attention_kernel(
            q, k_pool, v_pool, block_table, index, scale=scale_v,
            window=window)
    return _paged_attention_plain(q, k_pool, v_pool, block_table, index,
                                  scale_v, window)


def _paged_attention_plain(q, k_pool, v_pool, block_table, index, scale,
                           window):
    """The plain PyTorch version: gather each row's live blocks into a
    dense ``[B, H_kv, L, D]`` view (``L`` covers the deepest row's
    prefix, so traffic is bounded by the live prefix), then one masked
    softmax in f32. Rounding points follow the kernel: q is cast to the
    pool's type, p to v's type before the P·V product."""
    b, h, s, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    t = block_table.shape[1]
    rep = h // hkv
    index = index.to(torch.long)
    q_pos = index.reshape(-1, 1) + torch.arange(s, device=q.device)  # [B|1, s]
    q_pos = q_pos.expand(b, s)
    n_live = min(t, int(q_pos.max()) // bs + 1)
    ids = block_table[:, :n_live].long()                         # [B, n]
    kc = k_pool[ids].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_live * bs, d)
    vc = v_pool[ids].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_live * bs, d)
    qg = q.reshape(b, hkv, rep, s, d).to(k_pool.dtype).float()
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kc.float()) * scale
    pos = torch.arange(n_live * bs, device=q.device)
    mask = pos[None, None, :] <= q_pos[:, :, None]                # [B, s, L]
    if window is not None:
        mask &= pos[None, None, :] > q_pos[:, :, None] - window
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v_pool.dtype).float(),
                       vc.float())
    return (acc / l.clamp_min(1e-30)).reshape(b, h, s, d).to(q.dtype)


def paged_decode_attention_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_table: torch.Tensor,
                                  index: IndexLike, *,
                                  scale: Optional[float] = None,
                                  window: Optional[int] = None
                                  ) -> torch.Tensor:
    """The paged decode kernel (single-token steps) — the port of the
    Pallas ``_paged_decode_kernel`` (``csrc/paged_decode.cu``).

    A CUDA ``q`` launches the kernel or raises: the wrapper checks
    device, dtype, shape and contiguity, allocates the output, launches
    on the current stream and raises on the C entry's nonzero return.
    A CPU ``q`` gets the plain version (:func:`paged_decode_attention`'s
    torch path) — the only reason it ever runs instead of the kernel.
    """
    b, h, s, d = q.shape
    if s != 1:
        raise ValueError(f"decode kernel takes single-token steps, got s={s}")
    n, hkv, bs, _ = k_pool.shape
    _gqa_rep(q, k_pool)
    t = block_table.shape[1]
    scale_v = (1.0 / math.sqrt(d)) if scale is None else scale
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    index = torch.as_tensor(index, dtype=torch.int32, device=q.device)
    index = index.expand(b).contiguous()
    if q.device.type == "cpu":
        return _paged_attention_plain(q, k_pool, v_pool, block_table, index,
                                      scale_v, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode kernel needs a CUDA tensor, got "
                         f"{q.device}")
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_table": block_table, "index": index}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"paged decode kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"q, k_pool and v_pool must share a dtype, got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if v_pool.shape != k_pool.shape or k_pool.shape[-1] != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    _check_table(block_table, b)
    if block_table.dtype != torch.int32:
        raise ValueError(f"block_table must be int32, got {block_table.dtype}")
    if d > 256 or bs > 64:
        raise ValueError(f"paged decode kernel takes D <= 256 and "
                         f"block_size <= 64, got D={d}, block_size={bs}")
    lib = _kernels.library("paged_decode")
    out = torch.empty_like(q)
    code = lib.pddl_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), index.data_ptr(), out.data_ptr(),
        b, h, hkv, n, bs, d, t, window or 0, scale_v,
        _KERNEL_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check("paged_decode", code)
    _kernels.launch_counts["paged_decode"] += 1
    return out
