"""Rotary position embeddings (RoPE) for the Llama family, in PyTorch
(the port of :mod:`pddl_tpu.ops.rope`).

Convention: the half-split ("rotate_half") layout of HF ``transformers``'
Llama — the head dim splits into halves ``[x1, x2]`` rotated as
``[x1·cos − x2·sin, x2·cos + x1·sin]`` with the frequency vector
concatenated twice (not interleaved). Angles are computed in f32 whatever
the activation dtype (bf16 angles corrupt long-range positions); the
rotation runs in f32 and is cast back to the input's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, *,
                 theta: float = 10000.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` f32 tables of shape ``positions.shape + (head_dim,)``
    for integer ``positions`` (any shape), HF layout: frequencies for the
    first half, duplicated for the second."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    angles = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., S, D]`` by per-position ``(cos, sin)`` tables that
    broadcast against it; computed in f32, returned in ``x.dtype``."""
    xf = x.to(torch.float32)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def apply_rope_qk(q: torch.Tensor, k: torch.Tensor,
                  positions: torch.Tensor, *, theta: float = 10000.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply RoPE to query/key ``[B, H, S, D]`` at integer ``positions``:
    ``[S]`` (shared across the batch) or ``[B, S]`` (per-row positions —
    the serving engine's slots, each at its own depth). q and k may carry
    different head counts (GQA); the same tables broadcast over both."""
    cos, sin = rope_cos_sin(positions, q.shape[-1], theta=theta)
    if positions.ndim == 2:  # [B, S, D] -> [B, 1, S, D] over heads
        cos, sin = cos[:, None], sin[:, None]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
