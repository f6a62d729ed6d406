"""Chunked large-vocab softmax cross-entropy: the loss without the logits
(the port of :mod:`pddl_tpu.ops.large_vocab`).

For a large-vocabulary LM the logits dominate peak memory: Llama-1B's
128256-way head over one 8192-token sequence is a 4.2 GB f32 array that
exists only to be consumed by the loss. :func:`chunked_cross_entropy`
fuses the head matmul into the loss: it walks the vocabulary in chunks
keeping a running (online) logsumexp, and its backward recomputes each
chunk's logits from the saved logsumexp rows, so only ``[tokens]`` floats
cross from the forward to the backward, and the largest transient is one
``[tokens, chunk_size]`` chunk.

The products run on the operands' type with f32 accumulation and an f32
result (:func:`_dot_acc32`), as a ``Dense(dtype=bf16)`` head computes its
matmul from bf16 operands while the softmax math stays f32. There is no
kernel here: the JAX package computes all of this in XLA, and the port
leaves the matmuls to torch. The backward updates its per-chunk buffers
in place where that saves memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_PAD_BIAS = -1e30


def _dot_acc32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) on ``a``'s type with f32 accumulation, as f32.

    bf16 operands stay bf16 on the card (cuBLAS with an f32 output); on
    the CPU they are widened first, which gives the same exact products
    summed in f32."""
    b = b.to(a.dtype)
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk(kernel: torch.Tensor, bias: torch.Tensor, c0: int,
           chunk_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Columns ``[c0, c0 + chunk_size)`` of the kernel and bias, the last
    chunk padded to full width: padded classes get a zero kernel column
    and bias -1e30, so their exp underflows to exactly 0 in the sumexp
    (labels never point at them). Only this chunk is padded, never a copy
    of the whole kernel."""
    k_c = kernel[:, c0:c0 + chunk_size]
    b_c = bias[c0:c0 + chunk_size].float()
    pad = chunk_size - k_c.shape[1]
    if pad:
        k_c = F.pad(k_c, (0, pad))
        b_c = F.pad(b_c, (0, pad), value=_PAD_BIAS)
    return k_c, b_c


def _local_labels(labels: torch.Tensor, c0: int, chunk_size: int):
    """Each label's column in the chunk at ``c0`` (clipped) and whether it
    falls in that chunk."""
    local = labels - c0
    in_chunk = (local >= 0) & (local < chunk_size)
    return local.clamp(0, chunk_size - 1), in_chunk


class _ChunkedCE(torch.autograd.Function):
    """Mean token CE of ``features [N, E] @ kernel [E, V] + bias [V]``
    against ``labels [N]``; saves ``(features, kernel, bias, labels, lse)``."""

    @staticmethod
    def forward(ctx, features, kernel, bias, labels, chunk_size):
        n = features.shape[0]
        v = kernel.shape[1]
        dev = features.device
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
        s = torch.zeros(n, dtype=torch.float32, device=dev)
        lab = torch.zeros(n, dtype=torch.float32, device=dev)
        for c0 in range(0, v, chunk_size):
            k_c, b_c = _chunk(kernel, bias, c0, chunk_size)
            logits = _dot_acc32(features, k_c).add_(b_c)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            local, in_chunk = _local_labels(labels, c0, chunk_size)
            gathered = logits.gather(1, local[:, None])[:, 0]
            lab = torch.where(in_chunk, gathered, lab)
            s = s * torch.exp(m - m_new) + logits.sub_(
                m_new[:, None]).exp_().sum(dim=-1)
            m = m_new
            del logits
        lse = m + torch.log(s)
        ctx.save_for_backward(features, kernel, bias, labels, lse)
        ctx.chunk_size = chunk_size
        return (lse - lab).mean()

    @staticmethod
    def backward(ctx, g):
        features, kernel, bias, labels, lse = ctx.saved_tensors
        chunk_size = ctx.chunk_size
        n, e = features.shape
        v = kernel.shape[1]
        scale = g / n  # d(mean)/d(token)
        rows = torch.arange(n, device=features.device)
        dfeat = torch.zeros(n, e, dtype=torch.float32, device=features.device)
        dk, db = [], []
        for c0 in range(0, v, chunk_size):
            k_c, b_c = _chunk(kernel, bias, c0, chunk_size)
            # This chunk's probabilities, recomputed from the saved LSE,
            # turned in place into delta = (p - onehot) * scale.
            delta = _dot_acc32(features, k_c).add_(b_c).sub_(
                lse[:, None]).exp_()
            local, in_chunk = _local_labels(labels, c0, chunk_size)
            delta[rows[in_chunk], local[in_chunk]] -= 1.0
            delta.mul_(scale)
            # The backward's products run on the features' type too (the
            # cotangent of a bf16 Dense is bf16), accumulating in f32.
            delta_d = delta.to(features.dtype)
            dfeat += _dot_acc32(delta_d, k_c.t())
            width = min(chunk_size, v - c0)
            dk.append(_dot_acc32(features.t(), delta_d)[:, :width])
            db.append(delta.sum(dim=0)[:width])
            del delta, delta_d
        return (dfeat.to(features.dtype), torch.cat(dk, 1).to(kernel.dtype),
                torch.cat(db).to(bias.dtype), None, None)


def chunked_cross_entropy(features: torch.Tensor, kernel: torch.Tensor,
                          labels: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          chunk_size: int = 8192) -> torch.Tensor:
    """Mean token CE of ``softmax(features @ kernel + bias)`` against
    ``labels`` without materializing the logits.

    Args:
      features: ``[..., E]`` pre-head activations (any leading dims).
      kernel: ``[E, V]`` LM-head weight (the JAX package's convention).
      labels: integer ``[...]`` matching the leading dims.
      bias: optional ``[V]``.
      chunk_size: vocabulary slab per step; the largest transient is
        ``tokens x chunk_size`` floats. V is padded to a multiple, one
        chunk at a time.

    Returns the scalar mean cross-entropy (f32). Gradients flow to
    features, kernel and bias through a ``torch.autograd.Function`` that
    recomputes each chunk's logits from the saved logsumexp.
    """
    e = features.shape[-1]
    flat = features.reshape(-1, e)
    flat_labels = labels.reshape(-1).long()
    if bias is None:
        bias = torch.zeros(kernel.shape[-1], dtype=torch.float32,
                           device=kernel.device)
    # Never walk wider than the vocab: a small head would otherwise pad up
    # to a full default-width chunk and waste the extra matmul FLOPs.
    chunk_size = min(chunk_size, kernel.shape[-1])
    return _ChunkedCE.apply(flat, kernel, bias, flat_labels, chunk_size)
