"""Batched LoRA gather-matmul: the device half of per-request adapters
(the port of :mod:`pddl_tpu.ops.lora`).

S-LoRA (Sheng et al., 2023): many low-rank adapters share ONE batched
forward when their factors live in a fixed-shape device pool and each
batch row gathers its own factors by integer row id — the pattern the
serving engine already uses for per-slot sampling parameters and block
tables.

Pool layout (host-side bookkeeping in ``serve/tenant/adapters.py``)::

    pool_a  [P, d, r]   down-projection factors, one row per pool slot
    pool_b  [P, r, V]   up-projection factors (scale pre-folded)

Row 0 is the reserved IDENTITY row (all zeros): a slot on it computes
``(h @ 0) @ 0 == 0`` and adds an exact f32 zero to its logits, so an
unadapted slot in a mixed batch is bitwise the base model.

The adapted matrix is the LM HEAD (``delta_logits = (h @ A) @ B``): K/V
stay pure functions of (prompt, position, base weights), so the prefix
cache and the paged pool keep sharing prompt blocks ACROSS tenants.

The JAX package computes these products in XLA, outside any Pallas
kernel, so here they are plain torch ops (a gather and two batched
matmuls), with no hand-written kernel.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch.nn.utils import parametrize

# The reserved identity pool row (all-zero factors = base model); the
# host-side adapter pool never assigns it.
IDENTITY_ROW = 0


def batched_lora_delta(feats: torch.Tensor, pool_a: torch.Tensor,
                       pool_b: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """Per-row low-rank logit deltas for one fused serving tick.

    Args:
      feats: ``[B, d]`` pre-head features (post-final-norm: the tensor the
        LM head consumes), any float dtype; or ``[B, W, d]``, a window of
        ``W`` positions per row (the speculative verify), every position
        of a row on that row's adapter.
      pool_a: ``[P, d, r]`` pooled down factors.
      pool_b: ``[P, r, V]`` pooled up factors (scale pre-folded).
      rows: ``[B]`` integer pool-row ids (0 = identity / no adapter).

    Returns f32 deltas ``[B, V]`` (or ``[B, W, V]``) to add to the base
    logits, in the JAX order: gather, ``feats`` in f32 times ``a``, then
    times ``b``. A window gathers each row's factors once, where the JAX
    verify repeats the row ids ``W`` times.
    """
    rows = rows.to(device=pool_a.device, dtype=torch.long)
    a = pool_a.index_select(0, rows)  # [B, d, r]
    b = pool_b.index_select(0, rows)  # [B, r, V]
    x = feats.float()
    z = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]), a)  # [B, W, r]
    return torch.bmm(z, b).reshape(*x.shape[:-1], b.shape[-1])


@torch.no_grad()
def adapter_pool_load(pool_a: torch.Tensor, pool_b: torch.Tensor, row: int,
                      a, b) -> None:
    """Write one adapter's factors ``a [d, r]`` / ``b [r, V]`` into pool
    row ``row``, in place. The engine owns the pools. The JAX function
    copies the pools instead; here a load that fails midway (the engine's
    ``adapter_load`` site) leaves its row unassigned, and the next load
    into that row rewrites it whole."""
    pool_a[int(row)].copy_(torch.as_tensor(a, dtype=pool_a.dtype))
    pool_b[int(row)].copy_(torch.as_tensor(b, dtype=pool_b.dtype))


@torch.no_grad()
def merge_lora_into_head(model, a, b):
    """TEST ORACLE: a copy of the port ``model`` (a Llama, or a GPT, whose
    head's bias stays as it is) with one adapter folded into its LM head
    (``W' = W + A @ B``, scale already folded into ``b`` as the pool
    stores it). The port's head weight is ``[V_pad, d]`` (``nn.Linear``'s
    ``[out, in]``), the transpose of the JAX ``lm_head.kernel [d, V_pad]``,
    so ``(A @ B)^T`` lands on its first ``V`` rows. The batched pooled
    apply must be token-exact against ``generate()`` over the merged
    copy. The head must be dense: merge into the dequantized weights of
    an int8 model."""
    if parametrize.is_parametrized(model.head.lm_head, "weight"):
        raise ValueError("merge_lora_into_head needs a dense LM head; "
                         "install the dequantized weights first")
    merged = copy.deepcopy(model)
    weight = merged.head.lm_head.weight
    dt = weight.dtype
    delta = (torch.as_tensor(np.asarray(a), dtype=dt, device=weight.device)
             @ torch.as_tensor(np.asarray(b), dtype=dt,
                               device=weight.device))
    weight[:delta.shape[1]] += delta.T
    return merged
