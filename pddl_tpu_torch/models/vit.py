"""Block rematerialization for the transformer families (the port of the
remat helpers of :mod:`pddl_tpu.models.vit`).

Only :data:`REMAT_POLICIES` and :func:`remat_block` live here so far; the
ViT itself comes with ROADMAP.md queue 1 item 4. The policies trade
FLOPs for device memory, so longer sequences and deeper stacks fit:

- ``none``: store every activation (fastest, most memory);
- ``dots``: save the matmul outputs, recompute the rest of the block in
  the backward (``jax.checkpoint_policies.checkpoint_dots``);
- ``full``: save only the block's input, recompute everything inside it
  (``jax.checkpoint`` with no policy).

A wrapped block runs under ``torch.utils.checkpoint.checkpoint`` with
``use_reentrant=False``; ``dots`` passes a selective-checkpoint
``context_fn`` that marks ``aten.mm``, ``aten.addmm`` and ``aten.bmm``
MUST_SAVE and every other op PREFER_RECOMPUTE. As under JAX's
``checkpoint_dots``, the hand-written attention kernels are not matmul
ops, so their forward runs again in the backward.
"""

from __future__ import annotations

import functools
from typing import Type

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default})


def _checkpoint_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the output of every matmul, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# name -> checkpoint context_fn (None: save nothing inside the block).
REMAT_POLICIES = {
    "none": "none",  # sentinel: no wrapping at all
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _checkpoint_dots),
    "full": None,
}


def remat_block(block_cls: Type[nn.Module], remat: str) -> Type[nn.Module]:
    """Wrap a transformer block class per the named remat policy.

    The wrapped class keeps the block's parameters and their names. Its
    forward goes through the checkpoint when a gradient is being taken
    and the call passes no keyword arguments; a call with keyword
    arguments (the decode path's cache) or under ``torch.no_grad()`` runs
    the block as it is, as the JAX package's decode path never remats.
    """
    if remat not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {remat!r}; known: {sorted(REMAT_POLICIES)}"
        )
    if remat == "none":
        return block_cls
    extra = {} if REMAT_POLICIES[remat] is None else {
        "context_fn": REMAT_POLICIES[remat]}

    class Remat(block_cls):
        def forward(self, x, *args, **kwargs):
            if kwargs or not torch.is_grad_enabled():
                return super().forward(x, *args, **kwargs)
            return checkpoint(super().forward, x, *args, use_reentrant=False,
                              **extra)

    Remat.__name__ = Remat.__qualname__ = f"Remat{block_cls.__name__}"
    return Remat
