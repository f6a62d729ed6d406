"""The transformer blocks shared by the GPT and ViT families, the Vision
Transformer itself, and block rematerialization (the port of
:mod:`pddl_tpu.models.vit`).

:class:`MultiHeadAttention` and :class:`TransformerBlock` are the flax
modules' twins: pre-LayerNorm (f32 statistics by flax's fast variance,
:class:`~pddl_tpu_torch.models.layers.LayerNorm`), biased ``query``,
``key``, ``value`` and ``out`` linears (the JAX ``query`` kernel is
``[E, H, D]`` and its bias ``[H, D]``; here ``[H·D, E]`` and ``[H·D]``),
and a two-layer MLP through flax's ``nn.gelu``, whose default is the tanh
approximation (``F.gelu(approximate="tanh")``, not torch's default).
Dropout runs only when ``dropout > 0`` on the training forward (no cache,
``train`` true, the module in training mode), from torch's global
generator. Attention takes three paths, chosen by the cache passed:

- no cache: :func:`~pddl_tpu_torch.ops.attention.flash_attention` with
  ``causal`` (``attention="flash"``: K1, and K2 under a gradient, on the
  card) or :func:`~pddl_tpu_torch.ops.attention.attention_reference`;
- a row cache plus ``cache_index``: the block's K/V written at its
  positions, attention through the plain ``decode_attention``
  (:func:`~pddl_tpu_torch.models.layers.row_attend`);
- a paged pool plus ``cache_index`` and ``block_table``:
  ``paged_cache_insert`` and ``paged_decode_attention``, K4 on the card
  for single-token steps (:func:`~pddl_tpu_torch.models.layers.paged_attend`).

:class:`ViT` takes NHWC images ``[B, H, W, C]``, the layout of the port's
ResNet and its data: a stride-``p`` patch embed (a conv, computed as one
product over the flattened patches), ``pos_embed [1, (H/p)(W/p), E]``,
non-causal blocks, then the head: LayerNorm (flax's default eps 1e-6),
the mean over tokens and the classifier, f32 logits. ``moe_experts > 0``
makes every ``moe_every``-th block from the back a Switch-MoE block
(:class:`~pddl_tpu_torch.ops.moe.SwitchFFN`, GELU experts of width
``mlp_ratio·E``, top-``moe_top_k``). Bound by a
:class:`~pddl_tpu_torch.parallel.TensorParallelStrategy`
(``VIT_TP_RULES``), the attention runs its local heads and ``mlp1`` /
``mlp2`` are column- / row-parallel (``models/layers.py``); GPT's token
embedding and head are vocabulary-parallel.

Sequence parallelism: ``attention="ring"`` or ``"ring_flash"`` with the
port's ``mesh`` attends over its ``seq`` axis; with ``seq`` above 1 each
process keeps its contiguous slice of the patch tokens (and of
``pos_embed``) from the stem on, and the head's mean over tokens is a sum
over the ``seq`` axis divided by the whole token count
(``collectives.seq_sum``), so every process computes the same logits and
the head's gradient is the one-process gradient after the batch's
average (``models/layers.py``). :class:`GPipeViT` (``models/gpipe.py``)
is the pipeline-parallel twin.

The remat policies trade FLOPs for device memory, so longer sequences
and deeper stacks fit:

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
import math
from typing import Dict, Optional, Type, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from pddl_tpu_torch.core.collectives import copy_to_group, seq_sum
from pddl_tpu_torch.device import resolve_device
from pddl_tpu_torch.models.gpipe import GPipeModel
from pddl_tpu_torch.models.layers import (
    LayerNorm,
    SeqShard,
    attend_full,
    check_attention,
    linear,
    paged_attend,
    refuse_mesh_decode,
    row_attend,
    row_linear,
)
from pddl_tpu_torch.ops.attention import host_index
from pddl_tpu_torch.ops.moe import SwitchFFN

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


def moe_of(i: int, depth: int, moe_experts: int, moe_every: int) -> int:
    """Block ``i``'s experts: every ``moe_every``-th block counted from
    the back is routed (the JAX placement)."""
    return moe_experts if (depth - 1 - i) % moe_every == 0 else 0


class MultiHeadAttention(nn.Module):
    """MHA over the port's attention ops (``[B, S, E]`` in and out; module
    docstring). ``jax_shapes`` names the parameters whose JAX shape has
    another rank: the q/k/v biases, DenseGeneral ``[H, D]`` there."""

    def __init__(self, embed_dim: int, num_heads: int, *,
                 attention: str = "flash", causal: bool = False, mesh=None,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed dim {embed_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.attention = attention
        self.mesh = mesh
        self.causal = causal
        self.dtype = dtype
        self.tp_group = None  # the model axis's group once bound
        lin = functools.partial(linear, bias=True, dtype=dtype,
                                param_dtype=param_dtype or dtype,
                                device=device)
        self.query = lin(embed_dim, embed_dim)
        self.key = lin(embed_dim, embed_dim)
        self.value = lin(embed_dim, embed_dim)
        self.out = lin(embed_dim, embed_dim)
        hd = (num_heads, self.head_dim)
        self.jax_shapes = {"query.bias": hd, "key.bias": hd,
                           "value.bias": hd}

    def forward(self, x: torch.Tensor, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Union[int, torch.Tensor, None] = None,
                block_table: Optional[torch.Tensor] = None,
                max_index: Optional[int] = None) -> torch.Tensor:
        b, s, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        x = copy_to_group(x, self.tp_group)
        q, k, v = (lin(x).view(b, s, h, hd).transpose(1, 2)
                   for lin in (self.query, self.key, self.value))
        if cache is None:
            o = attend_full(self.attention, self.mesh, q, k, v,
                            causal=self.causal)
        else:
            refuse_mesh_decode(self.mesh)
            if isinstance(cache_index, torch.Tensor) and cache_index.ndim:
                i = cache_index.to(x.device)
            else:
                i = max_index = host_index(cache_index)
            k, v = k.to(self.dtype), v.to(self.dtype)
            if block_table is not None:
                o = paged_attend(q, k, v, cache, i, block_table, max_index)
            else:
                o = row_attend(q, k, v, cache, i, max_index)
        return row_linear(self.out, o.transpose(1, 2).reshape(b, s, h * hd),
                          self.tp_group)


class TransformerBlock(nn.Module):
    """Pre-LN residual block: LayerNorm → attention → (dropout) → residual,
    LayerNorm → ``mlp1`` → tanh GELU → ``mlp2`` → (dropout) → residual.
    ``train`` is positional (as in the JAX block, and so the remat
    wrapper passes it through); the cache keywords go to the attention."""

    def __init__(self, embed_dim: int, num_heads: int, *, mlp_ratio: int = 4,
                 attention: str = "flash", causal: bool = False,
                 dropout: float = 0.0, moe_experts: int = 0,
                 moe_top_k: int = 1, ln_eps: float = 1e-6, mesh=None,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.dtype = dtype
        self.ln1 = LayerNorm(embed_dim, ln_eps, param_dtype, device)
        self.attn = MultiHeadAttention(
            embed_dim, num_heads, attention=attention, causal=causal,
            mesh=mesh, dtype=dtype, param_dtype=param_dtype, device=device)
        self.ln2 = LayerNorm(embed_dim, ln_eps, param_dtype, device)
        self.drop = nn.Dropout(dropout) if dropout else None
        self.tp_group = None  # the MLP's model-axis group once bound
        if moe_experts:
            self.moe = SwitchFFN(embed_dim, moe_experts, mlp_ratio=mlp_ratio,
                                 top_k=moe_top_k, dtype=dtype,
                                 param_dtype=param_dtype, device=device)
            return
        lin = functools.partial(linear, bias=True, dtype=dtype,
                                param_dtype=param_dtype, device=device)
        self.mlp1 = lin(embed_dim, embed_dim * mlp_ratio)
        self.mlp2 = lin(embed_dim * mlp_ratio, embed_dim)

    def _dropout(self, h, train: bool, cached: bool):
        if self.drop is None or not train or cached or not self.training:
            return h
        return self.drop(h)

    def forward(self, x, train: bool = True, **cache_kw):
        cached = bool(cache_kw)
        h = self.attn(self.ln1(x).to(self.dtype), **cache_kw)
        x = x + self._dropout(h, train, cached)
        h = self.ln2(x).to(self.dtype)
        if hasattr(self, "moe"):
            h = self.moe(h, train and not cached)
        else:
            h = self.mlp1(copy_to_group(h, self.tp_group))
            h = row_linear(self.mlp2, F.gelu(h, approximate="tanh"),
                           self.tp_group)
        return x + self._dropout(h, train, cached)


def init_transformer_weights(model: nn.Module, seed: int) -> None:
    """Draw a GPT's or ViT's weights from a generator seeded with ``seed``:
    every product's weight normal with std ``fan_in ** -0.5`` (the token
    embedding's fan-in is its width), ``pos_embed`` normal with std 0.02
    (flax's initializer), biases 0 and LayerNorm scales 1; a Switch-MoE
    block's by :meth:`~pddl_tpu_torch.ops.moe.SwitchFFN.reset_parameters`.
    A model on the ``meta`` device (shapes only) draws nothing."""
    if model.device.type == "meta":
        return
    draw_transformer_weights(
        model, torch.Generator(device=model.device).manual_seed(seed))


@torch.no_grad()
def draw_transformer_weights(model: nn.Module, gen: torch.Generator) -> None:
    """:func:`init_transformer_weights`'s draws from ``gen``, in
    ``model``'s parameter order (a whole model or one part of it)."""
    for name, p in model.named_parameters():
        if ".moe." in name:
            if name.endswith("moe.router.weight"):
                model.get_submodule(
                    name.split(".moe.")[0] + ".moe").reset_parameters(gen)
            continue
        owner = model.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else model
        if isinstance(owner, LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("pos_embed"):
            p.normal_(0.0, 0.02, generator=gen)
        elif name.endswith("bias"):
            p.zero_()
        else:
            fan_in = p[0].numel()
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)


class _ViTEmbed(nn.Module):
    """Patch embed + positional embedding. The stride-``p`` VALID conv is
    one product of the flattened ``(p, p, C)`` patches with the kernel,
    stored torch-style ``[E, C, p, p]``."""

    def __init__(self, image_size: int, patch_size: int, channels: int,
                 embed_dim: int, dtype, param_dtype, device):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(channels, embed_dim, patch_size,
                                     stride=patch_size, dtype=param_dtype,
                                     device=device)
        grid = image_size // patch_size
        self.pos_embed = nn.Parameter(torch.zeros(
            1, grid * grid, embed_dim, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor,
                seq: Optional[SeqShard] = None) -> torch.Tensor:
        """The patch tokens, all of them or (``seq`` of ``n`` above 1)
        this process's contiguous ``1/n`` of them."""
        b, hh, ww, c = x.shape
        p = self.patch_size
        if hh % p or ww % p:
            raise ValueError(f"image {hh}x{ww} not divisible by patch {p}")
        gh, gw = hh // p, ww // p
        if gh * gw != self.pos_embed.shape[1]:
            raise ValueError(
                f"image {hh}x{ww} gives {gh * gw} patches; pos_embed holds "
                f"{self.pos_embed.shape[1]}")
        dt = self.dtype
        patches = (x.to(dt).reshape(b, gh, p, gw, p, c)
                   .permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c))
        pos = self.pos_embed
        if seq is not None and seq.n > 1:
            if (gh * gw) % seq.n:
                raise ValueError(f"{gh * gw} patch tokens do not split over "
                                 f"a seq axis of {seq.n}")
            s = gh * gw // seq.n
            patches = patches.narrow(1, seq.offset(s), s)
            pos = pos.narrow(1, seq.offset(s), s)
        conv = self.patch_embed
        kernel = conv.weight.permute(0, 2, 3, 1).reshape(conv.out_channels, -1)
        x = F.linear(patches, kernel.to(dt), conv.bias.to(dt))
        return x + pos.to(dt)


class _ViTHead(nn.Module):
    """Final LayerNorm (flax's default eps 1e-6) → mean over tokens →
    classifier, f32 logits (the pooled features with ``num_classes=0``)."""

    def __init__(self, embed_dim: int, num_classes: int, dtype, param_dtype,
                 device):
        super().__init__()
        self.dtype = dtype
        self.ln_final = LayerNorm(embed_dim, 1e-6, param_dtype, device)
        self.head = (linear(embed_dim, num_classes, bias=True, dtype=dtype,
                            param_dtype=param_dtype, device=device)
                     if num_classes else None)

    def forward(self, x: torch.Tensor,
                seq: Optional[SeqShard] = None) -> torch.Tensor:
        x = self.ln_final(x)
        if seq is not None and seq.n > 1:
            x = seq_sum(x.sum(dim=1), seq.group) / (seq.n * x.shape[1])
        else:
            x = x.mean(dim=1)
        if self.head is not None:
            x = self.head(x.to(self.dtype))
        return x.float()


class ViT(nn.Module):
    """Vision Transformer: NHWC images ``[B, H, W, C]`` → f32 logits
    ``[B, num_classes]`` (module docstring). ``image_size`` and
    ``channels`` size the patch grid and the patch embed, which flax
    infers at ``init``. Weights come from :func:`init_transformer_weights`
    on ``device`` (``None`` means ``cuda``)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6,
                 num_classes: int = 1000, mlp_ratio: int = 4,
                 attention: str = "flash", mesh=None, dropout: float = 0.0,
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_every: int = 2, remat: str = "none",
                 image_size: int = 224, channels: int = 3,
                 dtype=torch.float32, param_dtype=None, device=None,
                 seed: int = 0):
        super().__init__()
        check_attention(attention, mesh, moe_experts=moe_experts)
        device = resolve_device(device)
        param_dtype = param_dtype or dtype
        self.mesh = mesh
        self.seq = SeqShard(mesh)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.attention = attention
        self.remat = remat
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.stem = _ViTEmbed(image_size, patch_size, channels, embed_dim,
                              dtype, param_dtype, device)
        block_cls = remat_block(TransformerBlock, remat)
        self.blocks = nn.ModuleList(
            block_cls(embed_dim, num_heads, mlp_ratio=mlp_ratio,
                      attention=attention, dropout=dropout,
                      moe_experts=moe_of(i, depth, moe_experts, moe_every),
                      moe_top_k=moe_top_k, mesh=mesh, dtype=dtype,
                      param_dtype=param_dtype, device=device)
            for i in range(depth))
        self.head = _ViTHead(embed_dim, num_classes, dtype, param_dtype,
                             device)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.head.ln_final.weight.device

    def init_weights(self, seed: int) -> None:
        """Redraw every weight from a generator seeded with ``seed``."""
        init_transformer_weights(self, seed)

    def forward(self, x: torch.Tensor, *, train: bool = True) -> torch.Tensor:
        x = self.stem(x, self.seq)
        for block in self.blocks:
            x = block(x, train)
        return self.head(x, self.seq)


class _ViTStage(nn.Module):
    """One pipeline stage: a run of (non-causal) transformer blocks, one
    structure for every stage."""

    def __init__(self, embed_dim: int, num_heads: int, blocks: int, *,
                 mlp_ratio: int = 4, attention: str = "reference",
                 causal: bool = False, ln_eps: float = 1e-6,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, mlp_ratio=mlp_ratio,
                             attention=attention, causal=causal,
                             ln_eps=ln_eps, dtype=dtype,
                             param_dtype=param_dtype, device=device)
            for _ in range(blocks))

    def forward(self, x):
        for block in self.blocks:
            x = block(x, False)
        return x


class GPipeViT(GPipeModel):
    """Pipeline-parallel ViT: patch embed (replicated) → ``n_stages``
    stages of ``blocks_per_stage`` transformer blocks through the GPipe
    schedule → head (replicated) (``models/gpipe.py``). The JAX
    constructor's arguments plus ``image_size``/``channels`` (flax infers
    them at ``init``), ``device`` and ``seed``; weights are drawn as the
    ViT's (:func:`draw_transformer_weights`), each part from its own
    generator (:meth:`GPipeModel.materialize`)."""

    def __init__(self, *, n_stages: int, blocks_per_stage: int,
                 n_microbatches: int, mesh, patch_size: int = 16,
                 embed_dim: int = 384, num_heads: int = 6,
                 num_classes: int = 1000, mlp_ratio: int = 4,
                 attention: str = "reference", image_size: int = 224,
                 channels: int = 3, dtype=torch.float32, param_dtype=None,
                 device=None, seed: int = 0):
        if attention not in ("flash", "reference"):
            raise ValueError(f"unknown attention {attention!r}")
        device = resolve_device(device)
        param_dtype = param_dtype or dtype
        shell = torch.device("meta")
        super().__init__(
            embed=_ViTEmbed(image_size, patch_size, channels, embed_dim,
                            dtype, param_dtype, shell),
            stages=[_ViTStage(embed_dim, num_heads, blocks_per_stage,
                              mlp_ratio=mlp_ratio, attention=attention,
                              dtype=dtype, param_dtype=param_dtype,
                              device=shell)
                    for _ in range(n_stages)],
            head=_ViTHead(embed_dim, num_classes, dtype, param_dtype,
                          shell),
            n_stages=n_stages, n_microbatches=n_microbatches, mesh=mesh)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.attention = attention
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.materialize(device, draw_transformer_weights, seed)


ViT_S16 = functools.partial(ViT, patch_size=16, embed_dim=384, depth=12,
                            num_heads=6)
ViT_B16 = functools.partial(ViT, patch_size=16, embed_dim=768, depth=12,
                            num_heads=12)
ViT_L16 = functools.partial(ViT, patch_size=16, embed_dim=1024, depth=24,
                            num_heads=16)


def tiny_vit(num_classes: int = 10, **kwargs) -> ViT:
    """Miniature ViT for tests (8x8 patches on 32px inputs)."""
    kwargs.setdefault("patch_size", 8)
    kwargs.setdefault("embed_dim", 32)
    kwargs.setdefault("depth", 2)
    kwargs.setdefault("num_heads", 4)
    kwargs.setdefault("attention", "reference")
    kwargs.setdefault("image_size", 32)
    return ViT(num_classes=num_classes, **kwargs)
