"""Tensor- and expert-parallel strategies: Megatron weight sharding over
the ``model`` axis and expert sharding over the ``expert`` axis (the port
of :mod:`pddl_tpu.parallel.tensor_parallel`).

The rule tables are the JAX package's, regexes over the JAX parameter
paths (``/block3/attn/query/kernel``), and :meth:`_spec_for` is its
canonical form: the first matching rule wins, a dimension that does not
tile its axis replicates the leaf with a warning, and axes of size 1 drop
out, so a spec is a tuple of axis names (or ``None``) per JAX dimension,
``()`` for a replicated leaf. Each port parameter is judged by its JAX
path and JAX shape (:func:`jax_leaves`: a torch ``Linear`` is
``[out, in]`` where the JAX kernel is ``[in, out]``, a q/k/v weight is
``[H·D, E]`` where the JAX kernel is ``[E, H, D]``), and a sharded JAX
dimension maps to the port dimension that holds it.

One process drives one device. :meth:`TensorParallelStrategy.bind`
replaces each matched parameter by this process's block of it and tells
each module its local heads, widths or experts and its group; the modules
then place Megatron's collectives themselves
(:func:`~pddl_tpu_torch.core.collectives.copy_to_group` before a
column-parallel product, :func:`~pddl_tpu_torch.core.collectives.reduce_from_group`
after a row-parallel one, the bias added once after the sum,
:func:`~pddl_tpu_torch.core.collectives.gather_from_group` over
vocabulary-sharded logits). The two all-reduces a transformer block makes
are the ones XLA places under the JAX strategy. An attention whose query
heads shard but whose K/V or output projection does not (a GQA count
that does not tile the axis) raises ``NotImplementedError``.

The batch is split over ``data`` only, as JAX's ``batch_sharding`` does:
every process is fed the global batch and takes its data position's rows,
so the processes along ``model`` and ``expert`` see the same rows. Every
gradient is averaged over ``data``; a sharded parameter's gradient is
never reduced over ``model`` or ``expert`` (each position holds its own
block's whole gradient, the replicated parameters' gradients are equal
along the axes). The global gradient norm, for clipping and
``log_grad_norm``, sums a sharded parameter's square sum over its axis
and counts a replicated one once. Optimizer moments and EMA shadows are
made from the bound parameters, so they live on the shard.

:meth:`decode_cache_sharding` is the JAX rule for the KV cache: K/V heads
split over ``model`` when they tile it, which the bound attention's local
K/V heads already are (``generate(strategy=)``'s cache is
``[B, H_kv/m, L, D]`` a process).

Checkpoints are world-size free (``ckpt/checkpoint.py``): a save gathers
every sharded parameter, moment and shadow whole along its axis and rank
0 writes; :meth:`local_state` cuts a whole tensor back to this process's
block on restore.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import re
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from pddl_tpu_torch.core import collectives
from pddl_tpu_torch.core.mesh import (
    EXPERT_AXIS,
    MODEL_AXIS,
    STAGE_AXIS,
    MeshConfig,
)
from pddl_tpu_torch.parallel.base import Strategy, register_strategy

log = logging.getLogger(__name__)

# The strategy each bound model is bound to (weak: a model's copy, or the
# model once dropped, is not).
_BOUND: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

# A spec: one axis name (or None) per JAX dimension; () is replicated.
Spec = Tuple[Optional[str], ...]
# A rule: (path regex, fn(JAX shape) -> Spec, or None to pass).
Rule = Tuple[str, Callable[[Tuple[int, ...]], Optional[Spec]]]


def _shard_dim(dim: int, axis: str = MODEL_AXIS):
    """Spec factory: shard dimension ``dim`` of the leaf over ``axis``."""

    def spec(shape: Tuple[int, ...]) -> Optional[Spec]:
        if dim >= len(shape):
            return None
        axes: list = [None] * len(shape)
        axes[dim] = axis
        return tuple(axes)

    return spec


def _shard_heads(shape: Tuple[int, ...]) -> Optional[Spec]:
    """q/k/v DenseGeneral leaves: kernel (E, H, D) / bias (H, D) — shard H
    (the second-to-last dim)."""
    if len(shape) < 2:
        return None
    return _shard_dim(len(shape) - 2)(shape)


def _replicated(shape: Tuple[int, ...]) -> Spec:
    return ()


# Megatron layout for the ViT/GPT module names (the JAX table).
VIT_TP_RULES: Sequence[Rule] = (
    (r"/attn/(query|key|value)/", _shard_heads),          # column-parallel
    (r"/attn/out/kernel", _shard_dim(0)),                 # row-parallel
    (r"/attn/out/bias", _replicated),
    (r"/mlp1/kernel", _shard_dim(1)),                     # column-parallel
    (r"/mlp1/bias", _shard_dim(0)),
    (r"/mlp2/kernel", _shard_dim(0)),                     # row-parallel
    (r"/mlp2/bias", _replicated),
    (r"/token_embed/embedding", _shard_dim(0)),           # vocab-parallel
    (r"/lm_head/kernel", _shard_dim(1)),
    (r"/lm_head/bias", _shard_dim(0)),
)

# The Llama family: SwiGLU gate/up column-parallel, down row-parallel,
# Llama's embedding name, then the ViT/GPT table for attention and head.
LLAMA_TP_RULES: Sequence[Rule] = (
    (r"/mlp_(gate|up)/kernel", _shard_dim(1)),            # column-parallel
    (r"/mlp_down/kernel", _shard_dim(0)),                 # row-parallel
    (r"/embed/embedding", _shard_dim(0)),                 # vocab-parallel
) + tuple(VIT_TP_RULES)

# Expert parallelism: expert-major MoE weights shard dim 0 over `expert`;
# the router stays replicated. Composes with the TP rules.
VIT_EP_RULES: Sequence[Rule] = (
    (r"/moe/(w1|w2|w3|b1|b2)", _shard_dim(0, EXPERT_AXIS)),
    (r"/moe/router/", _replicated),
) + tuple(VIT_TP_RULES)

LLAMA_EP_RULES: Sequence[Rule] = (
    (r"/moe/(w1|w2|w3|b1|b2)", _shard_dim(0, EXPERT_AXIS)),
    (r"/moe/router/", _replicated),
) + tuple(LLAMA_TP_RULES)


# ------------------------------------------------------- JAX paths and shapes
@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """A port parameter seen as its JAX leaf: the path, the shape, and
    the port dimension holding each JAX dimension (``None``: no single
    port dimension does)."""

    path: str
    shape: Tuple[int, ...]
    port_dims: Tuple[Optional[int], ...]
    # A pipeline stage's parameter: the stage (JAX: its slice of the
    # stacked [n_stages, ...] leaf, whose stage dim has no port dim).
    stage: Optional[int] = None


def _leaf_of(owner: nn.Module, local: str, p: torch.Tensor,
             heads: Optional[int]) -> Tuple[str, Tuple[int, ...],
                                            Tuple[Optional[int], ...]]:
    shape = tuple(p.shape)
    if isinstance(owner, nn.Embedding):
        return "embedding", shape, (0, 1)
    if isinstance(owner, nn.Conv2d):
        if local == "bias":
            return "bias", shape, (0,)
        e, c, kh, kw = shape
        return "kernel", (kh, kw, c, e), (2, 3, 1, 0)
    if isinstance(owner, nn.Linear):
        if local == "bias":
            if heads is not None:
                return "bias", (heads, shape[0] // heads), (0, None)
            return "bias", shape, (0,)
        if heads is not None:
            return ("kernel", (shape[1], heads, shape[0] // heads),
                    (1, 0, None))
        return "kernel", (shape[1], shape[0]), (1, 0)
    if local == "weight":  # RMSNorm / LayerNorm scales
        return "scale", shape, (0,)
    return local, shape, tuple(range(len(shape)))


def jax_leaves(model: nn.Module) -> Dict[str, JaxLeaf]:
    """``{port parameter name: JaxLeaf}`` for a port Llama, GPT or ViT
    (whole: call before :meth:`TensorParallelStrategy.bind`). The paths
    are the JAX params tree's (``/block{i}/...``; the stem's and head's
    leaves at the top, as ``share_scope`` keeps them). For a GPipe model
    (``models/gpipe.py``) they are the JAX GPipe tree's: ``/embed/...``,
    ``/head/...``, and ``/stages/block{j}/...`` for every stage's
    parameter, whose JAX leaf is the stacked ``[n_stages, ...]`` one."""
    gpipe = hasattr(model, "stages") and hasattr(model, "n_stages")
    out = {}
    for name, p in model.named_parameters():
        mod_name, local = name.rsplit(".", 1) if "." in name else ("", name)
        owner = model.get_submodule(mod_name) if mod_name else model
        parts = mod_name.split(".") if mod_name else []
        stage = None
        if gpipe and parts and parts[0] == "stages":
            stage, parts = int(parts[1]), ["stages"] + parts[2:]
        elif parts and parts[0] in ("stem", "head") and not gpipe:
            parts = parts[1:]
        at = 1 if stage is not None else 0
        if len(parts) >= at + 2 and parts[at] == "blocks":
            parts = parts[:at] + [f"block{parts[at + 1]}"] + parts[at + 2:]
        heads = None
        if parts and parts[-1] in ("query", "key", "value") and len(parts) > 1:
            attn = model.get_submodule(mod_name.rsplit(".", 1)[0])
            heads = (attn.num_heads if parts[-1] == "query"
                     else getattr(attn, "num_kv_heads", attn.num_heads))
        leaf, shape, dims = _leaf_of(owner, local, p, heads)
        if stage is not None:
            shape, dims = (model.n_stages,) + shape, (None,) + dims
        out[name] = JaxLeaf("/" + "/".join(parts + [leaf]), shape, dims,
                            stage)
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a port parameter lives: its JAX leaf, its canonical spec,
    and (when sharded) the port dimension cut, the axis, the axis size
    and this process's block index."""

    leaf: JaxLeaf
    spec: Spec
    dim: Optional[int] = None
    axis: Optional[str] = None
    count: int = 1
    index: int = 0

    @property
    def stage(self) -> Optional[int]:
        """The pipeline stage of a stage's parameter (else None)."""
        return self.leaf.stage


@register_strategy("tensor_parallel")
class TensorParallelStrategy(Strategy):
    """DP x TP over a ``data`` x ``model`` mesh of processes.

    Args:
      model_parallel: size of the ``model`` axis (the remaining processes
        go to ``data``).
      rules: the path-rule table; the ViT family's Megatron layout by
        default (``LLAMA_TP_RULES`` for the Llama family).
      coordinator_address / num_processes / process_id: the bootstrap
        (:func:`pddl_tpu_torch.core.dist.initialize`).
      device / backend: this process's device and the groups' backend
        (two processes sharing one card take gloo).
    """

    def __init__(self, model_parallel: int = 1,
                 rules: Sequence[Rule] = VIT_TP_RULES,
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None, *, device=None,
                 backend: Optional[str] = None):
        super().__init__(MeshConfig(data=-1, model=model_parallel),
                         device=device, backend=backend)
        self.rules = [(re.compile(pat), fn) for pat, fn in rules]
        self._bootstrap = (coordinator_address, num_processes, process_id)
        self._bound: Dict[str, Placement] = {}
        self._targets: Dict[torch.Tensor, str] = {}

    def _initialize(self):
        return super()._initialize(*self._bootstrap)

    # -- the rules ---------------------------------------------------------
    def _spec_for(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """The JAX strategy's canonical spec for a leaf (module
        docstring)."""
        sizes = self.mesh.shape
        for pat, fn in self.rules:
            if pat.search(path):
                spec = fn(shape)
                if spec is None:
                    continue
                for i, ax in enumerate(spec):
                    if ax is None:
                        continue
                    if shape[i] % sizes[ax]:
                        log.warning(
                            "rule %s matched %s but dim %d (%d) is not "
                            "divisible by %s axis %d; leaf replicated",
                            pat.pattern, path, i, shape[i], ax, sizes[ax])
                        return ()
                axes = [ax if ax is not None and sizes[ax] > 1 else None
                        for ax in spec]
                while axes and axes[-1] is None:
                    axes.pop()
                return tuple(axes)
        return ()

    def placements(self, model: nn.Module) -> Dict[str, Placement]:
        """Each parameter's placement (of the whole model: before
        :meth:`bind`; after it, the bound placements)."""
        if _BOUND.get(model) is self:
            return dict(self._bound)
        out = {}
        for name, leaf in jax_leaves(model).items():
            spec = self._spec_for(leaf.path, leaf.shape)
            # The stage axis is the stage's module, not a dimension.
            sharded = [(i, ax) for i, ax in enumerate(spec)
                       if ax and ax != STAGE_AXIS]
            if not sharded:
                out[name] = Placement(leaf, spec)
                continue
            (jd, axis), = sharded
            dim = leaf.port_dims[jd]
            if dim is None:
                raise NotImplementedError(
                    f"{name}: JAX dim {jd} of {leaf.path} has no port "
                    "dimension of its own")
            out[name] = Placement(leaf, spec, dim, axis,
                                  self.mesh.shape[axis],
                                  self.mesh.axis_index(axis))
        return out

    # -- binding -----------------------------------------------------------
    @torch.no_grad()
    def bind(self, model: nn.Module) -> None:
        """Cut ``model``'s sharded parameters to this process's blocks
        (new ``Parameter`` s) and tell its modules their local heads,
        widths, experts and groups. Idempotent for this strategy."""
        if _BOUND.get(model) is self:
            return
        if model in _BOUND:
            raise ValueError("the model is bound to another strategy")
        super().bind(model)
        placed = self._placements_to_bind(model)
        for name, pl in placed.items():
            if pl.axis is None:
                continue
            mod_name, local = name.rsplit(".", 1)
            owner = model.get_submodule(mod_name)
            p = getattr(owner, local)
            size = p.shape[pl.dim] // pl.count
            block = p.detach().narrow(pl.dim, pl.index * size, size).clone()
            setattr(owner, local, nn.Parameter(block,
                                               requires_grad=p.requires_grad))
        self._bound = placed
        _configure(model, placed, self.mesh)
        self._targets = {model.get_parameter(n): n
                         for n, pl in placed.items() if pl.axis}
        _BOUND[model] = self

    def _placements_to_bind(self, model: nn.Module) -> Dict[str, Placement]:
        return self.placements(model)

    def shard_model(self, model: nn.Module) -> nn.Module:
        """``model`` if it is bound to this strategy, else a bound copy
        (``model`` itself left whole)."""
        if _BOUND.get(model) is self:
            return model
        sharded = copy.deepcopy(model)
        self.bind(sharded)
        return sharded

    def decode_cache_sharding(self, kv_heads: int) -> Optional[str]:
        """The JAX rule for a ``[B, H, L, D]`` cache leaf: heads over
        ``model`` when the axis is above 1 and divides them, else
        replicated (``None``)."""
        mp = self.mesh.shape[MODEL_AXIS]
        return MODEL_AXIS if mp > 1 and kv_heads % mp == 0 else None

    # -- the step ----------------------------------------------------------
    @property
    def data_process_count(self) -> int:
        return 1

    @property
    def save_group(self):
        """Every process of the mesh: a save is one for all of them."""
        return self.mesh.world_group

    def _axis_sum(self, axis: str):
        group = self.mesh.axis_group(axis)

        def total(x: torch.Tensor) -> torch.Tensor:
            return collectives.psum(x, group)

        return total

    def make_optimizer(self, model, optimizer, learning_rate, **options):
        """The optimizer over the bound (sharded) parameters; the clip
        norm and ``lamb``/``lars`` trust ratios sum a sharded leaf's
        square sum over its axis."""
        opt = super().make_optimizer(model, optimizer, learning_rate,
                                     **options)
        if hasattr(opt, "shard_sums"):
            opt.shard_sums = {p: self._axis_sum(self._bound[n].axis)
                              for p, n in self._targets.items()
                              if self.mesh.axis_group(self._bound[n].axis)
                              is not None}
        return opt

    def grad_norm(self, model: nn.Module) -> torch.Tensor:
        """The global L2 norm of the gradients (module docstring)."""
        by_axis: Dict[Optional[str], list] = {}
        for name, p in model.named_parameters():
            if p.grad is None:
                continue
            pl = self._bound.get(name)
            axis = pl.axis if pl is not None else None
            by_axis.setdefault(axis, []).append(p.grad.float().square().sum())
        total = None
        for axis, sums in by_axis.items():
            sq = torch.stack(sums).sum()
            if axis is not None and self.mesh.axis_group(axis) is not None:
                sq = collectives.psum(sq, self.mesh.axis_group(axis))
            total = sq if total is None else total + sq
        return total.sqrt()

    # -- checkpoints -------------------------------------------------------
    def sharded_targets(self) -> Dict[torch.Tensor, str]:
        """This process's blocks, each by its parameter's name."""
        return dict(self._targets)

    def sharded_names(self) -> Dict[str, Placement]:
        return {n: pl for n, pl in self._bound.items() if pl.axis}

    def whole_state(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """A tensor of parameter ``name`` (the parameter, a moment, a
        shadow) whole from every position's block along its axis (a
        collective over the axis)."""
        pl = self._bound[name]
        return collectives.all_gather(part.contiguous(),
                                      self.mesh.axis_group(pl.axis),
                                      axis=pl.dim, tiled=True)

    def local_state(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This process's block of a whole tensor of parameter ``name``;
        a parameter the strategy does not shard keeps it whole."""
        pl = self._bound.get(name)
        if pl is None or pl.axis is None or whole.ndim <= pl.dim:
            return whole
        size = whole.shape[pl.dim] // pl.count
        return whole.narrow(pl.dim, pl.index * size, size).clone()

    def gather_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The bound model's ``state_dict`` whole (a collective)."""
        return {k: self.whole_state(k, v) if k in self._targets.values()
                else v for k, v in model.state_dict().items()}

    def __repr__(self) -> str:
        shape = self.mesh.shape
        return (f"{type(self).__name__}(data={shape['data']}, "
                f"model={shape[MODEL_AXIS]}, expert={shape[EXPERT_AXIS]})")


@register_strategy("expert_parallel")
class ExpertParallelStrategy(TensorParallelStrategy):
    """DP x EP (x TP) over a ``data`` x ``expert`` (x ``model``) mesh.

    Expert-major MoE weights shard dim 0 over ``expert``; every other
    weight follows the Megatron rules over ``model`` (size 1 unless
    ``model_parallel`` is raised), so EP and TP compose in one table.
    """

    def __init__(self, expert_parallel: int, model_parallel: int = 1,
                 rules: Sequence[Rule] = VIT_EP_RULES, **kwargs):
        super().__init__(model_parallel=model_parallel, rules=rules,
                         **kwargs)
        self._mesh_config = MeshConfig(data=-1, model=model_parallel,
                                       expert=expert_parallel)


# ------------------------------------------------------ module configuration
def _axis_of(placed, prefix: str, leaf: str) -> Optional[str]:
    pl = placed.get(f"{prefix}.{leaf}" if prefix else leaf)
    return None if pl is None else pl.axis


def _configure(model: nn.Module, placed: Dict[str, Placement], mesh) -> None:
    """Tell each module of a bound model how it is split."""
    from pddl_tpu_torch.ops.moe import SwitchFFN  # noqa: PLC0415

    group = mesh.axis_group(MODEL_AXIS)
    for prefix, m in model.named_modules():
        def axis(leaf):
            return _axis_of(placed, prefix, leaf)

        if isinstance(m, SwitchFFN):
            if axis("w1") is not None:
                n_local = m.w1.shape[0]
                m.bind_experts(mesh.axis_group(EXPERT_AXIS),
                               mesh.axis_index(EXPERT_AXIS) * n_local,
                               n_local)
            continue
        if all(hasattr(m, a) for a in ("query", "key", "value", "out")):
            cut = [axis(f"{n}.weight") is not None
                   for n in ("query", "key", "value", "out")]
            if any(cut) and not all(cut):
                raise NotImplementedError(
                    f"{prefix}: the query, key, value and output "
                    f"projections split {cut} over the model axis; only "
                    "an attention split whole by heads (or kept whole) "
                    "runs here")
            if all(cut):
                mp = mesh.shape[MODEL_AXIS]
                m.num_heads //= mp
                if hasattr(m, "num_kv_heads"):
                    m.num_kv_heads //= mp
                m.tp_group = group
            continue
        for col in ("mlp_gate", "mlp1"):  # and mlp_down / mlp2 with it
            if hasattr(m, col) and axis(f"{col}.weight") is not None:
                m.tp_group = group
        for emb in ("embed", "token_embed"):
            if hasattr(m, emb) and axis(f"{emb}.weight") is not None:
                m.vocab_group = group
                m.vocab_offset = (mesh.axis_index(MODEL_AXIS)
                                  * getattr(m, emb).weight.shape[0])
        if hasattr(m, "lm_head") and axis("lm_head.weight") is not None:
            m.vocab_group = group
    if hasattr(model, "cache_kv_heads") and len(model.blocks):
        attn = model.blocks[0].attn
        model.cache_kv_heads = getattr(attn, "num_kv_heads", attn.num_heads)
