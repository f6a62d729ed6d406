"""Pipeline-parallel strategy: DP x PP (x TP) over a ``data`` x ``stage``
(x ``model``) mesh of processes (the port of
:mod:`pddl_tpu.parallel.pipeline`).

The rule tables are the JAX package's over the JAX GPipe tree's paths
(``tensor_parallel.jax_leaves``): every leaf under ``/stages/`` shards its
leading (stage) dim over ``stage``, and under :data:`PIPELINE_TP_RULES`
the Megatron layout applies to the rest of a staged block's weight,
shifted right by one; the embed and head replicate. In the port the
stage dim is the stage's module: a
:class:`~pddl_tpu_torch.models.gpipe.GPipeModel` built on the strategy's
mesh holds this process's stage only (the others are empty
placeholders), and :meth:`PipelineStrategy.bind` cuts its
Megatron-sharded weights to this process's block on ``model``, as
:class:`~pddl_tpu_torch.parallel.tensor_parallel.TensorParallelStrategy`
does. The schedule is :func:`pddl_tpu_torch.ops.pipeline.gpipe_apply`.

The step: every process of a ``data`` position is fed the global batch
and takes that position's rows; the head and the loss run on every stage
from the pipeline's outputs. The gradients are averaged over ``data``.
The replicated embed and head are counted once: the embed's gradient
exists on stage 0 only (the others' inputs never reach a stage) and the
head's is taken from the last stage, each broadcast over ``stage``, so
both stay equal on every process. The global gradient norm sums a
stage's squares over ``stage`` (and a Megatron block's over ``model``).

Checkpoints (:meth:`whole_trainer_state`): a save holds the sequential
model's state, every stage's blocks under ``stages.{i}.…`` (the JAX
stacked leaf's slice ``i`` through :mod:`pddl_tpu_torch.bridge`) and the
optimizer's per-parameter state in that model's order, gathered over
``stage`` and ``model``; rank 0 writes it. It restores bitwise into one
process's whole model, and :meth:`local_trainer_state` cuts it back to a
process's stage and block. A wrapped update rule (the bf16 rules,
schedules, clipping, accumulation: ``train/mixed_precision.py``,
``train/state.py``) saves its own state around the inner rule's: the
per-parameter lists (accumulators, ``f32_master`` masters) in the
sequential model's order like the moments, the counters as they are, and
a stochastic-rounding generator's state by stage (``generator`` holds
stage 0's, which a one-process restore takes).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pddl_tpu_torch.core import collectives
from pddl_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    STAGE_AXIS,
    MeshConfig,
)
from pddl_tpu_torch.parallel.base import Strategy, register_strategy
from pddl_tpu_torch.parallel.tensor_parallel import (
    Placement,
    Rule,
    Spec,
    TensorParallelStrategy,
    VIT_TP_RULES,
    _shard_dim,
)
from pddl_tpu_torch.train.mixed_precision import OptimizerWrapper

# Stage-stacked parameter trees live under a "stages" key; everything in
# them shards its leading (stage) dim. Embed/head params fall through the
# rule table and replicate.
PIPELINE_RULES: Sequence[Rule] = (
    (r"/stages/", _shard_dim(0, STAGE_AXIS)),
)


def _stage_shifted(fn: Callable) -> Callable:
    """Lift a TP spec rule onto stage-stacked leaves: the leading dim
    shards over ``stage``, the TP spec applies to the rest."""

    def spec(shape: Tuple[int, ...]) -> Optional[Spec]:
        if len(shape) < 2:
            return None
        inner = fn(shape[1:])
        if inner is None:
            return None
        return (STAGE_AXIS,) + tuple(inner)

    return spec


# 3D parallelism (DP x PP x TP): staged block weights shard over BOTH
# `stage` (leading dim) and `model` (the Megatron layout, shifted right by
# one); anything else under /stages/ (LayerNorms, ...) shards over `stage`
# only; embed/head fall through and replicate.
PIPELINE_TP_RULES: Sequence[Rule] = tuple(
    (r"/stages/.*" + pat.lstrip("/"), _stage_shifted(fn))
    for pat, fn in VIT_TP_RULES
) + tuple(PIPELINE_RULES)


def _every(p: torch.Tensor) -> bool:
    return True


def _bf16(p: torch.Tensor) -> bool:
    """A target ``ParamUpdate`` runs through an f32 proxy."""
    return p.dtype == torch.bfloat16


def _is_stage(name: str) -> bool:
    return name.startswith("stages.")


def _restage(name: str, stage: int) -> str:
    """``stages.{j}.rest`` as stage ``stage``'s name."""
    return f"stages.{stage}." + name.split(".", 2)[2]


@register_strategy("pipeline")
class PipelineStrategy(TensorParallelStrategy):
    """DP x PP (x TP): batch over ``data``, stage weights over ``stage``,
    optionally Megatron TP over ``model`` inside each stage.

    Args:
      n_stages: size of the ``stage`` mesh axis (remaining processes form
        the ``data`` axis).
      model_parallel: TP degree inside each stage; >1 switches the default
        rule table to the combined 3D layout (``PIPELINE_TP_RULES``).
      seq_parallel: a ``seq`` axis beside ``stage``: a ring GPipe model
        built on the mesh runs each stage on its sequence slice.
      rules, coordinator_address, num_processes, process_id, device,
        backend: as :class:`TensorParallelStrategy`'s.
    """

    def __init__(self, n_stages: int, model_parallel: int = 1,
                 rules: Optional[Sequence[Rule]] = None, **kwargs):
        if rules is None:
            rules = PIPELINE_TP_RULES if model_parallel > 1 else PIPELINE_RULES
        super().__init__(model_parallel=model_parallel, rules=rules, **kwargs)
        self._mesh_config = MeshConfig(
            data=-1, model=model_parallel, stage=n_stages,
            seq=self.seq_parallel)
        self.n_stages = n_stages

    # -- binding -----------------------------------------------------------
    def _placements_to_bind(self, model: nn.Module) -> Dict[str, Placement]:
        from pddl_tpu_torch.models.gpipe import GPipeModel  # noqa: PLC0415

        if not isinstance(model, GPipeModel):
            raise TypeError("PipelineStrategy runs a GPipe model "
                            f"(models/gpipe.py), got {type(model).__name__}")
        if model.n_stages != self.mesh.shape[STAGE_AXIS]:
            raise ValueError(
                f"the model has {model.n_stages} stages, the mesh's stage "
                f"axis {self.mesh.shape[STAGE_AXIS]}")
        if model.mesh is not self.mesh:
            raise ValueError("build the GPipe model on the strategy's mesh "
                             "(mesh=strategy.mesh): it lays out this "
                             "process's stage only")
        return self.placements(model)

    def _axes(self, name: str) -> Tuple[str, ...]:
        """The axes over which parameter ``name``'s process holds a part:
        its Megatron axis and, for a stage's, ``stage``."""
        pl = self._bound.get(name)
        if pl is None:
            return ()
        axes = (pl.axis,) if pl.axis else ()
        if pl.stage is not None and self.mesh.shape[STAGE_AXIS] > 1:
            axes += (STAGE_AXIS,)
        return tuple(a for a in axes if self.mesh.axis_group(a) is not None)

    def _axes_sum(self, axes: Tuple[str, ...]):
        groups = [self.mesh.axis_group(a) for a in axes]

        def total(x: torch.Tensor) -> torch.Tensor:
            for g in groups:
                x = collectives.psum(x, g)
            return x

        return total

    # -- the step ----------------------------------------------------------
    def distribute_batch(self, batch):
        leaves = list(batch.values())
        if leaves:
            b, dp = int(np.shape(leaves[0])[0]), self.mesh.shape[DATA_AXIS]
            if b % dp:
                raise ValueError(
                    f"batch {b} not divisible by the {DATA_AXIS} axis size "
                    f"{dp}")
        return super().distribute_batch(batch)

    def make_optimizer(self, model, optimizer, learning_rate, **options):
        """The optimizer over this process's stage, embed and head; the
        clip norm and trust ratios sum a stage's square sums over
        ``stage`` (and ``model``)."""
        opt = Strategy.make_optimizer(self, model, optimizer, learning_rate,
                                      **options)
        if hasattr(opt, "shard_sums"):
            opt.shard_sums = {p: self._axes_sum(self._axes(n))
                              for n, p in model.named_parameters()
                              if self._axes(n)}
        return opt

    def reduce_gradients(self, model: nn.Module) -> None:
        """The embed's gradient from stage 0 and the head's from the last
        stage, each broadcast over ``stage``; then every gradient averaged
        over ``data``."""
        group = self.mesh.axis_group(STAGE_AXIS)
        if group is not None:
            last = self.mesh.shape[STAGE_AXIS] - 1
            me = self.mesh.axis_index(STAGE_AXIS)
            for part, root in ((model.embed, 0), (model.head, last)):
                ps = [p for p in part.parameters() if p.requires_grad]
                if not ps:
                    continue
                flat = (torch.cat([(p.grad if p.grad is not None
                                    else torch.zeros_like(p)).reshape(-1)
                                   for p in ps]) if me == root else
                        torch.empty(sum(p.numel() for p in ps),
                                    dtype=ps[0].dtype, device=ps[0].device))
                flat = collectives.broadcast_counted(flat, group, root,
                                                     "pp_replicated_bwd")
                offset = 0
                for p in ps:
                    p.grad = flat[offset:offset + p.numel()].view_as(p)
                    offset += p.numel()
        super().reduce_gradients(model)

    def grad_norm(self, model: nn.Module) -> torch.Tensor:
        """The global L2 norm of the gradients (module docstring)."""
        by_axes: Dict[Tuple[str, ...], list] = {}
        for name, p in model.named_parameters():
            if p.grad is not None:
                by_axes.setdefault(self._axes(name), []).append(
                    p.grad.float().square().sum())
        total = None
        for axes, sums in by_axes.items():
            sq = self._axes_sum(axes)(torch.stack(sums).sum())
            total = sq if total is None else total + sq
        return total.sqrt()

    # -- checkpoints -------------------------------------------------------
    def _whole(self, name: str, part: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A tensor of parameter ``name`` (the parameter, a moment, a
        shadow) whole: over ``model`` if cut, and for a stage's, every
        stage's under its own name (collectives)."""
        pl = self._bound.get(name)
        if pl is not None and pl.axis:
            part = self.whole_state(name, part)
        if not _is_stage(name) or self.mesh.axis_group(STAGE_AXIS) is None:
            return {name: part}
        parts = collectives.all_gather(part.contiguous(),
                                       self.mesh.axis_group(STAGE_AXIS))
        return {_restage(name, s): t for s, t in enumerate(parts.unbind(0))}

    def gather_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The bound model's ``state_dict`` as the whole model's: every
        stage's under its own names, Megatron blocks whole (a collective
        over ``stage`` and ``model``)."""
        out = {}
        for k, v in model.state_dict().items():
            out.update(self._whole(k, v))
        return out

    def _sequential_names(self, trainer) -> List[Tuple[List[str], List[str]]]:
        """Per optimizer group: this process's parameter names, and the
        whole model's in its order (each run of this stage's names
        repeated for every stage)."""
        names = {p: n for n, p in trainer.model.named_parameters()}
        out = []
        for group in trainer.optimizer.param_groups:
            local = [names[p] for p in group["params"]]
            seq, i = [], 0
            while i < len(local):
                if not _is_stage(local[i]):
                    seq.append(local[i])
                    i += 1
                    continue
                j = i
                while j < len(local) and _is_stage(local[j]):
                    j += 1
                for s in range(self.mesh.shape[STAGE_AXIS]):
                    seq += [_restage(n, s) for n in local[i:j]]
                i = j
            out.append((local, seq))
        return out

    def _staged(self) -> bool:
        return self.mesh.axis_group(STAGE_AXIS) is not None

    def _whole_names(self, name: str) -> List[str]:
        """The whole model's names of this process's parameter ``name``:
        every stage's for a stage's parameter."""
        if self._staged() and _is_stage(name):
            return [_restage(name, s)
                    for s in range(self.mesh.shape[STAGE_AXIS])]
        return [name]

    def _local_of(self, name: str) -> str:
        """This process's parameter in the role of whole name ``name``."""
        if self._staged() and _is_stage(name):
            return _restage(name, self.mesh.axis_index(STAGE_AXIS))
        return name

    def _whole_torch(self, trainer, sd: dict) -> dict:
        """A ``torch.optim`` state dict over the whole model's parameters
        in sequential order (collectives)."""
        params = dict(trainer.model.named_parameters())
        groups, per_name = [], {}
        seq_index = 0
        names = self._sequential_names(trainer)
        for (local, seq), saved in zip(names, sd["param_groups"]):
            for name, idx in zip(local, saved["params"]):
                st = sd["state"].get(idx)
                if st is None:
                    continue
                entry: Dict[str, dict] = {
                    t: {} for t in self._whole_names(name)}
                for key in sorted(st):
                    v = st[key]
                    if (isinstance(v, torch.Tensor) and v.ndim
                            and v.shape == params[name].shape):
                        for t_name, t in self._whole(name, v).items():
                            entry[t_name][key] = t
                    else:
                        for t_name in entry:
                            entry[t_name][key] = v
                per_name.update(entry)
            groups.append(dict(saved, params=list(
                range(seq_index, seq_index + len(seq)))))
            seq_index += len(seq)
        flat_names = [n for _, seq in names for n in seq]
        return {"state": {i: per_name[n] for i, n in enumerate(flat_names)
                          if n in per_name},
                "param_groups": groups}

    def _local_torch(self, trainer, saved: dict) -> dict:
        """The inverse of :meth:`_whole_torch`."""
        params = dict(trainer.model.named_parameters())
        groups, opt_state, local_index = [], {}, 0
        for (local, seq), sgroup in zip(self._sequential_names(trainer),
                                        saved["param_groups"]):
            where = dict(zip(seq, sgroup["params"]))
            ids = []
            for name in local:
                st = saved["state"].get(where[name])
                if st is not None:
                    opt_state[local_index] = {
                        k: (self.local_state(name, v)
                            if isinstance(v, torch.Tensor) and v.ndim
                            and v.shape != params[name].shape else v)
                        for k, v in st.items()}
                ids.append(local_index)
                local_index += 1
            groups.append(dict(sgroup, params=ids))
        return {"state": opt_state, "param_groups": groups}

    def _kept_names(self, trainer, keep) -> Tuple[List[str], List[str]]:
        """This process's and the whole model's parameter names, in
        target order, whose (local) parameter passes ``keep``."""
        params = dict(trainer.model.named_parameters())
        names = self._sequential_names(trainer)
        local = [n for loc, _ in names for n in loc if keep(params[n])]
        whole = [n for _, seq in names for n in seq
                 if keep(params[self._local_of(n)])]
        return local, whole

    def _whole_list(self, trainer, values: list, keep) -> list:
        """A wrapper's per-target list (``None`` where a target has no
        entry) over the whole model's targets."""
        local, whole = self._kept_names(trainer, keep)
        by_name = {}
        for name, v in zip(local, values, strict=True):
            if v is None:
                by_name.update({t: None for t in self._whole_names(name)})
            else:
                by_name.update(self._whole(name, v))
        return [by_name[n] for n in whole]

    def _local_list(self, trainer, values: list, keep) -> list:
        """The inverse of :meth:`_whole_list`."""
        params = dict(trainer.model.named_parameters())
        local, whole = self._kept_names(trainer, keep)
        by_name = dict(zip(whole, values, strict=True))
        out = []
        for name in local:
            v = by_name[name]
            if v is not None and v.shape != params[name].shape:
                v = self.local_state(name, v)
            out.append(v)
        return out

    def _whole_rule(self, trainer, opt, sd: dict) -> dict:
        """The optimizer's state over the whole model: a wrapper's own
        state around its inner rule's, down to the ``torch.optim`` rule."""
        if not isinstance(opt, OptimizerWrapper):
            return self._whole_torch(trainer, sd)
        out = dict(sd, inner=self._whole_rule(trainer, opt.inner,
                                              sd["inner"]))
        if "acc" in sd:
            out["acc"] = self._whole_list(trainer, sd["acc"], _every)
        if "masters" in sd:
            out["masters"] = self._whole_list(trainer, sd["masters"], _bf16)
        if "generator" in sd and self._staged():
            gens = collectives.all_gather(sd["generator"],
                                          self.mesh.axis_group(STAGE_AXIS))
            out["generator"] = gens[0]
            out["generator_by_stage"] = list(gens.unbind(0))
        return out

    def _local_rule(self, trainer, opt, sd: dict) -> dict:
        """The inverse of :meth:`_whole_rule`."""
        if not isinstance(opt, OptimizerWrapper):
            return self._local_torch(trainer, sd)
        out = dict(sd, inner=self._local_rule(trainer, opt.inner,
                                              sd["inner"]))
        if "acc" in sd:
            out["acc"] = self._local_list(trainer, sd["acc"], _every)
        if "masters" in sd:
            out["masters"] = self._local_list(trainer, sd["masters"], _bf16)
        by_stage = out.pop("generator_by_stage", None)
        if by_stage is not None and self._staged():
            out["generator"] = by_stage[self.mesh.axis_index(STAGE_AXIS)]
        return out

    def whole_trainer_state(self, trainer) -> Tuple[dict, Dict[str, str]]:
        """``(state, owners)`` of a save (module docstring): the sequential
        model's state, gathered (every process calls it)."""
        state = trainer.state_dict()
        model = self.gather_state_dict(trainer.model)
        ema = None
        if state.get("ema") is not None:
            ema = {}
            for k, v in state["ema"].items():
                ema.update(self._whole(k, v))
        optimizer = self._whole_rule(trainer, trainer.optimizer,
                                     state["optimizer"])
        return {"step": state["step"], "model": model,
                "optimizer": optimizer, "ema": ema}, {}

    def local_trainer_state(self, trainer, state: dict, meta) -> dict:
        """The inverse of :meth:`whole_trainer_state`: this process's
        stage and block of a save."""
        mine = trainer.model.state_dict()
        model = {k: self.local_state(k, state["model"][k]) for k in mine}
        ema = state.get("ema")
        if ema is not None:
            ema = {k: self.local_state(k, ema[k]) for k in mine if k in ema}
        optimizer = self._local_rule(trainer, trainer.optimizer,
                                     state["optimizer"])
        return {"step": state["step"], "model": model,
                "optimizer": optimizer, "ema": ema}

    def __repr__(self) -> str:
        shape = self.mesh.shape
        return (f"{type(self).__name__}(data={shape['data']}, "
                f"stage={shape[STAGE_AXIS]}, model={shape[MODEL_AXIS]})")
