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
process's stage and block. A wrapped update rule (bf16 rules, schedules,
clipping, accumulation) is not saved this way yet.
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

_ITEM_7 = "not ported yet: ROADMAP.md queue 1 item 7 (distributed)"

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
      rules, coordinator_address, num_processes, process_id, device,
        backend: as :class:`TensorParallelStrategy`'s.
    """

    def __init__(self, n_stages: int, model_parallel: int = 1,
                 rules: Optional[Sequence[Rule]] = None, **kwargs):
        if rules is None:
            rules = PIPELINE_TP_RULES if model_parallel > 1 else PIPELINE_RULES
        super().__init__(model_parallel=model_parallel, rules=rules, **kwargs)
        self._mesh_config = MeshConfig(
            data=-1, model=model_parallel, stage=n_stages
        )
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

    def _plain_optimizer(self, trainer) -> torch.optim.Optimizer:
        opt = trainer.optimizer
        if type(opt).__module__.split(".")[0] != "torch":
            raise NotImplementedError(
                f"saving a pipeline run's {type(opt).__name__} (a wrapped "
                "update rule) is " + _ITEM_7)
        return opt

    def whole_trainer_state(self, trainer) -> Tuple[dict, Dict[str, str]]:
        """``(state, owners)`` of a save (module docstring): the sequential
        model's state, gathered (every process calls it)."""
        opt = self._plain_optimizer(trainer)
        state = trainer.state_dict()
        model = self.gather_state_dict(trainer.model)
        ema = None
        if state.get("ema") is not None:
            ema = {}
            for k, v in state["ema"].items():
                ema.update(self._whole(k, v))
        sd = opt.state_dict()
        params = {n: p for n, p in trainer.model.named_parameters()}
        staged = self.mesh.axis_group(STAGE_AXIS) is not None
        groups, per_name = [], {}
        seq_index = 0
        for (local, seq), saved in zip(self._sequential_names(trainer),
                                       sd["param_groups"]):
            for name, idx in zip(local, saved["params"]):
                st = sd["state"].get(idx)
                if st is None:
                    continue
                targets = ([_restage(name, s)
                            for s in range(self.mesh.shape[STAGE_AXIS])]
                           if staged and _is_stage(name) else [name])
                entry: Dict[str, dict] = {t: {} for t in targets}
                for key in sorted(st):
                    v = st[key]
                    if (isinstance(v, torch.Tensor) and v.ndim
                            and v.shape == params[name].shape):
                        for t_name, t in self._whole(name, v).items():
                            entry[t_name][key] = t
                    else:
                        for t_name in targets:
                            entry[t_name][key] = v
                per_name.update(entry)
            groups.append(dict(saved, params=list(
                range(seq_index, seq_index + len(seq)))))
            seq_index += len(seq)
        flat_names = [n for _, seq in self._sequential_names(trainer)
                      for n in seq]
        optimizer = {"state": {i: per_name[n] for i, n in
                               enumerate(flat_names) if n in per_name},
                     "param_groups": groups}
        return {"step": state["step"], "model": model,
                "optimizer": optimizer, "ema": ema}, {}

    def local_trainer_state(self, trainer, state: dict, meta) -> dict:
        """The inverse of :meth:`whole_trainer_state`: this process's
        stage and block of a save."""
        self._plain_optimizer(trainer)
        mine = trainer.model.state_dict()
        model = {k: self.local_state(k, state["model"][k]) for k in mine}
        ema = state.get("ema")
        if ema is not None:
            ema = {k: self.local_state(k, ema[k]) for k in mine if k in ema}
        saved = state["optimizer"]
        params = {n: p for n, p in trainer.model.named_parameters()}
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
        return {"step": state["step"], "model": model,
                "optimizer": {"state": opt_state, "param_groups": groups},
                "ema": ema}

    def __repr__(self) -> str:
        shape = self.mesh.shape
        return (f"{type(self).__name__}(data={shape['data']}, "
                f"stage={shape[STAGE_AXIS]}, model={shape[MODEL_AXIS]})")
