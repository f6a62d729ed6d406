"""Optimizers of the port's trainer: the port of
:func:`pddl_tpu.train.state.make_optimizer` and
:func:`~pddl_tpu.train.state.make_schedule`, with optax's semantics.

All eight JAX names: ``adam``, ``adamw``, ``sgd`` and ``momentum`` on
``torch.optim`` (the Adams at optax's betas (0.9, 0.999) and eps 1e-8;
``momentum`` is SGD with momentum 0.9), and ``rmsprop``, ``adagrad``,
``lamb`` and ``lars`` as the optax chains of
:mod:`pddl_tpu_torch.train.optimizers`. Keyword arguments the JAX
function passes through to its optax factory (``b1``, ``momentum``,
``decay``, ``eps``, ...) go to the update rule here.

``adamw`` and ``lamb`` decay only matrices by default — parameters whose
JAX leaf has ``ndim > 1``, judged on the JAX shape when ``params`` is a
port model (a q/k/v bias is ``[H, D]`` there), so biases and norm scales
stay undecayed — at optax's default weight decay (1e-4 for ``adamw``, 0
for ``lamb``) unless one is given. ``decay_mask`` overrides the mask: a
callable ``parameter -> bool``, one bool per parameter, or ``None`` to
decay everything. The learning rate sits in each parameter group, where
:func:`get_learning_rate` / :func:`set_learning_rate` read and write it.

The chain around the rule, in the JAX order (inside out): the update
rule under ``param_update`` (:mod:`pddl_tpu_torch.train.mixed_precision`;
any bf16 parameter takes it, ``"plain"`` included, so the rule's state
and arithmetic stay f32), then ``grad_clip_norm`` (optax's
``clip_by_global_norm``: every gradient times ``max_norm / norm`` when
the global L2 norm reaches it, computed in f32), then
``accumulate_steps`` (optax's ``MultiSteps``: the running mean ``acc +
(g - acc) / (n + 1)`` in f32 over ``k`` micro-steps, the parameters
moving once on the ``k``-th). ``schedule`` makes the learning rate a
function of the count of updates (micro-steps do not count), evaluated
in f32 as optax's are; a callback's write to the rate is overwritten at
the next update, as in the JAX package. The hyperparameters are Python
floats and the rule runs on f32, so bf16 storage cannot round ``b2`` to
1 as it could in JAX before its f32 pin.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from pddl_tpu_torch.models.layers import jax_shapes
from pddl_tpu_torch.train import optimizers
from pddl_tpu_torch.train.mixed_precision import (
    PARAM_UPDATE_MODES,
    OptimizerWrapper,
    ParamUpdate,
)

_OPTIMIZERS = ("adam", "adamw", "sgd", "momentum", "rmsprop", "lamb", "lars",
               "adagrad")
_RULES = {"rmsprop": optimizers.RMSprop, "adagrad": optimizers.Adagrad,
          "lamb": optimizers.LAMB, "lars": optimizers.LARS}
# The optax keywords the names on torch.optim take.
_TORCH_KW = {"adam": ("b1", "b2", "eps"), "adamw": ("b1", "b2", "eps"),
             "sgd": ("momentum", "nesterov"),
             "momentum": ("momentum", "nesterov")}


def _matrices(params) -> List[Tuple[bool, torch.nn.Parameter]]:
    """``(JAX ndim > 1, parameter)`` for a model or a parameter iterable."""
    if isinstance(params, torch.nn.Module):
        shapes = jax_shapes(params)
        return [(len(shapes.get(n, p.shape)) > 1, p)
                for n, p in params.named_parameters()]
    return [(p.ndim > 1, p) for p in params]


def _groups(params, mask, wd: float) -> list:
    """The decayed group first, then the undecayed one (if any)."""
    groups = [{"params": [p for m, p in zip(mask, params) if m],
               "weight_decay": wd}]
    rest = [p for m, p in zip(mask, params) if not m]
    if rest:
        groups.append({"params": rest, "weight_decay": 0.0})
    return groups


def _mask(spec, params) -> List[bool]:
    """An optax mask as one bool per parameter: ``None``/``True`` all,
    ``False`` none, a callable per parameter, or a sequence of bools."""
    if spec is None or isinstance(spec, bool):
        return [spec is not False] * len(params)
    if callable(spec):
        return [bool(spec(p)) for p in params]
    spec = [bool(m) for m in spec]
    if len(spec) != len(params):
        raise ValueError(f"a mask of {len(spec)} entries for "
                         f"{len(params)} parameters")
    return spec


def make_optimizer(params: Union[torch.nn.Module,
                                 Iterable[torch.nn.Parameter]],
                   name: Union[str, Callable] = "adam",
                   learning_rate: float = 1e-3, *,
                   schedule=None, schedule_options=None,
                   weight_decay: Optional[float] = None,
                   grad_clip_norm: Optional[float] = None,
                   accumulate_steps: Optional[int] = None,
                   param_update: str = "plain", update_seed: int = 0,
                   **kwargs) -> torch.optim.Optimizer:
    """An optimizer over ``params`` (a port model, or its parameters)
    (module docstring). ``name`` may instead be a prebuilt optimizer,
    ``params -> torch.optim.Optimizer``, as
    :func:`pddl_tpu_torch.compat.hvd.DistributedOptimizer` returns: it is
    built over ``params`` with its own learning rate, and ``param_update``,
    ``grad_clip_norm`` and ``accumulate_steps`` compose with it.

    The result is the ``torch.optim`` rule itself when nothing wraps it
    (f32 parameters, no schedule, clip or accumulation), else a
    :class:`~pddl_tpu_torch.train.mixed_precision.ParamUpdate` or an
    :class:`UpdateChain` around one; each has ``param_groups``, ``state``,
    ``step``, ``zero_grad``, ``state_dict`` and ``load_state_dict``."""
    if callable(name):
        # A prebuilt optimizer (hvd.DistributedOptimizer's result): the
        # JAX package takes a prebuilt optax chain as it is.
        if (schedule is not None or weight_decay is not None
                or "decay_mask" in kwargs):
            raise ValueError(
                "schedule/weight_decay/decay_mask cannot be applied to a "
                "prebuilt optimizer — build it with them, or pass the "
                "optimizer by name")
        return _chain(name(params), learning_rate, schedule,
                      schedule_options, grad_clip_norm, accumulate_steps,
                      param_update, update_seed)
    if not isinstance(name, str) or name.lower() not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(_OPTIMIZERS)}")
    name = name.lower()
    ranked = _matrices(params)
    plist = [p for _, p in ranked]
    has_decay_mask = "decay_mask" in kwargs
    decay_mask = kwargs.pop("decay_mask", None)
    if name in ("adamw", "lamb"):
        mask = (_mask(decay_mask, plist) if has_decay_mask
                else [m for m, _ in ranked])
        wd = weight_decay if weight_decay is not None else (
            1e-4 if name == "adamw" else 0.0)
        groups = _groups(plist, mask, wd)
    elif weight_decay is not None or has_decay_mask:
        raise ValueError(
            f"weight_decay/decay_mask are not supported for {name!r} (they "
            "would be silently ignored); use 'adamw'/'lamb'")
    else:
        groups = plist
    if name == "lars":
        # weight_decay stays at optax's 0 (the JAX function refuses one
        # for lars), so its mask changes nothing; the trust-ratio mask
        # selects each parameter's rule.
        kwargs.pop("weight_decay_mask", None)
        tr_mask = _mask(kwargs.pop("trust_ratio_mask", True), plist)
        groups = [{"params": [p], "trust_ratio": t}
                  for p, t in zip(plist, tr_mask)]
    return _chain(_rule(name, groups, learning_rate, kwargs), learning_rate,
                  schedule, schedule_options, grad_clip_norm,
                  accumulate_steps, param_update, update_seed)


def _rule(name: str, groups, learning_rate: float, kwargs: dict):
    """The update rule ``name`` over ``groups``."""
    if name in _RULES:
        return _RULES[name](groups, learning_rate, **kwargs)
    unknown = set(kwargs) - set(_TORCH_KW[name])
    if unknown:
        raise TypeError(f"{name} takes no keyword {sorted(unknown)[0]!r} "
                        f"(the port passes {list(_TORCH_KW[name])})")
    if name in ("adam", "adamw"):
        kw = {"betas": (kwargs.pop("b1", 0.9), kwargs.pop("b2", 0.999)),
              "eps": kwargs.pop("eps", 1e-8)}
        cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
        return cls(groups, lr=learning_rate, **kw)
    momentum = kwargs.pop("momentum", 0.9 if name == "momentum" else 0.0)
    return torch.optim.SGD(groups, lr=learning_rate,
                           momentum=momentum or 0.0,
                           nesterov=kwargs.pop("nesterov", False))


_F32 = np.float32


def _cosine(init: float, decay_steps: int, alpha: float):
    """optax's ``cosine_decay_schedule``, in f32."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int):
        c = _F32(min(count, decay_steps))
        cos = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c
                                            / _F32(decay_steps)))
        return _F32(init) * (_F32(1 - alpha) * cos + _F32(alpha))

    return schedule


def _linear(init: float, end: float, steps: int):
    """optax's ``linear_schedule`` from step 0, in f32."""
    if steps <= 0:
        return lambda count: _F32(init)

    def schedule(count: int):
        frac = _F32(1) - _F32(min(max(count, 0), steps)) / _F32(steps)
        return _F32(init - end) * frac + _F32(end)

    return schedule


def _exponential(init: float, steps: int, rate: float):
    """optax's ``exponential_decay`` (no staircase), in f32."""
    if steps <= 0 or rate == 0:
        return lambda count: _F32(init)

    def schedule(count: int):
        if count <= 0:
            return _F32(init)
        return _F32(init) * np.power(_F32(rate), _F32(count) / _F32(steps))

    return schedule


def _piecewise(init: float, boundaries_and_scales: dict):
    """optax's ``piecewise_constant_schedule``: times each scale whose
    boundary the count has reached, in f32."""
    if any(s < 0.0 for s in boundaries_and_scales.values()):
        raise ValueError("`piecewise_constant_schedule` expects "
                         "non-negative scale factors")

    def schedule(count: int):
        v = _F32(init)
        for bound, scale in sorted(boundaries_and_scales.items()):
            if count >= bound:
                v = _F32(scale) * v
        return v

    return schedule


def _join(first, then, boundary: int):
    """optax's ``join_schedules``: ``then`` counts from ``boundary``."""
    return lambda count: (first(count) if count < boundary
                          else then(count - boundary))


def make_schedule(name: Union[str, Callable[[int], float]],
                  learning_rate: float, *, decay_steps: Optional[int] = None,
                  warmup_steps: int = 0, alpha: float = 0.0,
                  decay_rate: float = 0.96,
                  boundaries_and_scales: Optional[dict] = None,
                  end_value: float = 0.0) -> Callable[[int], float]:
    """A learning-rate schedule, ``update count -> rate`` (the port of
    :func:`pddl_tpu.train.state.make_schedule`, in f32 as optax's).

    Names: ``cosine`` (optionally warmed up), ``warmup_cosine``,
    ``exponential``, ``linear``, ``piecewise`` (``boundaries_and_scales``),
    ``constant``; a callable is used as it is. One warmup convention, the
    one ``optax.warmup_cosine_decay_schedule`` uses: ``decay_steps`` is the
    whole horizon INCLUDING the warmup (``cosine`` and ``linear`` finish at
    step ``decay_steps``); ``exponential``'s ``decay_steps`` is a rate
    constant (times ``decay_rate`` per ``decay_steps`` updates after the
    warmup); ``piecewise`` boundaries are absolute steps (each at least
    ``warmup_steps``). The warmup ramps linearly from 0.
    """
    if callable(name):
        return name
    kind = name.lower()
    lr = learning_rate
    if kind in ("cosine", "warmup_cosine"):
        if decay_steps is None:
            raise ValueError(f"{kind!r} schedule requires decay_steps")
        if kind == "warmup_cosine" and not warmup_steps:
            raise ValueError(
                "'warmup_cosine' requires warmup_steps > 0; use 'cosine' "
                "for no warmup")
        if warmup_steps and decay_steps <= warmup_steps:
            raise ValueError(
                f"cosine schedule needs decay_steps > warmup_steps (total "
                f"horizon includes warmup); got {decay_steps} <= "
                f"{warmup_steps}")
        if warmup_steps:
            end = alpha * lr
            a = 0.0 if lr == 0.0 else end / lr
            return _join(_linear(0.0, lr, warmup_steps),
                         _cosine(lr, decay_steps - warmup_steps, a),
                         warmup_steps)
        return _cosine(lr, decay_steps, alpha)
    if kind == "exponential":
        if decay_steps is None:
            raise ValueError("'exponential' schedule requires decay_steps")
        sched = _exponential(lr, decay_steps, decay_rate)
    elif kind == "linear":
        if decay_steps is None:
            raise ValueError("'linear' schedule requires decay_steps")
        if warmup_steps and decay_steps <= warmup_steps:
            raise ValueError(
                f"'linear' schedule needs decay_steps > warmup_steps "
                f"(total horizon includes warmup); got {decay_steps} <= "
                f"{warmup_steps}")
        sched = _linear(lr, end_value, decay_steps - warmup_steps)
    elif kind == "piecewise":
        if not boundaries_and_scales:
            raise ValueError(
                "'piecewise' schedule requires boundaries_and_scales "
                "({step: scale, ...}); without them it would silently be "
                "a constant LR")
        if warmup_steps:
            if any(b < warmup_steps for b in boundaries_and_scales):
                raise ValueError(
                    "'piecewise' boundaries are absolute step indices and "
                    f"must be >= warmup_steps={warmup_steps}; got "
                    f"{sorted(boundaries_and_scales)}")
            boundaries_and_scales = {b - warmup_steps: s for b, s in
                                     boundaries_and_scales.items()}
        sched = _piecewise(lr, boundaries_and_scales)
    elif kind == "constant":
        sched = lambda count: _F32(lr)  # noqa: E731
    else:
        raise ValueError(
            f"unknown schedule {name!r}; known: cosine, warmup_cosine, "
            "exponential, linear, piecewise, constant")
    if warmup_steps:
        sched = _join(_linear(0.0, lr, warmup_steps), sched, warmup_steps)
    return sched


class UpdateChain(OptimizerWrapper):
    """A :class:`ParamUpdate` rule (or a prebuilt chain around one) under
    gradient accumulation, global-norm clipping and a learning-rate
    schedule (module docstring).

    ``count`` is the updates applied (the schedule's step), ``mini_step``
    the micro-steps of the current accumulation window: the parameters
    moved at the last :meth:`step` exactly when it is 0 again."""

    def __init__(self, rule: ParamUpdate, *,
                 schedule: Optional[Callable[[int], float]] = None,
                 grad_clip_norm: Optional[float] = None,
                 accumulate_steps: int = 1):
        super().__init__(rule)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.accumulate_steps = max(1, int(accumulate_steps))
        self.count = 0
        self.mini_step = 0
        self._acc: Dict[torch.Tensor, torch.Tensor] = {}
        if schedule is not None:
            set_learning_rate(self, schedule(0))

    def _global_norm(self, grads) -> torch.Tensor:
        """The L2 norm over every gradient; a slice's square sum is summed
        over its tensor's slices (the ps strategy's ``shard_sums``)."""
        total = None
        for p, g in grads.items():
            sq = g.float().square().sum()
            sum_over = self.shard_sums.get(p)
            if sum_over is not None:
                sq = sum_over(sq)
            total = sq if total is None else total + sq
        return total.sqrt()

    def _clip(self, grads):
        norm = self._global_norm(grads)
        keep = norm < self.grad_clip_norm
        return {p: torch.where(keep, g.float(),
                               g.float() / norm * self.grad_clip_norm)
                for p, g in grads.items()}

    def step(self, closure=None):
        self._run_pre_hooks()
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.apply()
        return loss

    @torch.no_grad()
    def apply(self, grads: Optional[Dict[torch.Tensor, torch.Tensor]] = None
              ) -> None:
        """One micro-step from ``grads`` (target -> gradient; ``None``:
        the targets' ``.grad``)."""
        if grads is None:
            grads = {p: p.grad for p in self.targets() if p.grad is not None}
        k = self.accumulate_steps
        if k > 1:
            n = self.mini_step
            for p, g in grads.items():
                acc = self._acc.get(p)
                if acc is None:
                    acc = self._acc[p] = torch.zeros_like(
                        p, dtype=torch.float32)
                acc.add_((g.float() - acc).div_(n + 1))
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return
            grads = dict(self._acc)
        if self.grad_clip_norm is not None:
            grads = self._clip(grads)
        if self.schedule is not None:
            set_learning_rate(self, self.schedule(self.count))
        self.count += 1
        self.inner.apply(grads)
        for acc in self._acc.values():
            acc.zero_()

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step,
                "acc": [self._acc.get(p) for p in self.targets()]}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self._acc = {}
        for p, acc in zip(self.targets(), state["acc"], strict=True):
            if acc is not None:
                self._acc[p] = acc.to(device=p.device, dtype=torch.float32,
                                      copy=True)
        if self.schedule is not None and self.count:
            set_learning_rate(self, self.schedule(self.count - 1))


def _chain(rule, learning_rate, schedule, schedule_options, grad_clip_norm,
           accumulate_steps, param_update, update_seed):
    """``rule`` under what the options ask for, in the JAX order; the rule
    itself when they ask for nothing and no parameter is bf16."""
    sched = (make_schedule(schedule, learning_rate,
                           **(schedule_options or {}))
             if schedule is not None else None)
    k = accumulate_steps if accumulate_steps is not None else 1
    chained = sched is not None or grad_clip_norm is not None or k > 1
    if isinstance(rule, OptimizerWrapper):
        # A prebuilt optimizer from make_optimizer: its rule runs through
        # a ParamUpdate already, which takes the mode asked for here.
        inner = rule
        while not isinstance(inner, ParamUpdate):
            inner = inner.inner
        if param_update != "plain":
            if inner.mode not in ("plain", param_update):
                raise ValueError(
                    f"param_update={param_update!r} over a prebuilt "
                    f"optimizer built with {inner.mode!r}")
            inner.mode, inner.seed = param_update, int(update_seed)
    else:
        bf16 = any(p.dtype == torch.bfloat16 for g in rule.param_groups
                   for p in g["params"])
        if chained or bf16 or param_update != "plain":
            if param_update not in PARAM_UPDATE_MODES:
                raise ValueError(f"unknown param_update {param_update!r}; "
                                 f"known: {PARAM_UPDATE_MODES}")
            rule = ParamUpdate(rule, param_update, seed=update_seed)
    if not chained:
        return rule
    return UpdateChain(rule, schedule=sched, grad_clip_norm=grad_clip_norm,
                       accumulate_steps=k)


def optimizer_state_bytes(optimizer) -> int:
    """Bytes of the tensors ``optimizer`` keeps beside the parameters:
    every tensor of its ``state_dict`` (the moments, and a wrapper's
    masters, accumulators and generator state)."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        return 0

    return walk(optimizer.state_dict())


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The current learning rate (every group carries the same one)."""
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, value: float) -> None:
    """Set the learning rate of every parameter group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = float(value)
