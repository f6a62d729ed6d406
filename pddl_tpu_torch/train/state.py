"""Optimizers of the port's trainer: the constant-learning-rate subset of
:func:`pddl_tpu.train.state.make_optimizer`, with optax's semantics.

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
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

import torch

from pddl_tpu_torch.models.layers import jax_shapes
from pddl_tpu_torch.train import optimizers

_NOT_PORTED = "not ported yet: ROADMAP.md queue 1 item 5 ({})"
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
                   name: str = "adam", learning_rate: float = 1e-3, *,
                   schedule=None, schedule_options=None,
                   weight_decay: Optional[float] = None,
                   grad_clip_norm: Optional[float] = None,
                   accumulate_steps: Optional[int] = None,
                   param_update: str = "plain", update_seed: int = 0,
                   **kwargs) -> torch.optim.Optimizer:
    """An optimizer over ``params`` (a port model, or its parameters) at a
    constant rate (module docstring)."""
    for what, given, item in (
            ("learning-rate schedules", schedule is not None, "schedules"),
            ("schedule_options", schedule_options is not None, "schedules"),
            ("gradient clipping", grad_clip_norm is not None, "clipping"),
            ("gradient accumulation",
             accumulate_steps is not None and accumulate_steps > 1,
             "accumulation"),
            (f"param_update={param_update!r}", param_update != "plain",
             "mixed_precision.py"),
            ("update_seed", update_seed != 0, "mixed_precision.py")):
        if given:
            raise NotImplementedError(f"{what} is " + _NOT_PORTED.format(item))
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


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The current learning rate (every group carries the same one)."""
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, value: float) -> None:
    """Set the learning rate of every parameter group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = float(value)
