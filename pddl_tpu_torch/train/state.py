"""Optimizers of the port's trainer: the constant-learning-rate subset of
:func:`pddl_tpu.train.state.make_optimizer`, on ``torch.optim``.

``adam``, ``adamw``, ``sgd`` and ``momentum`` follow their optax
definitions: betas (0.9, 0.999) and eps 1e-8 for the Adams; ``adamw``
decays only parameters with ``ndim > 1`` (matrices: not biases or norm
scales) at optax's default weight decay of 1e-4 unless one is given;
``momentum`` is SGD with momentum 0.9. The learning rate sits in each
parameter group, where :func:`get_learning_rate` / :func:`set_learning_rate`
read and write it.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

_NOT_PORTED = "not ported yet: ROADMAP.md queue 1 item 5 ({})"
_OPTIMIZERS = ("adam", "adamw", "sgd", "momentum")


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adam",
                   learning_rate: float = 1e-3, *,
                   weight_decay: Optional[float] = None,
                   schedule=None, grad_clip_norm: Optional[float] = None,
                   accumulate_steps: Optional[int] = None,
                   param_update: str = "plain") -> torch.optim.Optimizer:
    """A ``torch.optim`` optimizer over ``params`` at a constant rate."""
    if schedule is not None:
        raise NotImplementedError(
            "learning-rate schedules are " + _NOT_PORTED.format("schedules"))
    if grad_clip_norm is not None:
        raise NotImplementedError(
            "gradient clipping is " + _NOT_PORTED.format("clipping"))
    if accumulate_steps is not None and accumulate_steps > 1:
        raise NotImplementedError(
            "gradient accumulation is "
            + _NOT_PORTED.format("accumulation"))
    if param_update != "plain":
        raise NotImplementedError(
            f"param_update={param_update!r} is "
            + _NOT_PORTED.format("mixed_precision.py"))
    if not isinstance(name, str) or name.lower() not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; the port has "
                         f"{sorted(_OPTIMIZERS)}")
    name = name.lower()
    params = list(params)
    if weight_decay is not None and name != "adamw":
        raise ValueError(f"weight_decay is not supported for {name!r}; use "
                         "'adamw'")
    if name == "adamw":
        wd = 1e-4 if weight_decay is None else weight_decay
        groups = [{"params": [p for p in params if p.ndim > 1],
                   "weight_decay": wd},
                  {"params": [p for p in params if p.ndim <= 1],
                   "weight_decay": 0.0}]
        return torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)
    return torch.optim.SGD(params, lr=learning_rate,
                           momentum=0.9 if name == "momentum" else 0.0)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The current learning rate (every group carries the same one)."""
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, value: float) -> None:
    """Set the learning rate of every parameter group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = float(value)
