"""Losses and metrics of the causal-LM trainer (the subset of
:mod:`pddl_tpu.train.metrics` it uses), computed from logits in f32.

Each is a function ``(logits, labels) -> scalar tensor``; the loss is the
mean token cross-entropy over every position of a ``[B, S, V]`` batch, as
``optax.softmax_cross_entropy_with_integer_labels(...).mean()`` computes
it in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch
import torch.nn.functional as F

MetricFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def sparse_categorical_crossentropy(logits: torch.Tensor,
                                    labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over every position; integer labels, f32 logits."""
    logits = logits.float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy over every position."""
    return (logits.argmax(dim=-1) == labels).float().mean()


LOSSES: Dict[str, MetricFn] = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
}

METRICS: Dict[str, MetricFn] = {"accuracy": accuracy}


def resolve_loss(loss: Union[str, MetricFn]) -> MetricFn:
    if callable(loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"unknown loss {loss!r}; known: {sorted(LOSSES)}") from None


def resolve_metric(metric: Union[str, MetricFn]) -> Tuple[str, MetricFn]:
    if callable(metric):
        return getattr(metric, "__name__", "metric"), metric
    try:
        return metric, METRICS[metric]
    except KeyError:
        raise ValueError(
            f"unknown metric {metric!r}; known: {sorted(METRICS)}") from None
