"""Losses and metrics of the trainer (the port of
:mod:`pddl_tpu.train.metrics`), computed from logits in f32.

Each is a function ``(logits, labels) -> scalar tensor``, a mean over
every position of the batch, as the JAX package computes it: the sparse
loss as ``optax.softmax_cross_entropy_with_integer_labels(...).mean()``,
the one-hot loss as ``optax.softmax_cross_entropy(...).mean()``.

The metric named ``"perplexity"`` logs the mean token cross-entropy (log
space) per batch; the trainer's epoch mean takes the exp of the mean for
exactly that key (``loop._mean_logs``), which is exp(mean CE) over all
tokens rather than a mean of per-batch exponentials.
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


def categorical_crossentropy(logits: torch.Tensor,
                             onehot: torch.Tensor) -> torch.Tensor:
    """Mean CE over every position against (one-hot or soft) targets."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(onehot.float() * logp).sum(dim=-1).mean()


def mean_squared_error(pred: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    return ((pred.float() - target.float()) ** 2).mean()


LOSSES: Dict[str, MetricFn] = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "mse": mean_squared_error,
}


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy over every position."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def top_k_accuracy(k: int) -> MetricFn:
    """The share of positions whose label is among the ``k`` largest
    logits."""
    def _top_k(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        top = torch.topk(logits, k, dim=-1).indices
        return (top == labels[..., None]).any(dim=-1).float().mean()

    _top_k.__name__ = f"top_{k}_accuracy"
    return _top_k


def log_perplexity(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy: what the ``"perplexity"`` metric logs."""
    return sparse_categorical_crossentropy(logits, labels)


def perplexity(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """exp(mean token cross-entropy), for one-shot use. As a trainer
    metric it logs :func:`log_perplexity` under ``"perplexity"``."""
    return torch.exp(log_perplexity(logits, labels))


METRICS: Dict[str, MetricFn] = {
    "accuracy": accuracy,
    "top_5_accuracy": top_k_accuracy(5),
    "perplexity": log_perplexity,
}


def resolve_loss(loss: Union[str, MetricFn]) -> MetricFn:
    if callable(loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"unknown loss {loss!r}; known: {sorted(LOSSES)}") from None


def resolve_metric(metric: Union[str, MetricFn]) -> Tuple[str, MetricFn]:
    if metric is perplexity:
        return "perplexity", log_perplexity
    if callable(metric):
        return getattr(metric, "__name__", "metric"), metric
    try:
        return metric, METRICS[metric]
    except KeyError:
        raise ValueError(
            f"unknown metric {metric!r}; known: {sorted(METRICS)}") from None
