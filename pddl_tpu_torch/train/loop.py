"""The Trainer on one card: the port of :class:`pddl_tpu.train.loop.Trainer`'s
``compile``/``fit``/``evaluate`` surface for the causal-LM train step.

``train_step`` and ``eval_step`` keep the JAX package's semantics: one
forward gives the logits, the loss and every metric are computed on those
materialized logits (metrics of the train step see the logits from before
the update), and the optimizer steps once per batch. The model runs
eagerly; eval runs under ``torch.no_grad()``, so a Llama with
``attention="flash"`` launches the forward kernel without its LSE write
there. Per-step logs stay on the device and are fetched once per epoch.

The trainer runs on ``cuda`` unless asked for the CPU (``device="cpu"``),
and moves the model there. Options of the JAX trainer that the port has
not taken over raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import itertools
import sys
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from pddl_tpu_torch.device import resolve_device
from pddl_tpu_torch.train import metrics as metrics_lib
from pddl_tpu_torch.train.history import History
from pddl_tpu_torch.train.state import make_optimizer

# JAX-trainer options the port does not take yet: name -> (the JAX
# default, which is accepted, and the ROADMAP.md item that ports it).
_UNPORTED = {
    "strategy": (None, "queue 1 item 7 (distributed strategies)"),
    "augment": (None, "queue 1 item 5 (the ResNet-50 train step)"),
    "eval_transform": (None, "queue 1 item 5 (the ResNet-50 train step)"),
    "ema_decay": (None, "queue 1 item 5 (EMA)"),
    "gradient_accumulation_steps": (None, "queue 1 item 5 (accumulation)"),
    "lr_schedule": (None, "queue 1 item 5 (schedules)"),
    "lr_schedule_options": (None, "queue 1 item 5 (schedules)"),
    "log_grad_norm": (False, "queue 1 item 5 (train logs)"),
    "param_update": ("plain", "queue 1 item 5 (mixed_precision.py)"),
    "fault_plan": (None, "queue 1 item 5 (train/faults.py)"),
    "tracer": (None, "queue 1 item 5 (train/faults.py)"),
}
_UNPORTED_FIT = {
    "callbacks": ((), "queue 1 item 5 (train/callbacks.py)"),
    "initial_epoch": (0, "queue 1 item 6 (checkpointing and resume)"),
    "resume": (None, "queue 1 item 6 (checkpointing and resume)"),
}


def _refuse(options: Dict[str, object], table) -> None:
    for name, value in options.items():
        if name not in table:
            raise TypeError(f"unexpected argument {name!r}")
        default, item = table[name]
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: ROADMAP.md {item}")


class Trainer:
    """Single-card training orchestrator.

    >>> trainer = Trainer(model, optimizer="adamw", learning_rate=1e-4,
    ...                   input_key="tokens", target_key="targets")
    >>> history = trainer.fit(SyntheticLanguageModeling(...), epochs=1,
    ...                       steps_per_epoch=100)

    ``seed`` is accepted for the JAX signature: the model arrives with
    its weights drawn, and the dense blocks take no random numbers.
    """

    def __init__(self, model: torch.nn.Module, optimizer: str = "adam",
                 learning_rate: float = 1e-3,
                 loss: Union[str, Callable] = "sparse_categorical_crossentropy",
                 metrics: Sequence[Union[str, Callable]] = ("accuracy",),
                 seed: int = 0, input_key: str = "image",
                 target_key: str = "label", device=None, **options):
        _refuse(options, _UNPORTED)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(model.parameters(), optimizer,
                                        learning_rate)
        self.loss_fn = metrics_lib.resolve_loss(loss)
        self.metric_fns = dict(metrics_lib.resolve_metric(m) for m in metrics)
        self.seed = seed
        self.input_key = input_key
        self.target_key = target_key
        self.history: Optional[History] = None

    # ----------------------------------------------------------------- steps
    def _batch(self, batch) -> tuple:
        x = torch.as_tensor(np.asarray(batch[self.input_key]))
        y = torch.as_tensor(np.asarray(batch[self.target_key]))
        return (x.to(self.device, non_blocking=True),
                y.to(self.device, non_blocking=True))

    def _logs(self, loss, logits, labels) -> Dict[str, torch.Tensor]:
        logs = {"loss": loss.detach()}
        for name, fn in self.metric_fns.items():
            logs[name] = fn(logits, labels)
        return logs

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; logs stay on the device."""
        x, y = self._batch(batch)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(x)
        loss = self.loss_fn(logits, y)
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            return self._logs(loss, logits.detach(), y)

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        x, y = self._batch(batch)
        self.model.eval()
        logits = self.model(x, train=False)
        return self._logs(self.loss_fn(logits, y), logits, y)

    # ------------------------------------------------------------------- fit
    def fit(self, train_data: Iterable[Dict[str, np.ndarray]],
            epochs: int = 1, steps_per_epoch: Optional[int] = None,
            validation_data: Optional[Iterable] = None,
            validation_steps: Optional[int] = None, verbose: int = 2,
            **options) -> History:
        """Train for ``epochs``; with ``steps_per_epoch`` the data is one
        continuous stream across epochs (a finite re-iterable dataset
        repeats when it drains), without it each epoch is one pass."""
        _refuse(options, _UNPORTED_FIT)
        if validation_data is not None and isinstance(validation_data,
                                                      Iterator):
            raise ValueError(
                "validation_data is a one-shot iterator; fit() evaluates it "
                "once per epoch, so pass a re-iterable dataset")
        history = History()
        it = iter(train_data)
        for epoch in range(epochs):
            if steps_per_epoch is None and epoch > 0:
                if isinstance(train_data, Iterator):
                    raise ValueError(
                        "train_data is a one-shot iterator but "
                        "steps_per_epoch is None; pass a re-iterable "
                        "dataset or set steps_per_epoch")
                it = iter(train_data)
            t0 = time.perf_counter()
            step_logs, samples = [], 0
            while steps_per_epoch is None or len(step_logs) < steps_per_epoch:
                batch = next(it, None)
                if batch is None and steps_per_epoch is not None and not \
                        isinstance(train_data, Iterator):
                    it = iter(train_data)  # .repeat() semantics
                    batch = next(it, None)
                if batch is None:
                    break
                samples += int(np.shape(batch[self.target_key])[0])
                step_logs.append(self.train_step(batch))
            if not step_logs:
                raise ValueError("empty training dataset/epoch")
            epoch_logs = _mean_logs(step_logs)
            dt = time.perf_counter() - t0
            if validation_data is not None:
                epoch_logs.update(self.evaluate(
                    validation_data, steps=validation_steps, _prefix="val_"))
            epoch_logs["images_per_sec"] = samples / dt if dt > 0 else 0.0
            history.append(epoch, epoch_logs)
            if verbose:
                print(" - ".join(
                    [f"Epoch {epoch + 1}/{epochs}", f"{dt:.1f}s"]
                    + [f"{k}: {v:.4f}" for k, v in epoch_logs.items()
                       if k != "images_per_sec"]), file=sys.stderr)
        self.history = history
        return history

    def evaluate(self, data: Iterable[Dict[str, np.ndarray]],
                 steps: Optional[int] = None, verbose: int = 0,
                 _prefix: str = "") -> Dict[str, float]:
        """Mean loss and metrics over ``steps`` batches (or one pass)."""
        logs_list = [self.eval_step(batch)
                     for batch in itertools.islice(data, steps)]
        if not logs_list:
            raise ValueError("empty evaluation dataset")
        out = {_prefix + k: v for k, v in _mean_logs(logs_list).items()}
        if verbose:
            print(" - ".join(f"{k}: {v:.4f}" for k, v in out.items()),
                  file=sys.stderr)
        return out


def _mean_logs(logs_list) -> Dict[str, float]:
    """Fetch once (one device sync), average on the host in float64."""
    return {k: float(np.mean(torch.stack([d[k].float() for d in logs_list])
                             .cpu().numpy().astype(np.float64)))
            for k in logs_list[0]}
