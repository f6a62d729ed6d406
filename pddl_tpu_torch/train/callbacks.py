"""Callbacks of the port's trainer: the reference's two (the port of
:class:`pddl_tpu.train.callbacks.ReduceLROnPlateau` and
:class:`~pddl_tpu.train.callbacks.EarlyStopping`, with the reference's
defaults, ``imagenet-resnet50.py:64-65``), Horovod's learning-rate warmup
(:class:`~pddl_tpu.train.callbacks.LearningRateWarmup`,
``imagenet-resnet50-hvd.py:114-115``) and their base class.

The JAX trainer's state is a value that hooks may replace; the port's
lives in the trainer's model and optimizer, which hooks change in place.
So a hook takes the hook's other arguments and returns nothing:
``on_train_begin()``, ``on_epoch_begin(epoch)``,
``on_train_batch_end(step, logs)``, ``on_epoch_end(epoch, logs)`` and
``on_train_end(logs)``, in the order of the JAX ``Trainer.fit``. A hook
stops training by setting ``trainer.stop_training``.
"""

from __future__ import annotations

import copy
import math
import sys
from typing import Dict, Optional

from pddl_tpu_torch.train.state import get_learning_rate, set_learning_rate


class Callback:
    """Base class; hooks mirror ``keras.callbacks.Callback``.
    ``self.trainer`` is bound by the Trainer before any hook runs."""

    trainer = None

    def set_trainer(self, trainer) -> None:
        self.trainer = trainer

    def on_train_begin(self) -> None:
        pass

    def on_train_end(self, logs: Dict[str, float]) -> None:
        pass

    def on_epoch_begin(self, epoch: int) -> None:
        pass

    def on_epoch_end(self, epoch: int, logs: Dict[str, float]) -> None:
        pass

    def on_train_batch_end(self, step: int, logs: Dict[str, object]) -> None:
        pass


class _Monitor(Callback):
    """The improvement test the two callbacks share."""

    def __init__(self, monitor: str, min_delta: float, mode: str):
        self.monitor, self.min_delta, self.mode = monitor, min_delta, mode
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0

    def _improved(self, current: float) -> bool:
        if self.mode == "min":
            return current < self.best - self.min_delta
        return current > self.best + self.min_delta


class ReduceLROnPlateau(_Monitor):
    """Multiply the learning rate by ``factor`` (not below ``min_lr``)
    after ``patience`` epochs without improvement of ``monitor``."""

    def __init__(self, monitor: str = "val_loss", factor: float = 0.1,
                 patience: int = 5, min_lr: float = 1e-5,
                 min_delta: float = 1e-4, mode: str = "min",
                 verbose: int = 0):
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau factor must be < 1")
        super().__init__(monitor, min_delta, mode)
        self.factor, self.patience = factor, patience
        self.min_lr, self.verbose = min_lr, verbose

    def on_epoch_end(self, epoch, logs):
        current = logs.get(self.monitor)
        if current is None:
            return
        if self._improved(current):
            self.best, self.wait = current, 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            optimizer = self.trainer.optimizer
            old = get_learning_rate(optimizer)
            new = max(old * self.factor, self.min_lr)
            self.wait = 0
            if new < old:
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {old:.2e} -> {new:.2e}",
                          file=sys.stderr)
                set_learning_rate(optimizer, new)


class EarlyStopping(_Monitor):
    """Stop training after ``patience`` epochs without improvement of
    ``monitor``. With ``restore_best_weights`` the model goes back to its
    state at the best epoch: the parameters and the BatchNorm buffers
    (the JAX twin restores the parameters; its buffers are part of the
    port's ``state_dict``)."""

    def __init__(self, monitor: str = "val_loss", min_delta: float = 0.001,
                 patience: int = 10, mode: str = "min",
                 restore_best_weights: bool = False):
        super().__init__(monitor, min_delta, mode)
        self.patience = patience
        self.restore_best_weights = restore_best_weights
        self.best_state = None
        self.stopped_epoch: Optional[int] = None

    def on_epoch_end(self, epoch, logs):
        current = logs.get(self.monitor)
        if current is None:
            return
        model = self.trainer.model
        if self._improved(current):
            self.best, self.wait = current, 0
            if self.restore_best_weights:
                self.best_state = copy.deepcopy(model.state_dict())
            return
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped_epoch = epoch
            self.trainer.stop_training = True
            if self.restore_best_weights and self.best_state is not None:
                model.load_state_dict(self.best_state)


class LearningRateWarmup(Callback):
    """Linear LR warmup over the first epochs, Horovod-style.

    Equivalent of ``hvd.callbacks.LearningRateWarmupCallback(warmup_epochs=3)``
    (``imagenet-resnet50-hvd.py:114-115``): ramps from ``initial_lr/world``
    (or a given start) to the target LR over ``warmup_epochs`` epochs,
    stepping each batch.
    """

    def __init__(self, warmup_epochs: int = 3,
                 steps_per_epoch: Optional[int] = None,
                 start_lr: Optional[float] = None, verbose: int = 0):
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.start_lr = start_lr
        self.verbose = verbose
        self.target_lr: Optional[float] = None
        self._warmup_steps: Optional[int] = None

    def on_train_begin(self):
        optimizer = self.trainer.optimizer
        self.target_lr = get_learning_rate(optimizer)
        spe = self.steps_per_epoch or self.trainer.steps_per_epoch
        if spe is None:
            raise ValueError("LearningRateWarmup needs steps_per_epoch")
        self._warmup_steps = max(1, self.warmup_epochs * spe)
        start = (self.start_lr if self.start_lr is not None
                 else self.target_lr / self._warmup_steps)
        set_learning_rate(optimizer, start)

    def on_train_batch_end(self, step, logs):
        if step >= self._warmup_steps:
            return
        start = self.start_lr if self.start_lr is not None else 0.0
        frac = (step + 1) / self._warmup_steps
        set_learning_rate(self.trainer.optimizer,
                          start + (self.target_lr - start) * frac)
        if self.verbose and step + 1 == self._warmup_steps:
            print(f"LearningRateWarmup: reached target lr "
                  f"{self.target_lr:.2e}", file=sys.stderr)
