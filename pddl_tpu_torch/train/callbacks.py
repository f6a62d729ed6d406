"""Callbacks of the port's trainer: the reference's two (the port of
:class:`pddl_tpu.train.callbacks.ReduceLROnPlateau` and
:class:`~pddl_tpu.train.callbacks.EarlyStopping`, with the reference's
defaults, ``imagenet-resnet50.py:64-65``) and their base class.

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
