"""The Trainer on one card: the port of :class:`pddl_tpu.train.loop.Trainer`'s
``compile``/``fit``/``evaluate``/``predict`` surface, for the causal-LM
step and the image-classification step (ResNet).

``train_step`` and ``eval_step`` keep the JAX package's semantics: one
forward gives the logits, the loss and every metric are computed on those
materialized logits (metrics of the train step see the logits from before
the update), and the optimizer steps once per batch. A model with
BatchNorm updates its running averages in the train step's forward and
reads them in ``eval_step`` and ``predict``. ``augment`` (``fn(generator,
images)``) runs on the device before the train step's forward, with a
``torch.Generator`` seeded from ``(seed + 1, step)``, so a rerun with the
same seed draws the same crops; ``eval_transform`` (``fn(images)``) runs
before ``eval_step``'s and ``predict``'s. With ``log_grad_norm`` the step
logs the global L2 norm of the gradients as ``grad_norm``. The model runs
eagerly; eval runs under ``torch.no_grad()``, so a Llama with
``attention="flash"`` launches the forward kernel without its LSE write
there. Per-step logs stay on the device and are fetched once per epoch.

``fit(callbacks=...)`` runs the hooks of :mod:`pddl_tpu_torch.train.callbacks`
in the JAX trainer's order; ``on_train_end`` runs for every callback even
when training or an earlier hook raised, and the first error is raised
after the sweep.

The trainer runs on ``cuda`` unless asked for the CPU (``device="cpu"``),
and moves the model there. A batch field that is already a tensor on that
device is used as it is. Options of the JAX trainer that the port has
not taken over raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import itertools
import logging
import sys
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from pddl_tpu_torch.device import resolve_device
from pddl_tpu_torch.train import metrics as metrics_lib
from pddl_tpu_torch.train.callbacks import Callback
from pddl_tpu_torch.train.history import History
from pddl_tpu_torch.train.state import make_optimizer

log = logging.getLogger(__name__)

# JAX-trainer options the port does not take yet: name -> (the JAX
# default, which is accepted, and the ROADMAP.md item that ports it).
_UNPORTED = {
    "strategy": (None, "queue 1 item 7 (distributed strategies)"),
    "ema_decay": (None, "queue 1 item 5 (EMA)"),
    "gradient_accumulation_steps": (None, "queue 1 item 5 (accumulation)"),
    "lr_schedule": (None, "queue 1 item 5 (schedules)"),
    "lr_schedule_options": (None, "queue 1 item 5 (schedules)"),
    "param_update": ("plain", "queue 1 item 5 (mixed_precision.py)"),
    "fault_plan": (None, "queue 1 item 5 (train/faults.py)"),
    "tracer": (None, "queue 1 item 5 (train/faults.py)"),
    "max_retries": (3, "queue 1 item 5 (train/faults.py)"),
    "retry_backoff_s": (0.02, "queue 1 item 5 (train/faults.py)"),
    "max_recoveries": (8, "queue 1 item 5 (train/faults.py)"),
    "retry_sleep": (time.sleep, "queue 1 item 5 (train/faults.py)"),
    "eval_with_ema": (True, "queue 1 item 5 (EMA)"),
    "donate_state": (True, "queue 1 item 5 (donate_state and prefetch)"),
}
_UNPORTED_FIT = {
    "prefetch": (2, "queue 1 item 5 (donate_state and prefetch)"),
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

    ``seed`` seeds the augment's generators (the model arrives with its
    weights drawn).
    """

    def __init__(self, model: torch.nn.Module, optimizer: str = "adam",
                 learning_rate: float = 1e-3,
                 loss: Union[str, Callable] = "sparse_categorical_crossentropy",
                 metrics: Sequence[Union[str, Callable]] = ("accuracy",),
                 seed: int = 0, augment: Optional[Callable] = None,
                 eval_transform: Optional[Callable] = None,
                 input_key: str = "image", target_key: str = "label",
                 log_grad_norm: bool = False, device=None, **options):
        _refuse(options, _UNPORTED)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(model.parameters(), optimizer,
                                        learning_rate)
        self.loss_fn = metrics_lib.resolve_loss(loss)
        self.metric_fns = dict(metrics_lib.resolve_metric(m) for m in metrics)
        self.seed = seed
        self.augment = augment
        self.eval_transform = eval_transform
        self.input_key = input_key
        self.target_key = target_key
        self.log_grad_norm = log_grad_norm
        self.step = 0  # optimizer steps taken: the augment's stream index
        self.global_step = 0
        self.stop_training = False
        self.history: Optional[History] = None

    # ----------------------------------------------------------------- steps
    def _tensor(self, value) -> torch.Tensor:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        return value.to(self.device, non_blocking=True)

    def _batch(self, batch) -> tuple:
        return (self._tensor(batch[self.input_key]),
                self._tensor(batch[self.target_key]))

    def _generator(self) -> torch.Generator:
        """The augment's generator for this step, seeded from
        ``(seed + 1, step)``."""
        seed = np.random.SeedSequence((self.seed + 1, self.step))
        return torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0]))

    def _logs(self, loss, logits, labels) -> Dict[str, torch.Tensor]:
        logs = {"loss": loss.detach()}
        for name, fn in self.metric_fns.items():
            logs[name] = fn(logits, labels)
        return logs

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; logs stay on the device."""
        x, y = self._batch(batch)
        if self.augment is not None:
            x = self.augment(self._generator(), x)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(x)
        loss = self.loss_fn(logits, y)
        loss.backward()
        with torch.no_grad():
            logs = self._logs(loss, logits.detach(), y)
            if self.log_grad_norm:
                logs["grad_norm"] = torch.nn.utils.get_total_norm(
                    [p.grad for p in self.model.parameters()
                     if p.grad is not None])
        self.optimizer.step()
        self.step += 1
        return logs

    @torch.no_grad()
    def _eval_logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.eval_transform is not None:
            x = self.eval_transform(x)
        self.model.eval()
        return self.model(x, train=False)

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        x, y = self._batch(batch)
        logits = self._eval_logits(x)
        return self._logs(self.loss_fn(logits, y), logits, y)

    def predict(self, images) -> np.ndarray:
        """Forward pass in inference mode on a batch of images; the
        logits come back as a host array."""
        return self._eval_logits(self._tensor(images)).cpu().numpy()

    # ------------------------------------------------------------------- fit
    def fit(self, train_data: Iterable[Dict[str, np.ndarray]],
            epochs: int = 1, steps_per_epoch: Optional[int] = None,
            validation_data: Optional[Iterable] = None,
            validation_steps: Optional[int] = None, verbose: int = 2,
            callbacks: Sequence[Callback] = (), **options) -> History:
        """Train for ``epochs``; with ``steps_per_epoch`` the data is one
        continuous stream across epochs (a finite re-iterable dataset
        repeats when it drains), without it each epoch is one pass. A
        batch-end hook that sets ``stop_training`` ends the run after that
        batch, with no validation pass, no epoch-end hooks and no History
        entry for its epoch; an epoch-end hook ends it after the epoch."""
        _refuse(options, _UNPORTED_FIT)
        if validation_data is not None and isinstance(validation_data,
                                                      Iterator):
            raise ValueError(
                "validation_data is a one-shot iterator; fit() evaluates it "
                "once per epoch, so pass a re-iterable dataset")
        history = History()
        self.stop_training = False
        self.global_step = 0
        for cb in callbacks:
            cb.set_trainer(self)
        final_logs: Dict[str, float] = {}
        try:
            self._run_hooks(callbacks, "on_train_begin")
            it = iter(train_data)
            for epoch in range(epochs):
                if self.stop_training:
                    break
                self._run_hooks(callbacks, "on_epoch_begin", epoch)
                if steps_per_epoch is None and epoch > 0:
                    if isinstance(train_data, Iterator):
                        raise ValueError(
                            "train_data is a one-shot iterator but "
                            "steps_per_epoch is None; pass a re-iterable "
                            "dataset or set steps_per_epoch")
                    it = iter(train_data)
                t0 = time.perf_counter()
                step_logs, samples = [], 0
                stopped_mid_epoch = False
                while (steps_per_epoch is None
                       or len(step_logs) < steps_per_epoch):
                    batch = next(it, None)
                    if batch is None and steps_per_epoch is not None and \
                            not isinstance(train_data, Iterator):
                        it = iter(train_data)  # .repeat() semantics
                        batch = next(it, None)
                    if batch is None:
                        break
                    samples += int(np.shape(batch[self.target_key])[0])
                    logs = self.train_step(batch)
                    step_logs.append(logs)
                    self._run_hooks(callbacks, "on_train_batch_end",
                                    self.global_step, logs=logs)
                    self.global_step += 1
                    if self.stop_training:
                        stopped_mid_epoch = True
                        break
                if not step_logs:
                    raise ValueError("empty training dataset/epoch")
                if stopped_mid_epoch:
                    break
                epoch_logs = _mean_logs(step_logs)
                dt = time.perf_counter() - t0
                if validation_data is not None:
                    epoch_logs.update(self.evaluate(
                        validation_data, steps=validation_steps,
                        _prefix="val_"))
                epoch_logs["images_per_sec"] = samples / dt if dt > 0 else 0.0
                history.append(epoch, epoch_logs)
                if verbose:
                    print(" - ".join(
                        [f"Epoch {epoch + 1}/{epochs}", f"{dt:.1f}s"]
                        + [f"{k}: {v:.4f}" for k, v in epoch_logs.items()
                           if k != "images_per_sec"]), file=sys.stderr)
                self._run_hooks(callbacks, "on_epoch_end", epoch,
                                logs=epoch_logs)
                final_logs = epoch_logs
        finally:
            self._run_hooks(callbacks, "on_train_end", logs=final_logs)
        self.history = history
        return history

    def _run_hooks(self, callbacks, hook: str, *args, logs=None) -> None:
        """Call ``hook`` on every callback in order. ``on_train_end`` is
        cleanup: every callback gets its turn even when one raises, and
        the first error is raised after the sweep (later ones are
        logged)."""
        deferred: Optional[Exception] = None
        for cb in callbacks:
            fn = getattr(cb, hook)
            if hook == "on_train_begin":
                fn()
            elif hook == "on_train_end":
                try:
                    fn(logs or {})
                except Exception as e:  # noqa: BLE001 - swept, re-raised
                    if deferred is None:
                        deferred = e
                    else:
                        log.error(
                            "on_train_end of %s also failed (suppressed "
                            "in favor of the first error): %s",
                            type(cb).__name__, e)
            elif hook == "on_epoch_begin":
                fn(args[0])
            else:  # on_epoch_end, on_train_batch_end
                fn(args[0], logs or {})
        if deferred is not None:
            raise deferred

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
    """Fetch once (one device sync), average on the host in float64. The
    exact key ``"perplexity"`` is logged in log space per batch, so its
    epoch value is the exp of the mean (``metrics.log_perplexity``)."""
    out = {}
    for k in logs_list[0]:
        mean = float(np.mean(torch.stack([d[k].float() for d in logs_list])
                             .cpu().numpy().astype(np.float64)))
        out[k] = float(np.exp(mean)) if k == "perplexity" else mean
    return out
