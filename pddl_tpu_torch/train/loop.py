"""The Trainer: the port of :class:`pddl_tpu.train.loop.Trainer`'s
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
before ``eval_step``'s and ``predict``'s. Both steps add the auxiliary
losses the model sows (a routed block's ``moe_aux_loss``) to the task
loss and log its sown metrics (``moe_drop_rate``, the mean over the
routed blocks), as the JAX trainer does with its ``losses`` and
``metrics`` collections. With ``log_grad_norm`` the step
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
device is used as it is.

``strategy`` (:mod:`pddl_tpu_torch.parallel`) trains data-parallel (or
tensor- and expert-parallel: the strategy binds the model to its blocks
first and reduces the gradient norm over its axes), one process per
device, to the JAX trainer's numbers: each process takes its
rows of each batch (``Strategy.distribute_batch``), BatchNorm takes its
statistics over the global batch, the gradients are averaged over the
strategy's data group after the backward, and the strategy steps the
optimizer (the ps strategy on its slices of the state). The augment's
generator draws for the global batch on every process, each keeping its
rows' draws, so a data-parallel run with the augment is the single-device
run's. Each epoch's per-step logs are all-reduced to the global mean
before they are fetched, ``evaluate`` returns the global metrics,
``predict`` gathers every process's rows in order, and only the
coordinator prints. The strategy's device is the trainer's; without one
the trainer takes ``SingleDeviceStrategy(device)``, as the JAX trainer
does.

The optimizer options are the JAX trainer's: ``lr_schedule`` (with
``lr_schedule_options``), ``gradient_accumulation_steps`` and
``param_update`` go to :func:`pddl_tpu_torch.train.state.make_optimizer`
(with ``update_seed=seed``). ``ema_decay`` keeps shadows of the
parameters and of the floating-point buffers (BatchNorm's running
averages), ``e·d + (1−d)·p`` in the parameter's dtype, updated only on a
step that moves the parameters (under accumulation, the ``k``-th); with
``eval_with_ema`` (the default) ``evaluate`` runs on the shadows, buffers
included. ``predict`` runs on the live weights, as the JAX ``predict``
does. ``donate_state`` is accepted at both values and changes nothing:
the JAX trainer donates its state to the compiled step, the port's step
updates the model and the optimizer in place either way.

``fit(prefetch=n)`` (``n > 1``) keeps the next ``n`` batches staged: on
the card each is copied from pinned host memory on a side CUDA stream,
and the step's stream waits on the copy's event before it reads it; on
the CPU it is a plain lookahead. The numbers do not depend on it.

Fault recovery is the JAX trainer's (:mod:`pddl_tpu_torch.train.faults`):
every train and eval step goes through one guarded boundary
(:meth:`Trainer._device_call`) that consults ``fault_plan``, retries a
transient error in place (``max_retries`` times, backoff
``retry_backoff_s · 2^attempt`` waited by ``retry_sleep``) and, once the
retries are spent or on an OOM, restores the newest verified save of an
attached :class:`~pddl_tpu_torch.ckpt.CheckpointEveryN` and replays the
buffered batches (two save intervals) forward to the failed step, at
most ``max_recoveries`` times. A real error from the train step is never
retried in place: the step updates the state as it runs. The ``tracer``
hears every injection, retry, save, restore and recovery.
``fit(resume=dir)`` restores the newest verified save and continues
mid-epoch (``initial_epoch`` otherwise names the first epoch). The whole
state a save holds is :meth:`Trainer.state_dict`: the step counter, the
model's ``state_dict``, the optimizer's (moments, master, accumulator,
stochastic-rounding generator, schedule count) and the EMA shadows.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import time
from collections import deque
from typing import (Callable, Deque, Dict, Iterable, Iterator, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from pddl_tpu_torch.core import collectives
from pddl_tpu_torch.obs.trace import NULL_TRACER
from pddl_tpu_torch.ops.moe import sown
from pddl_tpu_torch.parallel.base import Strategy
from pddl_tpu_torch.parallel.single import SingleDeviceStrategy
from pddl_tpu_torch.train import metrics as metrics_lib
from pddl_tpu_torch.train.callbacks import Callback
from pddl_tpu_torch.train.faults import (
    InjectedResourceExhausted,
    InjectedTransientError,
    TrainStateLost,
    classify,
)
from pddl_tpu_torch.train.history import History

log = logging.getLogger(__name__)

# A batch staged for the step: (rows as fed, inputs, targets) on the
# trainer's device, and the copy's event on the card.
_Staged = Tuple[int, torch.Tensor, torch.Tensor]


class Trainer:
    """Training orchestrator: one card, or one process a card under a
    data-parallel ``strategy``.

    >>> trainer = Trainer(model, optimizer="adamw", learning_rate=1e-4,
    ...                   input_key="tokens", target_key="targets")
    >>> history = trainer.fit(SyntheticLanguageModeling(...), epochs=1,
    ...                       steps_per_epoch=100)

    ``seed`` seeds the augment's generators and the stochastic-rounding
    noise (the model arrives with its weights drawn).
    """

    def __init__(self, model: torch.nn.Module, optimizer="adam",
                 learning_rate: float = 1e-3,
                 loss: Union[str, Callable] = "sparse_categorical_crossentropy",
                 metrics: Sequence[Union[str, Callable]] = ("accuracy",),
                 strategy: Optional[Strategy] = None, seed: int = 0,
                 augment: Optional[Callable] = None,
                 eval_transform: Optional[Callable] = None,
                 donate_state: bool = True,
                 input_key: str = "image", target_key: str = "label",
                 lr_schedule: Optional[Union[str, Callable]] = None,
                 lr_schedule_options: Optional[Dict] = None,
                 ema_decay: Optional[float] = None,
                 eval_with_ema: bool = True,
                 gradient_accumulation_steps: Optional[int] = None,
                 log_grad_norm: bool = False, param_update: str = "plain",
                 fault_plan=None, max_retries: int = 3,
                 retry_backoff_s: float = 0.02, max_recoveries: int = 8,
                 tracer=None, retry_sleep=time.sleep, device=None):
        if strategy is None:
            strategy = SingleDeviceStrategy(device)
        elif not isinstance(strategy, Strategy):
            raise TypeError("strategy must be a pddl_tpu_torch.parallel "
                            f"Strategy, got {type(strategy).__name__}")
        self.strategy = strategy
        self.device = strategy.setup().device
        if device is not None and torch.device(device) not in (
                self.device, torch.device(self.device.type)):
            raise ValueError(f"device={device!r} but the strategy's "
                             f"process trains on {self.device}")
        self.model = model.to(self.device)
        strategy.bind(self.model)
        # The model itself, so the decay mask reads the JAX leaves' ranks.
        self.optimizer = strategy.make_optimizer(
            model, optimizer, learning_rate, schedule=lr_schedule,
            schedule_options=lr_schedule_options,
            accumulate_steps=gradient_accumulation_steps,
            param_update=param_update, update_seed=seed)
        self.loss_fn = metrics_lib.resolve_loss(loss)
        self.metric_fns = dict(metrics_lib.resolve_metric(m) for m in metrics)
        self.seed = seed
        self.augment = augment
        self.eval_transform = eval_transform
        self.donate_state = donate_state
        self.input_key = input_key
        self.target_key = target_key
        self.log_grad_norm = log_grad_norm
        self.ema_decay = ema_decay
        self.eval_with_ema = eval_with_ema
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay is not None:
            with torch.no_grad():
                self.ema = {name: t.detach().clone()
                            for name, t in self._floating_state().items()}
        # Steps taken (micro-steps under accumulation): the augment's
        # stream index and the fault plan's step coordinate.
        self.step = 0
        self.global_step = 0
        self.steps_per_epoch: Optional[int] = None
        self.stop_training = False
        self.history: Optional[History] = None

        # -- crash resilience ---------------------------------------------
        self._faults = fault_plan
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_recoveries = int(max_recoveries)
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._retry_sleep = retry_sleep
        if self._faults is not None and self._faults.on_inject is None:
            self._faults.on_inject = self._tracer.on_fault_injected
        self._site_wall: Dict[str, float] = {}
        self.fault_stats: Dict[str, float] = {
            "retries": 0, "recoveries": 0, "replayed_steps": 0,
            "checkpoints_saved": 0, "checkpoint_wall_s": 0.0,
        }
        self._recovery_cb = None
        self._replay_buffer: Optional[Deque] = None
        self._loader_state: Optional[Dict[str, int]] = None
        self._batches_consumed = 0
        self._copy_stream = None

    # ----------------------------------------------------------------- state
    def _floating_state(self) -> Dict[str, torch.Tensor]:
        """The parameters and floating-point buffers, by name: what the
        EMA shadows."""
        return {name: t for name, t in self.model.state_dict(
            keep_vars=True).items() if t.is_floating_point()}

    @torch.no_grad()
    def _update_ema(self) -> None:
        d = self.ema_decay
        live = self._floating_state()
        for name, shadow in self.ema.items():
            shadow.mul_(d).add_(live[name].detach() * (1.0 - d))

    def state_dict(self) -> dict:
        """Everything that decides the next step: the step counter, the
        model's ``state_dict``, the optimizer's and the EMA shadows."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "ema": self.ema}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            for name, shadow in self.ema.items():
                shadow.copy_(state["ema"][name])
        self.step = int(state["step"])

    # ----------------------------------------------------------------- steps
    def _tensor(self, value) -> torch.Tensor:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        return value.to(self.device, non_blocking=True)

    def _batch(self, batch) -> tuple:
        batch = self.strategy.distribute_batch(
            {k: batch[k] for k in (self.input_key, self.target_key)})
        return (self._tensor(batch[self.input_key]),
                self._tensor(batch[self.target_key]))

    def _generator(self) -> torch.Generator:
        """The augment's generator for this step, seeded from
        ``(seed + 1, step)``."""
        seed = np.random.SeedSequence((self.seed + 1, self.step))
        return torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0]))

    def _augment(self, x: torch.Tensor) -> torch.Tensor:
        """The augment with the global batch's draws: with ``n`` replicas
        this process's rows sit at their offset of a global-shaped batch
        (zeros elsewhere), and it keeps its rows of the result."""
        n = self.strategy.num_replicas_in_sync
        if n == 1:
            return self.augment(self._generator(), x)
        b, i = x.shape[0], self.strategy.mesh.index
        full = x.new_zeros((n * b,) + tuple(x.shape[1:]))
        full[i * b:(i + 1) * b] = x
        return self.augment(self._generator(), full)[i * b:(i + 1) * b]

    def _logs(self, loss, logits, labels, metrics=None
              ) -> Dict[str, torch.Tensor]:
        logs = {"loss": loss.detach()}
        for name, fn in self.metric_fns.items():
            logs[name] = fn(logits, labels)
        for name, values in (metrics or {}).items():
            logs[name] = sum(v.detach() for v in values) / len(values)
        return logs

    def _loss(self, logits, labels):
        """The task loss plus every auxiliary loss the model sowed in this
        forward (the MoE load-balancing loss), and the sown metrics: the
        JAX trainer's ``losses`` and ``metrics`` collections (a metric
        sown by several blocks is their mean, as ``_sown_metrics``)."""
        loss = self.loss_fn(logits, labels)
        got = sown(self.model)
        for values in got["losses"].values():
            for aux in values:
                loss = loss + aux.sum()
        return loss, got["metrics"]

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One step on ``batch``; logs stay on the device."""
        return self._train_step(*self._batch(batch))

    def _train_step(self, x: torch.Tensor,
                    y: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.augment is not None:
            x = self._augment(x)
        self.model.train()
        # The model's, not the optimizer's: under the ps strategy the
        # optimizer holds slices, not the whole parameters.
        self.model.zero_grad(set_to_none=True)
        logits = self.model(x)
        loss, sown_metrics = self._loss(logits, y)
        loss.backward()
        self.strategy.reduce_gradients(self.model)
        with torch.no_grad():
            logs = self._logs(loss, logits.detach(), y, sown_metrics)
            if self.log_grad_norm:
                logs["grad_norm"] = self.strategy.grad_norm(self.model)
        self.strategy.optimizer_step(self.optimizer)
        # Under accumulation the parameters moved only if the window
        # closed (mini_step back at 0): the EMA follows the updates.
        if self.ema is not None and getattr(self.optimizer, "mini_step",
                                            0) == 0:
            self._update_ema()
        self.step += 1
        return logs

    @torch.no_grad()
    def _eval_logits(self, x: torch.Tensor, ema: bool) -> torch.Tensor:
        if self.eval_transform is not None:
            x = self.eval_transform(x)
        self.model.eval()
        if ema and self.eval_with_ema and self.ema is not None:
            return torch.func.functional_call(self.model, self.ema, (x,),
                                              {"train": False})
        return self.model(x, train=False)

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        return self._eval_step(*self._batch(batch))

    def _eval_step(self, x, y) -> Dict[str, torch.Tensor]:
        logits = self._eval_logits(x, ema=True)
        loss, sown_metrics = self._loss(logits, y)
        return self._logs(loss, logits, y, sown_metrics)

    def predict(self, images) -> np.ndarray:
        """Forward pass in inference mode on a batch of images, on the
        live weights; the logits come back as a host array (with a
        strategy, every process's rows in order)."""
        x = self.strategy.distribute_batch({"x": images})["x"]
        logits = self._eval_logits(self._tensor(x), ema=False)
        if self.strategy.group is not None:
            logits = collectives.all_gather(logits, self.strategy.group,
                                            tiled=True)
        return logits.cpu().numpy()

    # -------------------------------------------------------- fault handling
    def attach_recovery(self, checkpoint_cb) -> None:
        """Make a ``CheckpointEveryN`` callback the in-process restore
        source (its ``set_trainer`` calls this). The replay buffer holds
        two save intervals: the newest save may be torn, and recovery
        must still reach the previous verified one."""
        self._recovery_cb = checkpoint_cb
        self._replay_buffer = deque(
            maxlen=2 * int(checkpoint_cb.every_n_steps))

    def on_checkpoint_saved(self, step: int, wall_s: float) -> None:
        """``CheckpointEveryN``'s save hook: telemetry only."""
        self.fault_stats["checkpoints_saved"] += 1
        self.fault_stats["checkpoint_wall_s"] += wall_s
        self._tracer.on_checkpoint_saved(step, wall_s)

    def loader_state(self) -> Optional[Dict[str, int]]:
        """The data position after the latest step: ``{"epoch",
        "step_in_epoch", "batches_consumed"}``, what a step-granular save
        records so ``fit(resume=...)`` repositions the stream. ``None``
        before the first step."""
        return dict(self._loader_state) if self._loader_state else None

    def fault_snapshot(self) -> Dict[str, object]:
        """The JAX trainer's flat export dict, every key always present."""
        injected = ({k.value: v for k, v in self._faults.injected.items()}
                    if self._faults is not None else {})
        return {
            **{k: self.fault_stats[k] for k in sorted(self.fault_stats)},
            "faults_injected": injected,
            "site_wall_s": {k: round(v, 6)
                            for k, v in sorted(self._site_wall.items())},
            "compile_counts": {},  # the port runs eagerly: no programs
            "opt_step": self.step,
        }

    def _device_call(self, site: str, fn, *args):
        """The one guarded dispatch boundary: consult the fault plan,
        classify a failure, retry a transient one with doubling backoff,
        and escalate to :class:`TrainStateLost` when the budget runs out,
        on any OOM, or on a real error from the train step (which updates
        the state as it runs, so it cannot be re-dispatched). Injected
        faults fire before ``fn`` runs. ``KillPoint`` is a BaseException
        and passes through, like the SIGKILL it stands for."""
        attempt = 0
        while True:
            try:
                if self._faults is not None:
                    self._faults.check(site)
                t0 = time.perf_counter()
                out = fn(*args)
                self._site_wall[site] = (self._site_wall.get(site, 0.0)
                                         + time.perf_counter() - t0)
                return out
            except Exception as e:
                kind = classify(e)
                if kind is None:
                    raise  # not a device fault: bugs stay loud
                injected = isinstance(e, (InjectedTransientError,
                                          InjectedResourceExhausted))
                if kind == "oom" or (not injected and site == "train_step"):
                    raise TrainStateLost(site, e) from e
                attempt += 1
                if attempt > self.max_retries:
                    raise TrainStateLost(site, e) from e
                self.fault_stats["retries"] += 1
                self._tracer.on_retry(self.step, site, attempt)
                self._retry_sleep(self.retry_backoff_s * (2 ** (attempt - 1)))

    def _guarded_train_step(self, x, y) -> Dict[str, torch.Tensor]:
        """One step through the guarded boundary; on escalation restore
        the newest verified save in-process, replay forward to this step
        and run it again."""
        step = self.step
        while True:
            try:
                if self._faults is not None:
                    self._faults.on_step(self.step)
                logs = self._device_call("train_step", self._train_step,
                                         x, y)
                break
            except TrainStateLost as lost:
                self._restore_and_replay(lost, step)
        if self._replay_buffer is not None:
            self._replay_buffer.append((step, (x, y)))
        return logs

    def _restore_and_replay(self, lost: TrainStateLost, target: int) -> None:
        """Roll the state back to the newest verified save and replay the
        buffered batches forward to ``target``, the step that failed."""
        from pddl_tpu_torch.ckpt.checkpoint import local_state

        cb = self._recovery_cb
        if cb is None or cb.ckpt is None:
            raise lost
        for _ in range(self.max_recoveries):
            self.fault_stats["recoveries"] += 1
            cb.ckpt.wait()  # an in-flight async save may be the newest good
            state, meta = cb.ckpt.restore()
            restored_step = int(state["step"])
            if restored_step > target:
                raise RuntimeError(
                    f"newest checkpoint (step {restored_step}) is AHEAD "
                    f"of the failed step {target}; cannot replay "
                    "backwards — is another run writing this directory?"
                ) from lost
            buffered = dict(self._replay_buffer or ())
            missing = [s for s in range(restored_step, target)
                       if s not in buffered]
            if missing:
                raise RuntimeError(
                    f"replay buffer does not cover steps {missing} "
                    f"between the restored checkpoint ({restored_step}) "
                    f"and the failed step ({target}) — checkpoint "
                    "cadence outran the buffer") from lost
            self._tracer.on_restore(target, restored_step, lost.site)
            self.load_state_dict(local_state(self, state, meta))
            try:
                for s in range(restored_step, target):
                    if self._faults is not None:
                        self._faults.on_step(s)
                    self._device_call("train_step", self._train_step,
                                      *buffered[s])
                    self.fault_stats["replayed_steps"] += 1
            except TrainStateLost as again:
                lost = again
                continue
            self._tracer.on_recovery(target, restored_step,
                                     target - restored_step)
            log.warning(
                "recovered in-process from %s at step %d: restored "
                "step %d and replayed %d step(s)", lost.site, target,
                restored_step, target - restored_step)
            return
        raise RuntimeError(
            f"recovery budget exhausted ({self.max_recoveries} "
            f"restore+replay attempts) at step {target}") from lost

    # --------------------------------------------------------------- prefetch
    def _stage(self, batch) -> Tuple[_Staged, Optional[object]]:
        """This process's rows of ``batch`` on the device. On the card a
        host field is copied from pinned memory on the side stream, and
        the copy's event comes back with it."""
        rows = int(np.shape(batch[self.target_key])[0])
        batch = self.strategy.distribute_batch(
            {k: batch[k] for k in (self.input_key, self.target_key)})
        fields = (batch[self.input_key], batch[self.target_key])
        if self._copy_stream is None:
            return (rows, *(self._tensor(v) for v in fields)), None
        out = []
        with torch.cuda.stream(self._copy_stream):
            for v in fields:
                if isinstance(v, torch.Tensor) and v.device == self.device:
                    out.append(v)
                    continue
                host = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                    np.asarray(v))
                out.append(host.pin_memory().to(self.device,
                                                non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return (rows, *out), event

    def _ready(self, staged, event) -> _Staged:
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in staged[1:]:
                t.record_stream(stream)
        return staged

    def _feed(self, it: Iterator, depth: int) -> Iterator[_Staged]:
        """Staged batches of ``it``, ``depth`` ahead when ``depth > 1``
        (the JAX trainer's rule: 0 and 1 disable the lookahead)."""
        if not depth or depth <= 1:
            for batch in it:
                yield self._ready(*self._stage(batch))
            return
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        q: Deque = deque()

        def fill():
            while len(q) < depth:
                batch = next(it, None)
                if batch is None:
                    return
                q.append(self._stage(batch))

        fill()
        while q:
            staged = self._ready(*q.popleft())
            fill()
            yield staged

    # ------------------------------------------------------------------- fit
    def fit(self, train_data: Iterable[Dict[str, np.ndarray]],
            epochs: int = 1, steps_per_epoch: Optional[int] = None,
            validation_data: Optional[Iterable] = None,
            validation_steps: Optional[int] = None,
            callbacks: Sequence[Callback] = (), verbose: int = 2,
            initial_epoch: int = 0, prefetch: int = 2,
            resume=None) -> History:
        """Train epochs ``initial_epoch`` to ``epochs - 1``; with
        ``steps_per_epoch`` the data is one continuous stream across
        epochs (a finite re-iterable dataset repeats when it drains),
        without it each epoch is one pass. A batch-end hook that sets
        ``stop_training`` ends the run after that batch, with no
        validation pass, no epoch-end hooks and no History entry for its
        epoch; an epoch-end hook ends it after the epoch. ``resume`` (a
        checkpoint directory or :class:`~pddl_tpu_torch.ckpt.Checkpointer`)
        restores the newest verified save and continues where it was
        taken, mid-epoch; an empty directory starts fresh."""
        if validation_data is not None and isinstance(validation_data,
                                                      Iterator):
            raise ValueError(
                "validation_data is a one-shot iterator; fit() evaluates it "
                "once per epoch, so pass a re-iterable dataset")
        history = History()
        self.stop_training = False
        self.global_step = 0
        self.steps_per_epoch = steps_per_epoch
        self._batches_consumed = 0
        self._loader_state = None
        if self._replay_buffer is not None:
            self._replay_buffer.clear()  # stale steps would alias

        resume_offset = 0  # steps already done inside the resumed epoch
        host_skip = 0      # batches to drop from the fresh iterator
        if resume is not None:
            prepared = self._prepare_resume(resume, train_data,
                                            steps_per_epoch)
            if prepared is not None:
                train_data, initial_epoch, resume_offset, host_skip = prepared
        train_iter = iter(train_data)
        if host_skip:
            train_iter = _skip_consumed(train_iter, host_skip, train_data,
                                        steps_per_epoch)
        for cb in callbacks:
            cb.set_trainer(self)
        final_logs: Dict[str, float] = {}
        continuous_feed = None
        try:
            self._run_hooks(callbacks, "on_train_begin")
            for epoch in range(initial_epoch, epochs):
                if self.stop_training:
                    break
                self._run_hooks(callbacks, "on_epoch_begin", epoch)
                offset = resume_offset if epoch == initial_epoch else 0
                if steps_per_epoch is not None:
                    # One persistent feed across epochs: a new one each
                    # epoch would drop the batches the lookahead holds.
                    if continuous_feed is None:
                        continuous_feed = self._feed(
                            _repeating(train_iter, train_data), prefetch)
                    feed = continuous_feed
                elif epoch == initial_epoch:
                    feed = self._feed(train_iter, prefetch)
                else:
                    if isinstance(train_data, Iterator):
                        raise ValueError(
                            "train_data is a one-shot iterator but "
                            "steps_per_epoch is None; pass a re-iterable "
                            "dataset or set steps_per_epoch")
                    feed = self._feed(iter(train_data), prefetch)
                t0 = time.perf_counter()
                step_logs, samples = [], 0
                stopped_mid_epoch = False
                while (steps_per_epoch is None
                       or offset + len(step_logs) < steps_per_epoch):
                    staged = next(feed, None)
                    if staged is None:
                        break
                    rows, x, y = staged
                    samples += rows
                    logs = self._guarded_train_step(x, y)
                    step_logs.append(logs)
                    # The loader position settles before the batch-end
                    # hooks, so a save there records this step's.
                    self._batches_consumed += 1
                    in_ep = offset + len(step_logs)
                    if (steps_per_epoch is not None
                            and in_ep >= steps_per_epoch):
                        self._loader_state = {
                            "epoch": epoch + 1, "step_in_epoch": 0,
                            "batches_consumed": self._batches_consumed}
                    else:
                        self._loader_state = {
                            "epoch": epoch, "step_in_epoch": in_ep,
                            "batches_consumed": self._batches_consumed}
                    self._run_hooks(callbacks, "on_train_batch_end",
                                    self.global_step, logs=logs)
                    self.global_step += 1
                    if self.stop_training:
                        stopped_mid_epoch = True
                        break
                if not step_logs:
                    if offset:
                        # The resumed epoch had finished before the save.
                        continue
                    raise ValueError("empty training dataset/epoch")
                if stopped_mid_epoch:
                    break
                self._loader_state = {
                    "epoch": epoch + 1, "step_in_epoch": 0,
                    "batches_consumed": self._batches_consumed}
                epoch_logs = _mean_logs(step_logs, self.strategy.batch_group)
                dt = time.perf_counter() - t0
                if validation_data is not None:
                    epoch_logs.update(self.evaluate(
                        validation_data, steps=validation_steps,
                        _prefix="val_"))
                epoch_logs["images_per_sec"] = samples / dt if dt > 0 else 0.0
                history.append(epoch, epoch_logs)
                if verbose and self.strategy.is_coordinator:
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

    def _prepare_resume(self, resume, train_data, steps_per_epoch):
        """Restore the newest verified save and work out where the stream
        restarts: ``(train_data, initial_epoch, step_offset, host_skip)``,
        or ``None`` when the directory holds no save yet (a fresh start:
        one command line for the first launch and every restart). A
        dataset with ``with_offset(n)`` is shifted by the batches consumed
        (with ``steps_per_epoch``); otherwise ``host_skip`` batches are
        drained from a fresh iterator (without ``steps_per_epoch``, only
        the resumed epoch's)."""
        from pddl_tpu_torch.ckpt.checkpoint import Checkpointer, local_state

        if isinstance(train_data, Iterator):
            raise ValueError(
                "fit(resume=...) needs a re-iterable dataset — a one-shot "
                "iterator cannot be repositioned to the saved offset")
        own = isinstance(resume, (str, os.PathLike))
        ckpt = Checkpointer(resume, async_save=False) if own else resume
        if ckpt.latest_step() is None:
            log.info("resume: no checkpoint under %s yet — fresh run",
                     ckpt.directory)
            return None
        state, meta = ckpt.restore()
        self.load_state_dict(local_state(self, state, meta))
        loader = meta.get("loader") or None
        if loader:
            initial_epoch = int(loader.get("epoch", 0))
            offset = int(loader.get("step_in_epoch", 0))
            consumed = int(loader.get("batches_consumed", 0))
        else:
            saved = meta.get("epoch")
            initial_epoch = int(saved) + 1 if saved is not None else 0
            offset = consumed = 0
        self._batches_consumed = consumed
        skip = consumed if steps_per_epoch is not None else offset
        host_skip = 0
        if skip:
            if (steps_per_epoch is not None
                    and hasattr(train_data, "with_offset")):
                train_data = train_data.with_offset(skip)
            else:
                host_skip = skip
        log.info("resume: restored verified step %d (epoch %d, "
                 "step_in_epoch %d, %d batches consumed)", self.step,
                 initial_epoch, offset, consumed)
        return train_data, initial_epoch, offset, host_skip

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
        """Mean loss and metrics over ``steps`` batches (or one pass), on
        the EMA shadows under ``eval_with_ema``. A transient fault is
        retried in place; past the budget its error is raised (eval
        changes no state, so there is nothing to restore)."""
        logs_list = []
        for batch in itertools.islice(data, steps):
            x, y = self._batch(batch)
            try:
                if self._faults is not None:
                    self._faults.on_step(self.step)
                logs_list.append(self._device_call(
                    "eval_step", torch.no_grad()(self._eval_step), x, y))
            except TrainStateLost as lost:
                raise lost.err
        if not logs_list:
            raise ValueError("empty evaluation dataset")
        out = {_prefix + k: v
               for k, v in _mean_logs(logs_list, self.strategy.batch_group).items()}
        if verbose and self.strategy.is_coordinator:
            print(" - ".join(f"{k}: {v:.4f}" for k, v in out.items()),
                  file=sys.stderr)
        return out


def _repeating(first: Iterator, data) -> Iterator:
    """``first``, then fresh passes over ``data`` when it drains (the
    reference's ``.repeat()`` under a fixed ``steps_per_epoch``); a
    one-shot iterator just ends, and so does an empty fresh pass.
    ``first`` may be drained already (a resume's skip that ended on a
    pass boundary): that alone does not end the stream."""
    it, fresh = first, False
    while True:
        yielded = False
        for b in it:
            yielded = True
            yield b
        if isinstance(data, Iterator) or (fresh and not yielded):
            return
        it, fresh = iter(data), True


def _skip_consumed(it: Iterator, n: int, data, steps_per_epoch) -> Iterator:
    """Drain ``n`` already-consumed batches, re-iterating a finite dataset
    under ``steps_per_epoch`` as the interrupted run's feed did."""
    skipped = 0
    while skipped < n:
        advanced = False
        for _ in it:
            advanced = True
            skipped += 1
            if skipped == n:
                return it
        if (steps_per_epoch is None or isinstance(data, Iterator)
                or not advanced):
            raise ValueError(
                f"resume: dataset ended after {skipped} of {n} "
                "already-consumed batches — the stream is shorter than it "
                "was before the crash")
        it = iter(data)
    return it


def _mean_logs(logs_list, group=None) -> Dict[str, float]:
    """Fetch once (one device sync), average on the host in float64. With
    a data ``group`` each step's logs are first averaged over it, in one
    all-reduce. The exact key ``"perplexity"`` is logged in log space per
    batch, so its epoch value is the exp of the mean
    (``metrics.log_perplexity``). The keys come out sorted, as the JAX
    trainer's do (its logs pass through a pytree)."""
    keys = sorted(logs_list[0])
    steps = torch.stack([torch.stack([d[k].float() for d in logs_list])
                         for k in keys])
    if group is not None:
        steps = collectives.pmean(steps, group)
    steps = steps.cpu().numpy().astype(np.float64)
    out = {}
    for k, row in zip(keys, steps):
        mean = float(np.mean(row))
        out[k] = float(np.exp(mean)) if k == "perplexity" else mean
    return out
