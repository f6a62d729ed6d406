"""Callbacks of the port's trainer: the reference's two (the port of
:class:`pddl_tpu.train.callbacks.ReduceLROnPlateau` and
:class:`~pddl_tpu.train.callbacks.EarlyStopping`, with the reference's
defaults, ``imagenet-resnet50.py:64-65``), Horovod's learning-rate warmup
(:class:`~pddl_tpu.train.callbacks.LearningRateWarmup`,
``imagenet-resnet50-hvd.py:114-115``), the JAX package's other five
(:class:`ModelSummary`, :class:`LambdaCallback`, :class:`CSVLogger`,
:class:`TensorBoard`, :class:`Timing`) and their base class. The
checkpoint callbacks live in :mod:`pddl_tpu_torch.ckpt`.

The JAX trainer's state is a value that hooks may replace; the port's
lives in the trainer's model and optimizer, which hooks change in place.
So a hook takes the hook's other arguments and returns nothing:
``on_train_begin()``, ``on_epoch_begin(epoch)``,
``on_train_batch_end(step, logs)``, ``on_epoch_end(epoch, logs)`` and
``on_train_end(logs)``, in the order of the JAX ``Trainer.fit``. A hook
stops training by setting ``trainer.stop_training``. The callbacks that
print or write do so on the coordinator only.

:class:`TensorBoard` writes the event files itself (no TensorFlow): the
TFRecord framing (length, masked CRC32C of the length, the record, its
masked CRC32C) around hand-encoded ``Event`` protos, with the records
TensorFlow's ``tf.summary.scalar`` writes for the JAX callback — a
``brain.Event:2`` version event, then per epoch and metric an event at
``step=epoch`` holding a scalar f32 tensor under the ``scalars`` plugin.
"""

from __future__ import annotations

import copy
import math
import os
import socket
import struct
import sys
import time
from typing import Callable, Dict, List, Optional

from pddl_tpu_torch.core import dist
from pddl_tpu_torch.train.state import get_learning_rate, set_learning_rate
from pddl_tpu_torch.utils.summary import param_summary


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


class ModelSummary(Callback):
    """Print the parameter table once at train start, coordinator-only —
    the reference's rank-0 ``print(model.summary())``
    (``imagenet-resnet50-hvd.py:95-96``)."""

    def on_train_begin(self):
        if dist.is_coordinator():
            print(param_summary(self.trainer.model), file=sys.stderr)


class LambdaCallback(Callback):
    """Hooks from plain functions, with the port's hook signatures."""

    def __init__(self, on_epoch_end: Optional[Callable] = None,
                 on_train_batch_end: Optional[Callable] = None,
                 on_train_begin: Optional[Callable] = None,
                 on_train_end: Optional[Callable] = None):
        self._fns = {"on_epoch_end": on_epoch_end,
                     "on_train_batch_end": on_train_batch_end,
                     "on_train_begin": on_train_begin,
                     "on_train_end": on_train_end}

    def _call(self, hook, *args):
        if self._fns[hook] is not None:
            self._fns[hook](*args)

    def on_train_begin(self):
        self._call("on_train_begin")

    def on_train_end(self, logs):
        self._call("on_train_end", logs)

    def on_epoch_end(self, epoch, logs):
        self._call("on_epoch_end", epoch, logs)

    def on_train_batch_end(self, step, logs):
        self._call("on_train_batch_end", step, logs)


class CSVLogger(Callback):
    """Epoch metrics to CSV on the coordinator — the History-file analogue."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self.append = append
        self._file = None
        self._keys: Optional[List[str]] = None

    def on_train_begin(self):
        if dist.is_coordinator():
            self._file = open(self.path, "a" if self.append else "w")

    def on_epoch_end(self, epoch, logs):
        if self._file is None:
            return
        if self._keys is None:
            self._keys = sorted(logs)
            self._file.write(",".join(["epoch"] + self._keys) + "\n")
        row = [str(epoch)] + [f"{logs.get(k, float('nan')):.6g}"
                              for k in self._keys]
        self._file.write(",".join(row) + "\n")
        self._file.flush()

    def on_train_end(self, logs):
        if self._file is not None:
            self._file.close()
            self._file = None


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def _masked_crc32c(data: bytes) -> int:
    """TFRecord's checksum: CRC32C (Castagnoli), rotated and offset."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: Optional[int] = None, **what) -> bytes:
    """An ``Event`` proto: wall_time (1, double), step (2, int64), and
    file_version (3) or summary (5)."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step is not None:
        out += b"\x10" + _varint(step)
    if "file_version" in what:
        out += _field(3, what["file_version"].encode())
        out += _field(10, _field(1, b"tensorflow.core.util.events_writer"))
    else:
        out += _field(5, what["summary"])
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    """A ``Summary`` with one value: the tag, a scalar DT_FLOAT tensor and
    the ``scalars`` plugin's metadata, as ``tf.summary.scalar`` writes."""
    tensor = (b"\x08\x01" + _field(2, b"")
              + _field(4, struct.pack("<f", value)))
    metadata = _field(1, _field(1, b"scalars"))
    return _field(1, _field(1, tag.encode()) + _field(8, tensor)
                  + _field(9, metadata))


class _EventWriter:
    """One ``events.out.tfevents.*`` file of TFRecord-framed events."""

    _count = 0

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        _EventWriter._count += 1
        name = (f"events.out.tfevents.{int(now)}.{socket.gethostname()}."
                f"{os.getpid()}.{_EventWriter._count}.v2")
        self._file = open(os.path.join(log_dir, name), "wb")
        self.write(_event(float(int(now)), file_version="brain.Event:2"))

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._file.write(header + struct.pack("<I", _masked_crc32c(header))
                         + record
                         + struct.pack("<I", _masked_crc32c(record)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.write(_event(time.time(), step,
                          summary=_scalar_summary(tag, value)))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


class TensorBoard(Callback):
    """Epoch metrics (and the learning rate) as TensorBoard event files,
    coordinator-only, in ``train``/``validation`` subdirectories as
    Keras's callback writes them: ``val_``-prefixed metrics land in
    ``validation`` under their bare name, so both curves overlay on one
    chart."""

    def __init__(self, log_dir: str, write_lr: bool = True):
        self.log_dir = log_dir
        self.write_lr = write_lr
        self._writers: Optional[Dict[str, _EventWriter]] = None

    def on_train_begin(self):
        if not dist.is_coordinator():
            return
        self._writers = {split: _EventWriter(os.path.join(self.log_dir,
                                                          split))
                         for split in ("train", "validation")}

    def on_epoch_end(self, epoch, logs):
        if self._writers is None:
            return
        by_split: Dict[str, Dict[str, float]] = {"train": {},
                                                  "validation": {}}
        for key, value in logs.items():
            if key.startswith("val_"):
                by_split["validation"][key[4:]] = value
            else:
                by_split["train"][key] = value
        if self.write_lr:
            by_split["train"]["learning_rate"] = get_learning_rate(
                self.trainer.optimizer)
        for split, metrics in by_split.items():
            for key, value in metrics.items():
                self._writers[split].scalar(key, float(value), epoch)
            if metrics:
                self._writers[split].flush()

    def on_train_end(self, logs):
        if self._writers is not None:
            for w in self._writers.values():
                w.close()
            self._writers = None


class Timing(Callback):
    """Wall-clock timing like the Horovod script's rank-0 ``Total time``
    print (``imagenet-resnet50-hvd.py:119-126``)."""

    def __init__(self, verbose: int = 1):
        self.verbose = verbose
        self.start: Optional[float] = None
        self.total: Optional[float] = None

    def on_train_begin(self):
        self.start = time.perf_counter()

    def on_train_end(self, logs):
        self.total = time.perf_counter() - self.start
        if self.verbose and dist.is_coordinator():
            print(f"Total time: {self.total:.1f}s", file=sys.stderr)
