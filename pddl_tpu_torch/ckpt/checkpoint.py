"""Verified, step-granular checkpoints of the trainer's state (the port of
:mod:`pddl_tpu.ckpt.checkpoint`, without Orbax).

**The format is the port's own.** A save is one directory a step::

    <directory>/<step>/state.pt    torch.save of Trainer.state_dict(),
                                   every tensor a CPU copy
    <directory>/<step>/meta.json   {"format", "step", "epoch", "metrics",
                                    "loader", "checksums"}

``checksums`` holds a CRC32 (hex) per leaf of the state, over the leaf's
bytes (a tensor's storage, a number's ``repr``), keyed by its path
(``model/blocks.0.ln1.weight``, ``optimizer/inner/state/3/exp_avg``).
A save is written under ``<step>.tmp-<pid>``, each file fsynced, and the
directory renamed to ``<step>`` last (then its parent fsynced), so a save
torn before the rename has no ``<step>`` directory and no metadata; a
writer removes leftover temporaries when it opens the directory. The
state loads with ``torch.load(weights_only=True)``: tensors, numbers,
strings and containers only.

**Verify on restore.** :meth:`Checkpointer.restore` recomputes the
checksums of what it read and compares them with the metadata. Without an
explicit step it tries the saves newest first and skips one that does not
load or does not verify (a torn or tampered file), with a warning: the
restart must not be wedged by the crash it recovers from. That is why the
writers here keep at least two saves.

**What a save holds** is everything that decides the next step, bit for
bit: the parameters and buffers, the optimizer state (moments, an
``f32_master`` rule's masters, the accumulator, the stochastic-rounding
generator, the schedule's count), the EMA shadows, and the step counter
on which the augment's generator and the fault coordinates depend.
:class:`CheckpointEveryN` adds the trainer's loader position, so
``Trainer.fit(resume=...)`` continues mid-epoch bitwise, and the
trainer's in-process recovery restores from the same saves.

``async_save`` copies the state to the host at the call and writes it on
a thread; :meth:`Checkpointer.wait` joins it (a restore waits first).

**Across processes, one save.** Under a strategy whose group spans
processes (``mirrored``, ``multiworker``, ``ps``, the Horovod shim's,
``tensor_parallel``, ``expert_parallel`` and ``pipeline``, whose save
group is every process of the mesh, and a sequence-parallel mirrored
strategy, whose is every process of the batch),
every process calls the save (the callbacks do, through
:meth:`Checkpointer.save_trainer`) and one step directory in the format
above results, which no world size shapes: :func:`whole_state` gathers
each ``ps`` process's ``1/k`` slice of optimizer state into its whole
tensor first (the other strategies' state is whole on every process),
and ``meta.json`` records under ``param_state`` the parameter of each
per-parameter optimizer tensor, by its path. Rank 0 alone writes and
renames, synchronously; every process then waits on a barrier, so no
process reads a save that is not there. A restore is every process's:
each reads the same file and :func:`local_state` cuts the tensors of the
parameters its strategy shards to its own slice. So a 2-process ``ps``
save restores into one process, into ``mirrored``, or into ``ps`` at
another size, as Orbax restores onto another mesh in the JAX package.
Every process consumes one batch of its part a step, so the loader
position is one for all: a save checks that the processes agree and
records it once.

**The call forms against the JAX package's.** :meth:`Checkpointer.save`
takes the JAX form, ``save(state, epoch=None, metrics=None, force=False,
loader=None, checksum=True)``. The JAX ``force`` overrides Orbax's
save-interval policy; the port has no such policy, so every save writes
and ``force`` is accepted and changes nothing. :meth:`Checkpointer.restore`
keeps the port's form, ``restore(step=None, verify=True) -> (state,
metadata)``, which the trainer's recovery and ``fit(resume=)`` call: the
JAX ``restore(target, step=None, verify=True)`` lays the state out like
``target``, while a ``Trainer.state_dict()`` needs no target. A JAX-form
call, which passes its target tree where the step goes, raises a
``TypeError`` naming the port's form instead of reading the tree as a
step (so does any step that is not an integer).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from pddl_tpu_torch.core import collectives, dist
from pddl_tpu_torch.train.callbacks import Callback

log = logging.getLogger(__name__)

FORMAT = 1
_STATE, _META = "state.pt", "meta.json"
# The key of a trainer save's {optimizer tensor path: parameter name}:
# what a restore at another world size slices the tensor by.
OWNERS = "param_state"
_LOADER_KEYS = ("epoch", "step_in_epoch", "batches_consumed")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint loaded but failed checksum verification (torn write,
    bit rot, a partial copy), or no save under a directory verifies."""


def _leaves(tree, prefix: str = ""):
    """``(path, leaf)`` for every tensor and scalar of a nested
    dict/list state."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _crc(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        data = leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        return f"{zlib.crc32(data.numpy()):08x}"
    return f"{zlib.crc32(repr(leaf).encode()):08x}"


def tree_checksums(state) -> Dict[str, str]:
    """CRC32 (hex) of every leaf of ``state``, keyed by its path: the
    integrity metadata a save records and a restore re-derives."""
    return {path: _crc(leaf) for path, leaf in _leaves(state)}


def _map_leaves(tree, fn, prefix: str = ""):
    """``tree`` rebuilt with each leaf replaced by ``fn(path, leaf)``
    (the paths of :func:`_leaves`)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _to_host(tree):
    """A CPU copy of every tensor of ``tree`` (the containers rebuilt)."""
    return _map_leaves(tree, lambda _, leaf: (
        leaf.detach().to("cpu", copy=True)
        if isinstance(leaf, torch.Tensor) else leaf))


def _nbytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in _leaves(tree) if isinstance(leaf, torch.Tensor))


def _fsync_write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Save and restore the trainer's state with step-numbered retention.

    >>> ckpt = Checkpointer("build/run1", max_to_keep=3)
    >>> ckpt.save(trainer.state_dict(), epoch=4)
    >>> state, meta = ckpt.restore()
    >>> trainer.load_state_dict(state)
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 5,
                 async_save: bool = True, read_only: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.read_only = read_only
        # The process group of the trainer whose state is saved
        # (:meth:`save_trainer`): with more than one member, its first
        # writes and every member waits.
        self.group = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None
        # The last save's bytes and seconds: the host copy, and the write.
        self.last_save_bytes = 0
        self.last_copy_s = 0.0
        self.last_write_s = 0.0
        if not read_only:
            os.makedirs(self.directory, exist_ok=True)
            # Only the coordinator writes, so only it removes temporaries.
            for name in (os.listdir(self.directory) if dist.is_coordinator()
                         else ()):
                if ".tmp-" in name:  # a save torn before its rename
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)

    # ---------------------------------------------------------------- save
    def save(self, state: dict, epoch: Optional[int] = None,
             metrics: Optional[Dict[str, float]] = None, force: bool = False,
             loader: Optional[Dict[str, Any]] = None,
             checksum: bool = True) -> int:
        """Save ``state`` (a ``Trainer.state_dict()``) at its step, with
        the epoch, metrics and loader position, and with the checksums
        unless ``checksum=False``. Returns the step. ``force`` is the JAX
        call form's: every save writes here (module docstring)."""
        del force
        return self._save(state, epoch, metrics, loader, checksum, None)

    def save_trainer(self, trainer, epoch: Optional[int] = None,
                     metrics: Optional[Dict[str, float]] = None,
                     loader: Optional[Dict[str, Any]] = None,
                     checksum: bool = True) -> int:
        """Save ``trainer``'s state in the form no world size shapes
        (:func:`whole_state`, recording :data:`OWNERS`), as its group's
        save: under a strategy over several processes every process calls
        it, rank 0 writes. Returns the step."""
        self.group = trainer.strategy.save_group
        state, owners = whole_state(trainer)
        return self._save(state, epoch, metrics, loader, checksum, owners)

    def _save(self, state, epoch, metrics, loader, checksum, owners) -> int:
        if self.read_only:
            raise RuntimeError(f"{self.directory} is opened read-only")
        self.wait()
        if self.group is not None and collectives.axis_size(self.group) > 1:
            # Rank 0 writes and renames, synchronously; every member
            # waits on the barrier after the rename (even if it failed).
            step = int(state["step"])
            try:
                if collectives.axis_index(self.group) == 0:
                    host, meta = self._prepare(state, epoch, metrics,
                                               loader, checksum, owners)
                    self._write(step, host, meta)
            finally:
                tdist.barrier(group=self.group)
            return step
        host, meta = self._prepare(state, epoch, metrics, loader, checksum,
                                   owners)
        step = meta["step"]
        if self.async_save:
            self._pending = step
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)
        return step

    def _prepare(self, state, epoch, metrics, loader, checksum, owners):
        """The host copy of ``state`` and its metadata."""
        t0 = time.perf_counter()
        host = _to_host(state)
        self.last_copy_s = time.perf_counter() - t0
        self.last_save_bytes = _nbytes(host)
        step = int(host["step"])
        meta: Dict[str, Any] = {"format": FORMAT, "step": step,
                                "epoch": epoch, "metrics": metrics or {}}
        if loader is not None:
            meta["loader"] = dict(loader)
        if owners:
            meta[OWNERS] = dict(owners)
        if checksum:
            meta["checksums"] = tree_checksums(host)
        return host, meta

    def _write_guarded(self, step, host, meta) -> None:
        try:
            self._write(step, host, meta)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _write(self, step: int, host: dict, meta: dict) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STATE), "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_write(os.path.join(tmp, _META), json.dumps(meta).encode())
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        self.last_write_s = time.perf_counter() - t0
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)

    def wait(self) -> None:
        """Block until an in-flight async save has landed; raise its
        error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        """Every finalized step, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, _META)))

    def latest_step(self) -> Optional[int]:
        """The newest step saved, an in-flight async save included."""
        steps = self.all_steps()
        if self._pending is not None:
            steps.append(self._pending)
        return max(steps) if steps else None

    def metadata(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            return {}
        self.wait()
        with open(os.path.join(self.directory, str(step), _META)) as f:
            return json.load(f)

    def newest_metadata(self) -> Dict[str, Any]:
        """The newest readable metadata: a torn latest falls back to the
        previous save's."""
        for s in reversed(self.all_steps()):
            try:
                return self.metadata(s)
            except Exception as e:  # noqa: BLE001 - torn save
                log.warning("metadata: step %d unreadable (%s); trying "
                            "the previous save", s, e)
        return {}

    def verify(self, state: dict, step: int) -> bool:
        """Does ``state`` match the checksums recorded for ``step``?
        ``True`` when the save has none."""
        expected = self.metadata(step).get("checksums")
        if not expected:
            return True
        return tree_checksums(state) == expected

    def restore(self, step: Optional[int] = None, verify: bool = True
                ) -> Tuple[dict, Dict[str, Any]]:
        """``(state, metadata)`` of ``step``, or of the newest save that
        loads and verifies (module docstring); the state's tensors are on
        the CPU. An explicit ``step`` raises instead of falling back:
        :class:`CheckpointCorruptError` on a checksum mismatch."""
        if step is not None and not isinstance(step, (int, np.integer)):
            raise TypeError(
                "Checkpointer.restore(step=None, verify=True) -> (state, "
                "metadata) takes no target tree (the JAX package's "
                "restore(target, step, verify) form): load the returned "
                "state with Trainer.load_state_dict")
        self.wait()
        if step is not None:
            return self._restore_verified(step, verify)
        candidates = self.all_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        last_err: Optional[BaseException] = None
        for s in reversed(candidates):
            try:
                return self._restore_verified(s, verify)
            except Exception as e:  # noqa: BLE001 - torn/corrupt saves
                last_err = e
                log.warning("restore: step %d is torn or corrupt (%s); "
                            "falling back to the previous verified save",
                            s, e)
        raise CheckpointCorruptError(
            f"no restorable checkpoint under {self.directory}: newest "
            f"failure: {last_err}") from last_err

    def _restore_verified(self, step: int, verify: bool):
        path = os.path.join(self.directory, str(step), _STATE)
        state = torch.load(path, map_location="cpu", weights_only=True)
        meta = self.metadata(step)
        expected = meta.get("checksums")
        if verify and expected and tree_checksums(state) != expected:
            raise CheckpointCorruptError(
                f"checkpoint step {step} under {self.directory} failed "
                "checksum verification (torn or corrupted save)")
        return state, meta

    def close(self) -> None:
        self.wait()


def latest_epoch(directory: str) -> Optional[int]:
    """The epoch recorded in the newest readable save under
    ``directory`` (for ``initial_epoch`` on resume), or ``None``."""
    if not os.path.isdir(directory):
        return None
    ckpt = Checkpointer(directory, async_save=False, read_only=True)
    if ckpt.latest_step() is None:
        return None
    return ckpt.newest_metadata().get("epoch")


def _param_owners(trainer) -> Dict[int, str]:
    """``data_ptr`` -> parameter name for every per-parameter tensor of
    the trainer's optimizer state (its moments, an ``f32_master`` rule's
    masters, the accumulator); a ps slice's by its parameter's name."""
    names = {p: n for n, p in trainer.model.named_parameters()}
    names.update(getattr(trainer.strategy, "sharded_targets", dict)())
    out: Dict[int, str] = {}

    def own(target, t) -> None:
        name = names.get(target)
        if (name is not None and isinstance(t, torch.Tensor) and t.numel()
                and t.shape == target.shape):
            out[t.data_ptr()] = name

    rule = trainer.optimizer
    for target, st in rule.state.items():
        for t in st.values():
            own(target, t)
    while rule is not None:
        if hasattr(rule, "masters"):
            for target, t in rule.masters().items():
                own(target, t)
        for target, t in getattr(rule, "_acc", {}).items():
            own(target, t)
        rule = getattr(rule, "inner", None)
    return out


def whole_state(trainer) -> Tuple[dict, Dict[str, str]]:
    """``(state, owners)``: ``trainer.state_dict()`` in a form no world
    size shapes — every slice of a ps strategy's optimizer state gathered
    into its whole tensor (a collective: every process of the group calls
    it) — and the parameter of each per-parameter optimizer tensor, by
    its path, which a save records (:data:`OWNERS`) for
    :func:`local_state`."""
    strategy = trainer.strategy
    if hasattr(strategy, "whole_trainer_state"):  # the pipeline's own form
        return strategy.whole_trainer_state(trainer)
    state = trainer.state_dict()
    owned = _param_owners(trainer)
    sharded = set(getattr(strategy, "sharded_targets", dict)().values())
    owners: Dict[str, str] = {}

    def whole(path, leaf):
        if not isinstance(leaf, torch.Tensor) or not leaf.numel():
            return leaf
        name = owned.get(leaf.data_ptr())
        if name is None:
            return leaf
        owners[path] = name
        return strategy.whole_state(name, leaf) if name in sharded else leaf

    state["optimizer"] = _map_leaves(state["optimizer"], whole, "optimizer")
    # Tensor and expert parallelism shard the parameters themselves (and
    # their shadows): each is gathered whole along its axis.
    names = getattr(strategy, "sharded_names", dict)()
    for key in ("model", "ema"):
        if state.get(key) is not None and names:
            state[key] = {k: strategy.whole_state(k, v) if k in names else v
                          for k, v in state[key].items()}
    return state, owners


def local_state(trainer, state: dict, meta: Dict[str, Any]) -> dict:
    """The inverse of :func:`whole_state` for ``trainer``: a restored
    save's whole optimizer tensors (:data:`OWNERS` of its ``meta``) of
    each parameter the trainer's strategy shards, cut to this process's
    slice. Anything else is returned as it is."""
    owners = meta.get(OWNERS) or {}
    strategy = trainer.strategy
    if hasattr(strategy, "local_trainer_state"):
        return strategy.local_trainer_state(trainer, state, meta)
    if not hasattr(strategy, "local_state"):
        return state

    def local(path, leaf):
        name = owners.get(path)
        return leaf if name is None else strategy.local_state(name, leaf)

    out = dict(state)
    if owners:
        out["optimizer"] = _map_leaves(state["optimizer"], local,
                                       "optimizer")
    names = getattr(strategy, "sharded_names", dict)()
    for key in ("model", "ema"):
        if out.get(key) is not None and names:
            out[key] = {k: strategy.local_state(k, v) if k in names else v
                        for k, v in out[key].items()}
    return out


def _loader_position(trainer) -> Optional[Dict[str, int]]:
    """The trainer's loader position, checked equal on every process of
    its group: each consumes one batch of its own part a step."""
    loader = trainer.loader_state()
    group = trainer.strategy.group
    if loader is None or group is None or collectives.axis_size(group) < 2:
        return loader
    mine = torch.tensor([int(loader[k]) for k in _LOADER_KEYS],
                        device=trainer.device)
    every = collectives.all_gather(mine, group).cpu()
    if not bool((every == every[0]).all()):
        raise RuntimeError(f"the processes' loader positions differ: "
                           f"{every.tolist()} ({_LOADER_KEYS})")
    return loader


def _grace_save(ckpt: Checkpointer, trainer, logs=None,
                checksum: bool = True) -> int:
    """An idempotent step-granular save of the trainer's state with its
    loader position: a step the directory already holds (a SIGTERM on a
    save-cadence batch) is not written again."""
    if ckpt.latest_step() == trainer.step:
        return trainer.step
    loader = _loader_position(trainer)
    epoch = (loader["epoch"] - 1) if loader else None
    metrics = {k: float(v) for k, v in logs.items()} if logs else None
    return ckpt.save_trainer(trainer, epoch=epoch, metrics=metrics,
                             loader=loader, checksum=checksum)


class ModelCheckpoint(Callback):
    """Epoch-end checkpoints (Keras's ``ModelCheckpoint``); with
    ``save_best_only`` only when ``monitor`` improves."""

    def __init__(self, directory: str, monitor: str = "val_loss",
                 save_best_only: bool = False, mode: str = "min",
                 every_n_epochs: int = 1, max_to_keep: Optional[int] = 5,
                 async_save: bool = True):
        self.ckpt = Checkpointer(directory, max_to_keep=max_to_keep,
                                 async_save=async_save)
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.mode = mode
        self.every_n_epochs = every_n_epochs
        self.best = float("inf") if mode == "min" else -float("inf")

    def _improved(self, current: float) -> bool:
        return current < self.best if self.mode == "min" else current > self.best

    def save_now(self, logs=None) -> int:
        """The grace-save entry point (``PreemptionCheckpoint(delegate=)``)
        through this callback's directory; idempotent per step."""
        return _grace_save(self.ckpt, self.trainer, logs)

    def on_epoch_end(self, epoch, logs):
        if (epoch + 1) % self.every_n_epochs:
            return
        if self.save_best_only:
            current = logs.get(self.monitor)
            if current is None or not self._improved(current):
                return
            self.best = current
        self.ckpt.save_trainer(self.trainer, epoch=epoch, metrics=logs,
                               loader=_loader_position(self.trainer))

    def on_train_end(self, logs):
        self.ckpt.wait()


class BackupAndRestore(Callback):
    """Crash-resume by epoch: restore the newest verified save at train
    start and keep a rolling backup every epoch (at least two kept, for
    the torn-latest fallback). Pair with ``initial_epoch=latest_epoch(dir)
    + 1``, or use ``fit(resume=dir)``."""

    def __init__(self, directory: str, async_save: bool = True,
                 max_to_keep: int = 2):
        self.ckpt = Checkpointer(directory, max_to_keep=max(max_to_keep, 2),
                                 async_save=async_save)

    def on_train_begin(self):
        if self.ckpt.latest_step() is None:
            return
        state, meta = self.ckpt.restore()
        self.trainer.load_state_dict(local_state(self.trainer, state, meta))

    def on_epoch_end(self, epoch, logs):
        self.ckpt.save_trainer(self.trainer, epoch=epoch, metrics=logs,
                               loader=_loader_position(self.trainer))

    def on_train_end(self, logs):
        self.ckpt.wait()


class CheckpointEveryN(Callback):
    """Step-granular verified checkpoints — the CheckFreq cadence.

    Every ``every_n_steps`` steps the trainer's whole state is saved
    (async by default; synchronous, rank 0 writing, under a group of
    processes) with its checksums and the loader position, and at least
    the last two saves are kept. It powers both recovery paths: a new
    process's ``Trainer.fit(resume=directory)``, and the trainer's
    in-process restore-and-replay (``set_trainer`` attaches it; the
    trainer's replay buffer holds two intervals). The cadence is counted
    on the host from the trainer's step at train start.

    The loader position (``epoch``, ``step_in_epoch``,
    ``batches_consumed``) is what each rank's loader needs to resume
    mid-epoch bitwise: every rank consumes one batch of its own part of
    the stream a step (``process_index``/``process_count``, or the global
    batch under ``mirrored``), so the position is the same on every rank;
    the save checks that they agree and records it once, and each rank's
    resume skips that many batches of its own stream."""

    def __init__(self, directory: str, every_n_steps: int = 50,
                 max_to_keep: int = 3, async_save: bool = True,
                 checksum: bool = True):
        if every_n_steps < 1:
            raise ValueError(
                f"every_n_steps must be >= 1, got {every_n_steps}")
        if max_to_keep is not None and max_to_keep < 2:
            raise ValueError(
                "max_to_keep must be >= 2: torn-latest fallback needs a "
                "previous verified save to fall back to")
        self.directory = directory
        self.every_n_steps = int(every_n_steps)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.checksum = checksum
        self.ckpt: Optional[Checkpointer] = None
        self.saves = 0
        self.last_save_wall_s = 0.0
        self._step = 0

    def set_trainer(self, trainer) -> None:
        super().set_trainer(trainer)
        trainer.attach_recovery(self)

    def on_train_begin(self):
        if self.ckpt is None:
            self.ckpt = Checkpointer(self.directory,
                                     max_to_keep=self.max_to_keep,
                                     async_save=self.async_save)
        self._step = self.trainer.step

    def on_train_batch_end(self, step, logs):
        self._step += 1
        if self._step % self.every_n_steps == 0:
            self.save_now(logs=logs)

    def save_now(self, logs=None) -> int:
        """One verified save at the trainer's step (also the grace-window
        entry point); idempotent per step."""
        before = self.ckpt.latest_step()
        t0 = time.perf_counter()
        step = _grace_save(self.ckpt, self.trainer, logs,
                           checksum=self.checksum)
        if step == before:
            return step
        self.last_save_wall_s = time.perf_counter() - t0
        self.saves += 1
        self.trainer.on_checkpoint_saved(step, self.last_save_wall_s)
        return step

    def on_train_end(self, logs):
        if self.ckpt is not None:
            self.ckpt.wait()


def save_params_npz(path: str, model) -> None:
    """A flat ``{name: array}`` npz of a model's (or a ``state_dict``'s)
    tensors, on the coordinator only — the reference's final
    ``model.save`` moment. bf16 tensors are written as f32 (numpy has no
    bf16; the widening is exact)."""
    if not dist.is_coordinator():
        return
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    flat = {}
    for name, t in sd.items():
        t = t.detach().cpu()
        flat[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    # Through a file object: np.savez(path) appends ".npz" to a bare path.
    with open(path, "wb") as f:
        np.savez(f, **flat)
