"""Preemption handling: checkpoint on SIGTERM (the port of
:mod:`pddl_tpu.utils.preemption`).

A preempted machine gets a SIGTERM and a grace window. The handler only
sets a flag (async-signal-safe); the save happens at the next batch
boundary on the training thread, so it is a consistent state, not a
mid-step capture. The save is step-granular (the trainer's loader
position rides in its metadata) and checksummed, so the restarted job
continues the interrupted step with ``Trainer.fit(resume=...)``, and a
save torn by the eviction is skipped on restore
(:mod:`pddl_tpu_torch.ckpt.checkpoint`)::

    trainer.fit(..., callbacks=[PreemptionCheckpoint("build/run1")])
"""

from __future__ import annotations

import logging
import signal
from typing import Optional

from pddl_tpu_torch.train.callbacks import Callback

log = logging.getLogger(__name__)


class PreemptionCheckpoint(Callback):
    """Save a checkpoint and stop training cleanly when preempted.

    Args:
      directory: the checkpoint directory (the one ``fit(resume=...)``
        reads). Exclusive with ``delegate``.
      signals: the signals that mean "about to be killed" (SIGTERM).
      restore_previous_handlers: put the old handlers back at train end
        (``on_train_end`` runs even when ``fit`` raises).
      delegate: an installed ``CheckpointEveryN`` or ``ModelCheckpoint``
        (``save_now()`` and ``.ckpt``) to save through, so one writer
        owns the directory.
    """

    def __init__(self, directory: Optional[str] = None,
                 signals=(signal.SIGTERM,),
                 restore_previous_handlers: bool = True, delegate=None):
        if (directory is None) == (delegate is None):
            raise ValueError(
                "pass exactly one of directory (own manager) or "
                "delegate (a CheckpointEveryN to save through)")
        self.directory = directory
        self.delegate = delegate
        self.signals = tuple(signals)
        self.restore_previous_handlers = restore_previous_handlers
        self.preempted = False
        self._previous: dict = {}
        self._ckpt = None

    def _on_signal(self, signum, frame):  # async-signal-safe: flag only
        self.preempted = True

    def on_train_begin(self):
        # A reused instance must not inherit the previous run's flag.
        self.preempted = False
        if self.delegate is None:
            from pddl_tpu_torch.ckpt.checkpoint import Checkpointer

            # Synchronous: a grace window may have no "later" for an
            # async write to finish in.
            self._ckpt = Checkpointer(self.directory, max_to_keep=2,
                                      async_save=False)
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._on_signal)

    def on_train_batch_end(self, step, logs):
        if not self.preempted or self.trainer.stop_training:
            return
        log.warning("preemption signal received: checkpointing to %s and "
                    "stopping",
                    self.directory if self.delegate is None
                    else self.delegate.ckpt.directory)
        if self.delegate is not None:
            self.delegate.save_now()
            self.delegate.ckpt.wait()
        else:
            from pddl_tpu_torch.ckpt.checkpoint import _grace_save

            _grace_save(self._ckpt, self.trainer)
        self.trainer.stop_training = True

    def on_train_end(self, logs):
        if self.restore_previous_handlers:
            for sig, old in self._previous.items():
                signal.signal(sig, old)
            self._previous = {}
        if self._ckpt is not None:
            self._ckpt.close()
            self._ckpt = None
