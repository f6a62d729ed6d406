"""Deterministic fault injection for the training loop (the port of
:mod:`pddl_tpu.train.faults`).

The machinery is :mod:`pddl_tpu_torch.utils.faults`; this module pins
the trainer's site vocabulary, the two guarded calls of
:class:`pddl_tpu_torch.train.loop.Trainer`:

- ``train_step``: a TRANSIENT fault is retried in place with bounded
  doubling backoff; spent retries, any OOM, or a real error from the
  step (which updates the model and the optimizer as it runs) restore
  the newest verified save of a ``CheckpointEveryN`` in-process and
  replay the buffered batches forward to the failed step. The replay is
  bitwise: the step is a function of the restored state and the batch,
  and the augment's generator is seeded from the step counter.
- ``eval_step``: read-only; a TRANSIENT fault is retried in place, and
  past the budget its error is raised.

KILL unwinds through ``fit`` as a SIGKILL would end the process; the
recovery for it is a new process and ``Trainer.fit(resume=...)``.
"""

from __future__ import annotations

from pddl_tpu_torch.utils.faults import (  # noqa: F401 - the train surface
    FaultKind,
    FaultSpec,
    InjectedResourceExhausted,
    InjectedTransientError,
    KillPoint,
    classify,
)
from pddl_tpu_torch.utils.faults import FaultPlan as _BaseFaultPlan


class TrainFaultPlan(_BaseFaultPlan):
    """Seeded fault schedule over the trainer's sites. The step
    coordinate is the trainer's step counter (``Trainer.step``, micro-steps
    under accumulation), so a scheduled fault stays pinned to the same
    step across resumes."""

    SITES = ("train_step", "eval_step")


class TrainStateLost(RuntimeError):
    """The guarded boundary's escalation: the step could not complete
    within the retry budget, or failed in a way that may have left the
    state half-updated. The trainer's state must be restored from the
    newest verified save. Carries the site and the original error."""

    def __init__(self, site: str, err: BaseException):
        self.site = site
        self.err = err
        super().__init__(f"training state lost at site {site!r}: {err}")
