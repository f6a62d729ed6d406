"""Training on one card or under a strategy: ``Trainer``, the optimizer
and schedule factories, ``History``, the callbacks and metrics, and the
trainer's fault plan (the port of :mod:`pddl_tpu.train`).

The names resolve lazily. The flax ``TrainState`` has no twin: the
port's trainer state is ``Trainer.state_dict()``."""

from pddl_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "Trainer": "loop",
    "History": "history",
    "callbacks": "callbacks",
    "metrics": "metrics",
    "FaultKind": "faults",
    "FaultSpec": "faults",
    "TrainFaultPlan": "faults",
    "TrainStateLost": "faults",
    "make_optimizer": "state",
    "make_schedule": "state",
    "get_learning_rate": "state",
    "set_learning_rate": "state",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
