"""Horovod API shim: ``import pddl_tpu_torch.compat.hvd as hvd`` (the port
of :mod:`pddl_tpu.compat.hvd`).

Covers, symbol for symbol, the Horovod surface the reference's script uses
(``imagenet-resnet50-hvd.py``), in Horovod's own layout of one process per
device (``:16,36-41``), on ``torch.distributed``:

================================  ============================================
reference call                    shim behavior
================================  ============================================
``hvd.init()`` (``:16``)          :func:`pddl_tpu_torch.core.dist.initialize`
                                  + the mesh of every process
``hvd.size()`` (``:99``)          processes in the job = replicas
``hvd.rank()`` (``:28,96,117``)   this process's global rank
``hvd.local_rank()`` (``:41``)    its rank on this host: the card it drives,
                                  ``cuda:{local_rank}``
``hvd.DistributedOptimizer``      an optimizer the Trainer accepts; with
(``:101``)                        ``axis_name`` it averages the gradients
                                  over the processes before each step
``BroadcastGlobalVariables-``     rank-``root``'s parameters and BatchNorm
``Callback(0)`` (``:111``)        buffers to every process
``MetricAverageCallback``         cross-process metric mean (``:112-113``)
``LearningRateWarmupCallback``    linear warmup (``:114-115``)
================================  ============================================

The one semantic difference from :mod:`pddl_tpu.compat.hvd`: there, one
process drives every local device, so ``local_rank()`` is always 0 and
``size()`` counts devices; here each process is one replica, as in Horovod,
so ``local_rank()`` is the process's index on its host and ``size()``
counts processes. The observable arithmetic (LR scaling ``0.1 * size()``,
a global batch of ``32 * size()``) is the same at the same replica count.
Data sharding is per process: ``num_data_shards()`` is ``size()`` and
``data_shard_index()`` is ``rank()`` (``.shard(hvd.size(), hvd.rank())``,
``:77-81``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pddl_tpu_torch.core import collectives, dist
from pddl_tpu_torch.core.mesh import DATA_AXIS, Mesh, build_mesh
from pddl_tpu_torch.train.callbacks import Callback, LearningRateWarmup
from pddl_tpu_torch.train.state import make_optimizer

_mesh: Optional[Mesh] = None


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, *, device=None,
         backend: Optional[str] = None) -> None:
    """``hvd.init()``: rendezvous (``PDDL_*``, Slurm or torchrun) + the
    mesh of every process. ``device`` is this process's
    (``cuda:{local_rank}`` by default), ``backend`` the group's."""
    global _mesh
    dist.initialize(coordinator_address, num_processes, process_id,
                    device=device, backend=backend)
    _mesh = build_mesh(device=device)


def _require_init() -> Mesh:
    if _mesh is None:
        raise RuntimeError("call hvd.init() first (imagenet-resnet50-hvd.py:16)")
    return _mesh


def is_initialized() -> bool:
    return _mesh is not None


def mesh() -> Mesh:
    return _require_init()


def size() -> int:
    """World size = data-parallel replica count (LR/batch arithmetic parity)."""
    return _require_init().size


def rank() -> int:
    """This process's global rank; 0 ⇔ coordinator."""
    _require_init()
    return dist.process_index()


def local_rank() -> int:
    """This process's index on its host, the card it drives
    (``imagenet-resnet50-hvd.py:36-41``)."""
    _require_init()
    return dist.local_rank()


def local_size() -> int:
    _require_init()
    return dist.local_size()


def num_data_shards() -> int:
    """Shard count for input pipelines: one per process."""
    return size()


def data_shard_index() -> int:
    return rank()


# ------------------------------------------------------------------ comms
def _host(value) -> torch.Tensor:
    """A host value as a tensor on the device the group's backend takes."""
    device = _require_init().device
    return torch.as_tensor(np.asarray(value), device=device)


def _map(fn, value):
    if isinstance(value, dict):
        return {k: _map(fn, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_map(fn, v) for v in value)
    return fn(value)


def allreduce(value, average: bool = True):
    """Cross-process all-reduce of a host value (numpy/scalar/pytree).

    A host-side utility — the gradient path never calls this (the
    Trainer's strategy averages gradients); it exists for host-side sums
    like sample counts or custom metrics.
    """
    m = _require_init()
    if m.size == 1:
        return value

    def _one(x):
        summed = collectives.psum(_host(x), m.group).cpu().numpy()
        return summed / m.size if average else summed

    return _map(_one, value)


def allgather(value):
    """Concatenate each process's value along axis 0 (``hvd.allgather``).

    Host-side utility like :func:`allreduce`; per-process arrays must
    share their trailing dimensions. Scalars gather to a ``[size]``
    vector.
    """
    m = _require_init()
    if m.size == 1:
        return _map(
            lambda x: np.asarray(x)[None] if np.ndim(x) == 0 else np.asarray(x),
            value,
        )

    def _one(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return collectives.all_gather(_host(x), m.group).cpu().numpy()
        # hvd.allgather concatenates RAGGED per-process arrays along axis
        # 0 (its primary use: variable-length per-rank results). The
        # underlying gather needs uniform shapes, so: exchange lengths,
        # pad to the max, gather, then slice each block back.
        lengths = collectives.all_gather(_host(len(x)), m.group).cpu().numpy()
        max_len = int(lengths.max())
        padded = np.zeros((max_len,) + x.shape[1:], x.dtype)
        padded[: len(x)] = x
        gathered = collectives.all_gather(_host(padded), m.group).cpu().numpy()
        return np.concatenate(
            [gathered[p, : int(lengths[p])] for p in range(len(lengths))]
        )

    return _map(_one, value)


def _check_root(root_rank: int) -> None:
    if not 0 <= root_rank < dist.process_count():
        raise ValueError(
            f"root_rank={root_rank} out of range for "
            f"{dist.process_count()} processes"
        )


def broadcast(value, root_rank: int = 0):
    """Broadcast process ``root_rank``'s value to every process.

    The reference only ever broadcasts from 0
    (``imagenet-resnet50-hvd.py:111``); any root is supported anyway.
    """
    m = _require_init()
    _check_root(root_rank)
    if m.size == 1:
        return value
    return _map(lambda x: collectives.broadcast(_host(x), m.group,
                                                root_rank).cpu().numpy(),
                value)


def DistributedOptimizer(optimizer: str = "adam",
                         learning_rate: Optional[float] = None,
                         axis_name: Optional[str] = None, **kwargs):
    """``hvd.DistributedOptimizer`` (``:101``): an optimizer whose updates
    are computed from *globally averaged* gradients, as a prebuilt
    optimizer ``params -> torch.optim.Optimizer`` that
    ``Trainer(optimizer=...)`` and ``make_optimizer`` accept.

    - Default (Trainer regime): the Trainer's strategy already averages
      the gradients over the data axis; the optimizer is built as it is
      (plus LR wiring).
    - ``axis_name="data"`` (explicit regime, a loop of one's own): the
      built optimizer averages every gradient over the processes before
      each step, the literal ring-allreduce moment.
    """
    if axis_name not in (None, DATA_AXIS):
        raise ValueError(f"axis_name={axis_name!r}: the shim's one axis is "
                         f"{DATA_AXIS!r}")
    lr = learning_rate if learning_rate is not None else 1e-3

    def build(params) -> torch.optim.Optimizer:
        opt = make_optimizer(params, optimizer, lr, **kwargs)
        if axis_name is not None:
            group = _require_init().group

            def _average(opt, args, kw):
                collectives.flat_all_reduce_(
                    [p.grad for g in opt.param_groups for p in g["params"]
                     if p.grad is not None], group, mean=True)

            opt.register_step_pre_hook(_average)
        return opt

    return build


# -------------------------------------------------------------- callbacks
class BroadcastGlobalVariablesCallback(Callback):
    """``hvd.callbacks.BroadcastGlobalVariablesCallback(0)`` (``:108-111``).

    Forces bitwise-identical start weights: at train start every process
    takes process ``root_rank``'s parameters and BatchNorm buffers (the
    model's whole ``state_dict``), over the shim's processes (the
    Trainer's data group before ``hvd.init()``). Models
    built from one seed start equal, so it matters after a per-process
    restore — the "consistent initialization ... when training is
    restored" case the Horovod docs (quoted by the reference) describe.
    """

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self):
        # Validate even single-process: a typo'd root should fail the dev
        # run, not explode later on the cluster.
        _check_root(self.root_rank)
        group = (_mesh.group if _mesh is not None
                 else getattr(self.trainer.strategy, "group", None))
        if group is None:
            return
        with torch.no_grad():
            for t in self.trainer.model.state_dict().values():
                t.copy_(collectives.broadcast(t, group, self.root_rank))


class MetricAverageCallback(Callback):
    """``hvd.callbacks.MetricAverageCallback`` (``:112-113``).

    The reference needs it because each rank evaluates a different
    validation shard. The Trainer already all-reduces each epoch's logs
    over its data group, so they are world-averages; per-process extras
    (if any) are averaged here.
    """

    def on_epoch_end(self, epoch, logs: Dict[str, float]):
        if dist.process_count() == 1:
            return
        averaged = allreduce({k: np.float64(v) for k, v in logs.items()})
        logs.update({k: float(v) for k, v in averaged.items()})


# Same class, Horovod's name (``:114-115``).
LearningRateWarmupCallback = LearningRateWarmup


class callbacks:  # namespace mirror of horovod.tensorflow.keras.callbacks
    BroadcastGlobalVariablesCallback = BroadcastGlobalVariablesCallback
    MetricAverageCallback = MetricAverageCallback
    LearningRateWarmupCallback = LearningRateWarmupCallback
