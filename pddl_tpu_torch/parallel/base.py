"""Strategy protocol: what varies between the reference's distribution
modes (the port of :mod:`pddl_tpu.parallel.base`).

A Strategy owns the mesh of processes and the rules of a step; the
Trainer (:mod:`pddl_tpu_torch.train.loop`) asks it for its device, its
rows of each batch, the gradient average and the optimizer step. Every
mode keeps the JAX package's numbers: the global batch is the one the
JAX trainer sees, BatchNorm takes its statistics over it
(:func:`pddl_tpu_torch.models.resnet.bind_data_group`), and the gradient is
the global batch's mean, the all-reduced mean of each process's.

Batch contract (``distribute_batch``): a strategy whose data is fed by one
process (mirrored, single) hands every process the **global** batch and
each takes its rows; a multi-process strategy (multi-worker, ps) hands each
process its local part (``imagenet-resnet50-multiworkers.py:66-69``).

Sequence parallelism (a mesh with a ``seq`` axis above 1, e.g.
``MirroredStrategy(mesh_config=MeshConfig(data=2, seq=2))``, the JAX
tests' mirrored strategy over a ``data`` x ``seq`` mesh): each process
also takes its ``seq`` position's contiguous slice of every ``[B, S]``
field (the tokens and the already-shifted targets, so no target crosses a
shard's edge; images and labels stay whole: the ViT cuts its own patch
tokens). Each process's loss is the mean over its slice, so the global
mean is the mean over the batch's processes: the gradients and the logs
are averaged over ``data`` x ``seq`` (:attr:`Mesh.batch_group`), which
gives every process the one-process step's parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from pddl_tpu_torch.core import collectives, dist
from pddl_tpu_torch.core.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    Mesh,
    MeshConfig,
    build_mesh,
    mesh_num_replicas,
    validate_divisible,
)
from pddl_tpu_torch.models.resnet import bind_data_group
from pddl_tpu_torch.train.state import make_optimizer

Batch = Dict[str, Any]


class Strategy:
    """Base strategy: replicated state, data-sharded batches.

    Subclasses override device selection (``mesh_config``), the optimizer
    (``make_optimizer`` / ``optimizer_step``) and bootstrap (``setup``).
    ``device`` is this process's (``None``: ``cuda:{local_rank}``),
    ``backend`` the process group's (``None``: NCCL on ``cuda``, gloo on the
    ``cpu``; two processes sharing one card take gloo).
    """

    name = "base"

    def __init__(self, mesh_config: Optional[MeshConfig] = None, *,
                 device=None, backend: Optional[str] = None):
        self._mesh_config = mesh_config or MeshConfig()
        self._device = device
        self._backend = backend
        self._mesh: Optional[Mesh] = None

    # -- bootstrap ---------------------------------------------------------
    def _initialize(self, *bootstrap) -> dist.ClusterSpec:
        return dist.initialize(*bootstrap, device=self._device,
                               backend=self._backend)

    def setup(self) -> Mesh:
        """Build (once) and return the mesh (the ``strategy.scope()``
        moment): join the processes named by the environment, if any."""
        if self._mesh is None:
            self._initialize()
            self._mesh = build_mesh(self._mesh_config, device=self._device)
        return self._mesh

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            self.setup()
        return self._mesh

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def group(self):
        """The data axis's process group (``None`` for one process that
        opened none)."""
        return self.mesh.group

    # -- replica arithmetic ------------------------------------------------
    @property
    def num_replicas_in_sync(self) -> int:
        """TF's ``strategy.num_replicas_in_sync``
        (``imagenet-resnet50-mirror.py:54``)."""
        return mesh_num_replicas(self.mesh, DATA_AXIS)

    def scale_batch_size(self, per_replica_batch: int) -> int:
        """Global batch = per-replica x replicas — the reference's
        ``32 * strategy.num_replicas_in_sync`` arithmetic
        (``imagenet-resnet50-mirror.py:54``,
        ``imagenet-resnet50-multiworkers.py:70``)."""
        return per_replica_batch * self.num_replicas_in_sync

    def scale_learning_rate(self, base_lr: float) -> float:
        """Linear LR scaling rule: ``base_lr * replicas`` (Horovod's
        ``0.1 * size``, ``imagenet-resnet50-hvd.py:99``).

        Never applied automatically — the Trainer uses the LR it is given.
        Calling this is the opt-in: the hvd compat shim and the hvd config
        preset do; presets mirroring the other reference scripts must not
        (those scripts never scale LR)."""
        return base_lr * self.num_replicas_in_sync

    # -- data distribution -------------------------------------------------
    @property
    def data_process_count(self) -> int:
        """Processes contributing parts of the global batch: every process
        of the mesh here, 1 for a strategy whose one feeder is every
        process (mirrored, single)."""
        return self.mesh.size

    def distribute_batch(self, batch: Batch) -> Batch:
        """This process's rows of a batch (the auto-shard DATA policy
        analogue, ``imagenet-resnet50-multiworkers.py:66-69``): a global
        batch (one feeder) is cut into the mesh's equal parts, a local one
        (every process a feeder) is this process's part as it is. The
        global batch must divide over the replicas."""
        n_procs = self.data_process_count
        leaves = list(batch.values())
        if not leaves:
            return batch
        local = int(np.shape(leaves[0])[0])
        validate_divisible(local * n_procs, self.mesh)
        if n_procs != self.mesh.size:
            rows = local // self.mesh.size
            lo = self.mesh.index * rows
            batch = {k: v[lo:lo + rows] for k, v in batch.items()}
        return self._seq_slice(batch)

    def _seq_slice(self, batch: Batch) -> Batch:
        """This process's ``seq`` slice of every ``[B, S]`` field (module
        docstring); the batch as it is on a mesh without sequence
        parallelism."""
        n = self.mesh.shape[SEQ_AXIS]
        if n == 1:
            return batch
        my = self.mesh.axis_index(SEQ_AXIS)
        out = {}
        for k, v in batch.items():
            if np.ndim(v) != 2:
                out[k] = v
                continue
            s = int(np.shape(v)[1])
            if s % n:
                raise ValueError(f"sequence {s} of {k!r} not divisible by "
                                 f"the seq axis size {n}")
            out[k] = v[:, my * (s // n):(my + 1) * (s // n)]
        return out

    def distribute_dataset(self, it: Iterator[Batch]) -> Iterator[Batch]:
        for batch in it:
            yield self.distribute_batch(batch)

    # -- the step ----------------------------------------------------------
    def bind(self, model: torch.nn.Module) -> None:
        """Prepare ``model`` for the step: BatchNorm over the global batch."""
        bind_data_group(model, self.group)

    def make_optimizer(self, model: torch.nn.Module, optimizer,
                       learning_rate: float, **options):
        """:func:`pddl_tpu_torch.train.state.make_optimizer` over the
        model; ``options`` are its keywords (schedule, clipping,
        accumulation, ``param_update``, ``update_seed``)."""
        return make_optimizer(model, optimizer, learning_rate, **options)

    @property
    def batch_group(self):
        """The processes of one batch: ``data`` x ``seq`` (the data axis's
        group without sequence parallelism)."""
        return self.mesh.batch_group

    def reduce_gradients(self, model: torch.nn.Module) -> None:
        """Average every gradient over the batch's processes (the NCCL
        all-reduce of ``MirroredStrategy``; ``data`` x ``seq`` under
        sequence parallelism), in place."""
        if self.batch_group is None:
            return
        collectives.flat_all_reduce_(
            [p.grad for p in model.parameters() if p.grad is not None],
            self.batch_group, mean=True)

    def optimizer_step(self, optimizer: torch.optim.Optimizer) -> None:
        optimizer.step()

    def grad_norm(self, model: torch.nn.Module) -> torch.Tensor:
        """The global L2 norm of the model's gradients (``log_grad_norm``)."""
        return torch.nn.utils.get_total_norm(
            [p.grad for p in model.parameters() if p.grad is not None])

    @property
    def save_group(self):
        """The processes of one save (``ckpt/checkpoint.py``): the batch's
        (the data axis's group without sequence parallelism)."""
        return self.batch_group

    # -- process topology --------------------------------------------------
    @property
    def process_index(self) -> int:
        return dist.process_index()

    @property
    def is_coordinator(self) -> bool:
        """Who logs and saves (rank-0 gating,
        ``imagenet-resnet50-hvd.py:28,96,117,125``)."""
        return dist.is_coordinator()

    def __repr__(self) -> str:
        return f"{type(self).__name__}(replicas={self.num_replicas_in_sync})"


_STRATEGIES: dict[str, type] = {}


def register_strategy(name: str):
    def deco(cls):
        _STRATEGIES[name] = cls
        cls.name = name
        return cls

    return deco


def get_strategy(name: str, **kwargs) -> Strategy:
    """Strategy by config string (``single``/``mirrored``/``multiworker``/
    ``ps``/``tensor_parallel``/``expert_parallel``/``pipeline``)."""
    if name == "pipeline":
        import pddl_tpu_torch.parallel.pipeline  # noqa: F401,PLC0415
    try:
        cls = _STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; known: {sorted(_STRATEGIES)}") from None
    return cls(**kwargs)
