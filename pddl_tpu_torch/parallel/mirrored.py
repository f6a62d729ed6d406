"""Mirrored strategy: single-host sync data parallelism (the port of
:mod:`pddl_tpu.parallel.mirrored`).

Parity with ``tf.distribute.MirroredStrategy``
(``imagenet-resnet50-mirror.py:21``): variables replicated on every local
device, per-step gradient all-reduce, global batch scaled by replica count
(``:54``). In the port each local device is one process (torchrun's
``--nproc-per-node``, or ``PDDL_*`` per process): the mesh is this host's
processes, the all-reduce NCCL's (gloo's on the CPU). One feeder: every
process reads the global batch and trains on its rows of it, as the
JAX strategy's single process feeds every local device.

``mesh_config`` replaces the mesh of this host's processes, as the JAX
tests set a mirrored strategy's ``_mesh``: ``MeshConfig(data=2, seq=2)``
trains sequence-parallel over the job's processes (``parallel/base.py``).
"""

from __future__ import annotations

from typing import Optional

from pddl_tpu_torch.core.mesh import MeshConfig
from pddl_tpu_torch.parallel.base import Strategy, register_strategy


@register_strategy("mirrored")
class MirroredStrategy(Strategy):
    """Data parallelism over this host's processes."""

    def __init__(self, device=None, backend: Optional[str] = None, *,
                 mesh_config: Optional[MeshConfig] = None):
        super().__init__(mesh_config or MeshConfig(local_only=True),
                         device=device, backend=backend)

    @property
    def data_process_count(self) -> int:
        return 1
