"""The parameter-server partitioner (the port of
:mod:`pddl_tpu.core.sharding`).

The reference's parameter-server mode shards variables across PS hosts with
``tf.distribute.experimental.partitioners.MinSizePartitioner(min_shard_bytes=
256 << 10, max_shards=NUM_PS)`` (``imagenet-resnet50-ps.py:75-78``). The
JAX package maps that to sharded state under SPMD; the port keeps each
tensor whole for the forward and shards what a step keeps beside it, the
optimizer state (:mod:`pddl_tpu_torch.parallel.ps`). :class:`MinSizePartitioner`
decides, per tensor, the same shard count and split as the JAX one:
:meth:`MinSizePartitioner.sharding` returns a :class:`Placement` in place
of a ``NamedSharding``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from pddl_tpu_torch.core.mesh import Mesh


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor's sharded state lives on an ``n``-process data axis.

    ``count`` shards split dimension ``dim``; each shard is replicated over
    ``n // count`` consecutive processes (the JAX package's factored
    ``k``-way × ``N/k`` layout, ``_factored_mesh``), so the process at
    position ``i`` holds shard ``i // (n // count)``. ``count`` 1 (``dim``
    None) is replication.
    """

    count: int
    dim: Optional[int]
    n: int

    @property
    def replicas(self) -> int:
        return self.n // self.count

    def block(self, extent: int, position: int) -> tuple:
        """``(start, length)`` of the shard the process at ``position``
        holds along ``dim``, whose extent is ``extent``."""
        length = extent // self.count
        return position // self.replicas * length, length


@dataclasses.dataclass(frozen=True)
class MinSizePartitioner:
    """Shard tensors along one dimension of a mesh axis, min-size gated.

    Capability analogue of TF's ``MinSizePartitioner``
    (``imagenet-resnet50-ps.py:75-78``): a variable is split
    along its largest dimension only if every resulting shard stays at least
    ``min_shard_bytes`` and the split does not exceed ``max_shards``;
    otherwise it stays whole (replicated).

    Mapping note: TF returns a free shard *count* (1..max_shards) consumed
    by the PS runtime; XLA requires uniform tiling. The mapping: the TF
    count is rounded DOWN to the largest divisor of the axis size that also
    divides one of the tensor's dimensions. A full-axis count shards over
    the named mesh axis; an intermediate count (2..N-1) shards over a
    factored sub-axis view of the same devices
    (``k``-way split, each shard replicated over ``N/k`` neighbours — see
    :class:`Placement`); a count of 1 replicates. ``num_shards``
    reports the raw TF-equivalent count for parity checks.
    """

    min_shard_bytes: int = 256 << 10  # 256 KiB, the reference's value (:77)
    max_shards: Optional[int] = None  # defaults to the mesh axis size
    axis_name: str = "data"

    def num_shards(self, shape: tuple[int, ...], dtype, axis_size: int) -> int:
        """How many shards the reference partitioner would produce."""
        if not shape:
            return 1
        nbytes = math.prod(shape) * _itemsize(dtype)
        limit = self.max_shards if self.max_shards is not None else axis_size
        limit = min(limit, axis_size)
        # At least min_shard_bytes per shard, at most `limit` shards.
        by_size = max(1, nbytes // self.min_shard_bytes)
        return int(min(by_size, limit, max(shape)))

    def feasible_shards(
        self, shape: tuple[int, ...], dtype, axis_size: int
    ) -> tuple[int, Optional[int]]:
        """``(count, dim)`` achievable under XLA's even tiling.

        The largest divisor of ``axis_size`` that is ≤ the TF shard count
        and evenly divides some tensor dimension (largest dimension
        preferred), with the dimension it splits. ``(1, None)`` when no
        such split exists.
        """
        n_tf = self.num_shards(shape, dtype, axis_size)
        if n_tf <= 1:
            return 1, None
        dims_by_size = sorted(range(len(shape)), key=lambda d: -shape[d])
        for n in range(axis_size, 1, -1):
            if axis_size % n or n > n_tf:
                continue
            for d in dims_by_size:
                if shape[d] % n == 0:
                    return n, d
        return 1, None

    def sharding(self, mesh: Mesh, shape: tuple[int, ...], dtype) -> Placement:
        """The tensor's placement on ``mesh``: the full axis, the factored
        ``k``-way × ``N/k`` middle ground (the reference's 2..N-way,
        ``imagenet-resnet50-ps.py:78``), or replication. The port's meshes
        have no live axis but ``data``, so the middle ground always
        applies where the JAX one needs every other axis at size 1."""
        axis_size = mesh.shape[self.axis_name]
        n, d = self.feasible_shards(tuple(shape), dtype, axis_size)
        return Placement(n, d, axis_size)
