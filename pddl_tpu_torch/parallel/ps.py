"""Parameter-server strategy: sharded optimizer state (the port of
:mod:`pddl_tpu.parallel.ps`).

Capability parity with ``tf.distribute.ParameterServerStrategy`` +
``MinSizePartitioner`` + in-process gRPC cluster
(``imagenet-resnet50-ps.py:31-84``): model variables above a size threshold
live *sharded* across hosts/devices, scaling variable capacity with the
number of "servers".

The JAX package maps it to sharded state under sync SPMD; the port maps it
to ZeRO's first stage. The forward sees whole, replicated parameters. Each
parameter that :meth:`MinSizePartitioner.feasible_shards` splits ``k > 1``
ways keeps its optimizer state only as this process's ``1/k`` slice along
the split dimension, at the exact shard count the reference's partitioner
would pick (rounded to a divisor of the axis): the full axis for the big
tensors, or ``k`` shards each replicated over ``N/k`` consecutive processes
for the middle ground. After the gradient average each process updates its
slice, then all-gathers the updated slices into the whole parameter (the
"pull"). With ``shard_optimizer_state=False`` the state is replicated and
the step is mirrored's. Semantics are synchronous, which strictly
strengthens the reference's consistency model.

``lamb`` and ``lars`` read a whole parameter's norm for their trust ratio;
the sharded update sums the squared norms over the parameter's shards, so
it equals the replicated one.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import torch

from pddl_tpu_torch.core import collectives
from pddl_tpu_torch.core.mesh import DATA_AXIS, MeshConfig, build_mesh
from pddl_tpu_torch.core.sharding import MinSizePartitioner, Placement
from pddl_tpu_torch.parallel.base import Strategy, register_strategy

log = logging.getLogger(__name__)

# (whole parameter, this process's slice, placement, start along its dim)
_Shard = Tuple[torch.nn.Parameter, torch.Tensor, Placement, int]


def optimizer_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the tensors ``optimizer`` keeps beside the parameters."""
    return sum(t.numel() * t.element_size()
               for state in optimizer.state.values()
               for t in state.values() if isinstance(t, torch.Tensor))


@register_strategy("ps")
class ParameterServerStrategy(Strategy):
    """Sharded-state data parallelism (the PS capability, sync).

    Args:
      num_ps: cap on shards per variable, mirroring ``max_shards=NUM_PS``
        (``imagenet-resnet50-ps.py:78``). Defaults to the data-axis size.
      min_shard_bytes: sharding threshold, default 256 KiB like the
        reference (``:77``).
      shard_optimizer_state: shard Adam moments etc. (ZeRO-1 style);
        on by default — optimizer state is where the memory is.
    """

    def __init__(self, num_ps: Optional[int] = None,
                 min_shard_bytes: int = 256 << 10,
                 shard_optimizer_state: bool = True,
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None, device=None,
                 backend: Optional[str] = None):
        super().__init__(MeshConfig(), device=device, backend=backend)
        self.num_ps = num_ps
        self.min_shard_bytes = min_shard_bytes
        self.shard_optimizer_state = shard_optimizer_state
        self._bootstrap = (coordinator_address, num_processes, process_id)
        self._shards: List[_Shard] = []
        self._capped: List[torch.nn.Parameter] = []
        # The JAX warning's count, taken at the first step (once the
        # optimizer has made its state).
        self.capped_leaves: Optional[int] = None

    def setup(self):
        if self._mesh is None:
            self._initialize(*self._bootstrap)
            self._mesh = build_mesh(MeshConfig(), device=self._device)
        return self._mesh

    @property
    def partitioner(self) -> MinSizePartitioner:
        return MinSizePartitioner(
            min_shard_bytes=self.min_shard_bytes,
            max_shards=self.num_ps,
            axis_name=DATA_AXIS,
        )

    def placements(self, model: torch.nn.Module) -> Dict[str, Placement]:
        """Each parameter's placement, by name."""
        return {name: self.partitioner.sharding(self.mesh, tuple(p.shape),
                                                p.dtype)
                for name, p in model.named_parameters()}

    def make_optimizer(self, model, optimizer, learning_rate):
        """The optimizer over the whole parameters, each sharded one then
        swapped for this process's slice of it: the state the optimizer
        makes at its first step is the slice's."""
        opt = super().make_optimizer(model, optimizer, learning_rate)
        part, n = self.partitioner, self.num_replicas_in_sync
        swap = {}
        for name, pl in self.placements(model).items():
            p = model.get_parameter(name)
            if pl.count == 1:
                # TF's partitioner would split this leaf (count > 1) but
                # no divisor of the axis size divides any of its
                # dimensions, so it stays whole.
                if part.num_shards(tuple(p.shape), p.dtype, n) > 1:
                    self._capped.append(p)
                continue
            if not self.shard_optimizer_state:
                continue
            start, length = pl.block(p.shape[pl.dim], self.mesh.index)
            shard = p.detach().narrow(pl.dim, start, length).clone()
            swap[p] = shard
            self._shards.append((p, shard, pl, start))
        for group in opt.param_groups:
            group["params"] = [swap.get(q, q) for q in group["params"]]
        if hasattr(opt, "shard_sums"):  # lamb, lars: whole-leaf norms
            opt.shard_sums = {s: self._shard_sum(pl)
                              for _, s, pl, _ in self._shards}
        return opt

    def _shard_sum(self, pl: Placement):
        """Sum a per-shard value over a parameter's shards: the first
        process of each shard's replicas contributes it."""
        first = self.mesh.index % pl.replicas == 0

        def total(x: torch.Tensor) -> torch.Tensor:
            return collectives.psum(x if first else torch.zeros_like(x),
                                    self.group)

        return total

    @torch.no_grad()
    def optimizer_step(self, optimizer):
        for p, shard, pl, start in self._shards:
            shard.copy_(p.narrow(pl.dim, start, shard.shape[pl.dim]))
            shard.grad = (None if p.grad is None else
                          p.grad.narrow(pl.dim, start,
                                        shard.shape[pl.dim]).contiguous())
        optimizer.step()
        self._gather()
        if self.capped_leaves is None:
            self._count_capped(optimizer)

    def _gather(self) -> None:
        """Every parameter whole again from its updated slices: one
        all-gather per dtype, each shard taken from the first process of
        its replicas."""
        by_dtype: Dict[torch.dtype, List[_Shard]] = {}
        for entry in self._shards:
            by_dtype.setdefault(entry[1].dtype, []).append(entry)
        for entries in by_dtype.values():
            flat = torch.cat([s.reshape(-1) for _, s, _, _ in entries])
            parts = collectives.all_gather(flat, self.group)
            offset = 0
            for p, s, pl, _ in entries:
                pieces = [parts[i * pl.replicas, offset:offset + s.numel()]
                          .view(s.shape) for i in range(pl.count)]
                p.copy_(torch.cat(pieces, pl.dim))
                offset += s.numel()

    def _count_capped(self, optimizer) -> None:
        """The JAX strategy's count: each capped parameter, and with
        sharded optimizer state each of its parameter-shaped state
        tensors."""
        count = len(self._capped)
        if self.shard_optimizer_state:
            count += sum(
                1 for p in self._capped
                for t in optimizer.state.get(p, {}).values()
                if isinstance(t, torch.Tensor) and t.shape == p.shape)
        self.capped_leaves = count
        if count:
            log.warning(
                "%d variable(s) would shard under the reference's "
                "MinSizePartitioner but stay REPLICATED here: no even "
                "split is feasible — no divisor of the %d-device data "
                "axis that respects the num_ps cap divides any of their "
                "dimensions (or the mesh has other live axes). Raising "
                "num_ps or lowering min_shard_bytes may shard them.",
                count, self.num_replicas_in_sync,
            )
