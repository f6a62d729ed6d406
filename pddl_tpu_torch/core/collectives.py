"""Collectives over a process group (the port of
:mod:`pddl_tpu.core.collectives`).

Every cross-device primitive the reference gets from NCCL or Horovod maps
to a ``torch.distributed`` collective over the data axis's process group:
NCCL on the card, gloo on the CPU. The JAX functions name a mesh axis
inside ``shard_map``; these take the group (a ``ProcessGroup``; ``None``
means the default group, and with no group initialized, a world of one
process, where every function is the identity of its single member; a
group of one runs each collective all the same). Each
takes a tensor, or a dict, list or tuple of tensors, and returns new
tensors: the inputs are left as they were.

gloo runs only ``all_reduce`` and ``broadcast`` on CUDA tensors
(``torch.distributed``'s backend table). On gloo every other collective
of a CUDA tensor is staged through host memory, a choice made by backend
and device below; NCCL and gloo on the CPU run each natively.

``pcast_varying`` exists only for JAX's varying-manual-axes checker, which
has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as tdist

Tree = Any

# What gloo runs on CUDA tensors; the rest is staged through host memory.
_GLOO_CUDA = frozenset({"all_reduce", "broadcast"})


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Tree) -> Tree:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"collectives take tensors or dicts/lists of them, "
                    f"got {type(tree).__name__}")


def _staged(op: str, x: torch.Tensor, group=None) -> bool:
    """True when ``op`` of ``x`` goes through host memory: a CUDA tensor
    on gloo, for the collectives gloo runs only on the CPU."""
    return (x.is_cuda and op not in _GLOO_CUDA
            and tdist.get_backend(group) == "gloo")


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    out = x.clone()
    if tdist.is_initialized():
        tdist.all_reduce(out, op=op, group=group)
    return out


def psum(tree: Tree, group=None) -> Tree:
    """All-reduce-sum over the group (NCCL allreduce)."""
    return _map(lambda x: _all_reduce(x, tdist.ReduceOp.SUM, group), tree)


def pmean(tree: Tree, group=None) -> Tree:
    """All-reduce-mean — gradient averaging (``hvd.DistributedOptimizer``,
    ``imagenet-resnet50-hvd.py:101``) and metric averaging
    (``MetricAverageCallback``, ``:112-113``): the sum over the group
    divided by its size."""
    n = axis_size(group)
    return _map(lambda x: _all_reduce(x, tdist.ReduceOp.SUM, group) / n,
                tree)


def pmax(tree: Tree, group=None) -> Tree:
    return _map(lambda x: _all_reduce(x, tdist.ReduceOp.MAX, group), tree)


def pmin(tree: Tree, group=None) -> Tree:
    return _map(lambda x: _all_reduce(x, tdist.ReduceOp.MIN, group), tree)


def broadcast(tree: Tree, group=None, root: int = 0) -> Tree:
    """Broadcast member ``root``'s values to every member of the group.

    The ``hvd.callbacks.BroadcastGlobalVariablesCallback(0)`` analogue
    (``imagenet-resnet50-hvd.py:111``): forces bitwise-identical weights
    across replicas.
    """

    def _bcast(x):
        out = x.clone()
        if tdist.is_initialized():
            src = tdist.get_global_rank(group, root) if group else root
            tdist.broadcast(out, src=src, group=group)
        return out

    return _map(_bcast, tree)


def _gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every member's ``x`` (equal shapes), in member order."""
    n = axis_size(group)
    if n == 1:
        return [x]
    if _staged("all_gather", x, group):
        return [p.to(x.device) for p in _gather_list(x.cpu(), group)]
    flat = x.reshape(-1).contiguous()
    if tdist.get_backend(group) == "nccl":
        out = flat.new_empty(n * flat.numel())
        tdist.all_gather_into_tensor(out, flat, group=group)
        return list(out.view(n, *x.shape).unbind(0))
    parts = [torch.empty_like(flat) for _ in range(n)]
    tdist.all_gather(parts, flat, group=group)
    return [p.view(x.shape) for p in parts]


def all_gather(tree: Tree, group=None, *, axis: int = 0,
               tiled: bool = False) -> Tree:
    """Gather per-member values along a new axis (``tiled``: concatenated
    along ``axis``), in member order."""

    def _one(x):
        parts = _gather_list(x, group)
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    return _map(_one, tree)


def reduce_scatter(tree: Tree, group=None, *, scatter_axis: int = 0) -> Tree:
    """Sum over the group, each member keeping its block of
    ``scatter_axis`` (ZeRO-style gradient sharding). On gloo the sum is
    an all-reduce and each member slices its block."""
    n, i = axis_size(group), axis_index(group)

    def _one(x):
        if x.shape[scatter_axis] % n:
            raise ValueError(f"dimension {scatter_axis} of {tuple(x.shape)} "
                             f"does not split {n} ways")
        block = x.shape[scatter_axis] // n
        if n > 1 and tdist.get_backend(group) == "nccl":
            xs = x.movedim(scatter_axis, 0).contiguous()
            out = xs.new_empty((block,) + xs.shape[1:])
            tdist.reduce_scatter_tensor(out, xs, group=group)
            return out.movedim(0, scatter_axis)
        total = _all_reduce(x, tdist.ReduceOp.SUM, group)
        return total.narrow(scatter_axis, i * block, block).clone()

    return _map(_one, tree)


def ppermute_ring(x: torch.Tensor, group=None, *,
                  shift: int = 1) -> torch.Tensor:
    """Rotate values around the ring: member i sends to (i+shift) % n and
    receives from (i-shift) % n."""
    n, i = axis_size(group), axis_index(group)
    if shift % n == 0:
        return x.clone()
    if _staged("send", x, group):
        return ppermute_ring(x.cpu(), group, shift=shift).to(x.device)
    x = x.contiguous()
    out = torch.empty_like(x)

    def rank(member):
        return tdist.get_global_rank(group, member) if group else member

    ops = [tdist.P2POp(tdist.isend, x, rank((i + shift) % n), group),
           tdist.P2POp(tdist.irecv, out, rank((i - shift) % n), group)]
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    return out


def axis_index(group=None) -> int:
    """This member's position in the group (``hvd.rank()`` analogue)."""
    return tdist.get_rank(group) if tdist.is_initialized() else 0


def axis_size(group=None) -> int:
    """Members of the group (``hvd.size()`` analogue)."""
    return tdist.get_world_size(group) if tdist.is_initialized() else 1


def flat_all_reduce_(tensors: List[torch.Tensor], group=None,
                     mean: bool = False) -> None:
    """Sum ``tensors`` over the group in place (``mean``: then divide by
    its size, as :func:`pmean`) through one flat buffer per dtype: one
    collective instead of one per tensor."""
    if not tdist.is_initialized():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        tdist.all_reduce(flat, group=group)
        if mean:
            flat.div_(axis_size(group))
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
