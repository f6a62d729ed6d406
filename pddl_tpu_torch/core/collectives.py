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

Tensor and expert parallelism take Megatron's pair of differentiable
collectives, :func:`copy_to_group` (identity forward, all-reduce of the
gradient backward) and :func:`reduce_from_group` (all-reduce forward,
identity backward), and :func:`gather_from_group` (an all-gather along
one dimension forward, this member's slice of the gradient backward).
These three take ``None`` for a group of one (an axis of size 1), where
each is the identity, and count their calls and bytes in
:data:`TP_COUNTS` (forward and backward alike) so a step's collectives
can be read off.

Sequence and pipeline parallelism move tensors between neighbours:
:func:`ppermute_ring` is differentiable, as JAX's ``ppermute`` is (its
backward is the shift by ``-shift``), counted as ``ppermute_ring_fwd`` /
``ppermute_ring_bwd``; :func:`shift_counted` is the same shift under a
name of the caller's, for the ring-attention and pipeline
``autograd.Function`` s whose backward runs its own shifts in a fixed
order (send/recv pairs match by order on each rank; a chain of
differentiable shifts is scheduled by the autograd engine).
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


def _ring_exchange(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Member i's ``x`` to member (i+shift) % n, uncounted and outside
    autograd."""
    n, i = axis_size(group), axis_index(group)
    if shift % n == 0:
        return x.clone()
    if _staged("send", x, group):
        return _ring_exchange(x.cpu(), group, shift).to(x.device)
    x = x.contiguous()
    out = torch.empty_like(x)

    def rank(member):
        return tdist.get_global_rank(group, member) if group else member

    ops = [tdist.P2POp(tdist.isend, x, rank((i + shift) % n), group),
           tdist.P2POp(tdist.irecv, out, rank((i - shift) % n), group)]
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    return out


class _PpermuteRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return shift_counted(x, group, shift, "ppermute_ring_fwd")

    @staticmethod
    def backward(ctx, grad):
        return (shift_counted(grad.contiguous(), ctx.group, -ctx.shift,
                              "ppermute_ring_bwd"), None, None)


def ppermute_ring(x: torch.Tensor, group=None, *,
                  shift: int = 1) -> torch.Tensor:
    """Rotate values around the ring: member i sends to (i+shift) % n and
    receives from (i-shift) % n. Differentiable: the gradient goes back
    by ``-shift``. Counted in :data:`TP_COUNTS` as ``ppermute_ring_fwd``
    / ``ppermute_ring_bwd``."""
    return _PpermuteRing.apply(x, group, shift)


# Calls and bytes of the model-parallel collectives (tensor, expert,
# sequence and pipeline parallelism), by name:
# ``{"copy_to_bwd": [calls, bytes], ...}``. Reset with :func:`reset_tp_counts`.
TP_COUNTS: dict = {}


def reset_tp_counts() -> None:
    TP_COUNTS.clear()


def _count(name: str, x: torch.Tensor) -> None:
    calls = TP_COUNTS.setdefault(name, [0, 0])
    calls[0] += 1
    calls[1] += x.numel() * x.element_size()


def _sum_over(x: torch.Tensor, group, name: str) -> torch.Tensor:
    _count(name, x)
    out = x.contiguous().clone()
    tdist.all_reduce(out, group=group)
    return out


def shift_counted(x: torch.Tensor, group, shift: int, name: str
                  ) -> torch.Tensor:
    """:func:`ppermute_ring`'s exchange by ``shift`` outside autograd,
    counted in :data:`TP_COUNTS` under ``name`` (a shift by a multiple of
    the group's size moves nothing and is not counted)."""
    if shift % axis_size(group):
        _count(name, x)
    return _ring_exchange(x, group, shift)


def send_counted(x: torch.Tensor, group, member: int, name: str):
    """Send ``x`` to ``member`` of ``group`` without waiting, counted in
    :data:`TP_COUNTS` under ``name``: returns the pending work and the
    buffer sent, both to keep until :func:`wait_sends` (a CUDA tensor on
    gloo goes through a host copy)."""
    _count(name, x)
    buf = x.detach().contiguous()
    if _staged("send", buf, group):
        buf = buf.cpu()
    dst = tdist.get_global_rank(group, member) if group else member
    return tdist.isend(buf, dst, group=group), buf


def wait_sends(pending: list) -> None:
    """Wait for every ``(work, buffer)`` of :func:`send_counted`."""
    for work, _ in pending:
        work.wait()
    pending.clear()


def recv_counted(like: torch.Tensor, group, member: int,
                 name: str) -> torch.Tensor:
    """A tensor shaped and typed as ``like``, received from ``member`` of
    ``group`` (waits), counted under ``name``."""
    buf = torch.empty_like(like)
    host = buf.cpu() if _staged("recv", buf, group) else buf
    src = tdist.get_global_rank(group, member) if group else member
    tdist.recv(host, src, group=group)
    _count(name, buf)
    return host.to(buf.device) if host is not buf else buf


def broadcast_counted(x: torch.Tensor, group, root: int,
                      name: str) -> torch.Tensor:
    """Member ``root``'s ``x`` on every member (others pass a buffer of
    its shape), counted under ``name``."""
    _count(name, x)
    return broadcast(x, group, root)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.group, "copy_to_bwd"), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group, "reduce_from_fwd")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.index, ctx.width = axis_index(group), x.shape[dim]
        _count("gather_from_fwd", x)
        return torch.cat(_gather_list(x.contiguous(), group), dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.width,
                            ctx.width).contiguous(), None, None)


class _SeqSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_over(x, group, "seq_sum_fwd")

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.group, "seq_sum_bwd"), None


def seq_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every member's ``x`` (a pooled sum over a
    sequence-sharded axis), whose gradient is summed over the group too:
    each member's loss is the whole loss, so each member's share of the
    gradient is ``n`` times its part, and the gradient average over the
    batch's processes brings every parameter to the one-process gradient
    (the replicated head's is equal on every member, the sharded body's
    sums). ``None``: the identity."""
    if group is None:
        return x
    return _SeqSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "copy to the model-parallel region": ``x`` as it is,
    its gradient summed over ``group`` in the backward (the input of a
    column-parallel product, each member's product contributing its part
    of the input's gradient). ``None``: the identity."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "reduce from the model-parallel region": the sum of
    every member's ``x`` (a row-parallel product's partial sums), its
    gradient passed back as it is. ``None``: the identity."""
    if group is None:
        return x
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in member order
    (vocabulary-sharded logits made whole); the backward keeps this
    member's slice of the gradient. ``None``: the identity."""
    if group is None:
        return x
    return _GatherFromGroup.apply(x, group, dim % x.ndim)


def axis_index(group=None) -> int:
    """This member's position in the group (``hvd.rank()`` analogue)."""
    return tdist.get_rank(group) if tdist.is_initialized() else 0


def axis_size(group=None) -> int:
    """Members of the group (``hvd.size()`` analogue)."""
    return tdist.get_world_size(group) if tdist.is_initialized() else 1


# The largest flat buffer of :func:`flat_all_reduce_`: a model's whole
# gradient in one buffer would hold a second copy of it (6 GB for
# Llama-1B in f32).
FLAT_BUCKET_BYTES = 256 << 20


def flat_all_reduce_(tensors: List[torch.Tensor], group=None,
                     mean: bool = False) -> None:
    """Sum ``tensors`` over the group in place (``mean``: then divide by
    its size, as :func:`pmean`) through flat buffers per dtype, each of
    whole tensors up to :data:`FLAT_BUCKET_BYTES` (a larger tensor alone):
    one collective a bucket instead of one per tensor. Each element's sum
    is the same whatever the buckets."""
    if not tdist.is_initialized():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        bucket, nbytes = [], 0
        for t in ts:
            size = t.numel() * t.element_size()
            if bucket and nbytes + size > FLAT_BUCKET_BYTES:
                _reduce_bucket(bucket, group, mean)
                bucket, nbytes = [], 0
            bucket.append(t)
            nbytes += size
        if bucket:
            _reduce_bucket(bucket, group, mean)


def _reduce_bucket(ts: List[torch.Tensor], group, mean: bool) -> None:
    flat = torch.cat([t.reshape(-1) for t in ts])
    tdist.all_reduce(flat, group=group)
    if mean:
        flat.div_(axis_size(group))
    offset = 0
    for t in ts:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
