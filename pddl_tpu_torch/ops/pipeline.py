"""GPipe pipeline parallelism over the ``stage`` axis of the mesh (the port
of :mod:`pddl_tpu.ops.pipeline`).

One process drives one stage: it holds that stage's parameters (the JAX
strategy shards the stacked ``[n_stages, ...]`` leaves one stage a
position; :class:`~pddl_tpu_torch.parallel.pipeline.PipelineStrategy`
keeps each process's stage). The batch is split into microbatches; stage
0 takes each in turn, every stage runs its microbatch and sends the
activations to the next stage, and the last stage collects the outputs,
which then reach every stage (a broadcast from the last stage, the JAX
``psum`` of the last stage's outputs). The JAX schedule runs every stage
on every tick and discards the bubble ticks' outputs; here each stage
runs only its ``M`` real microbatches, in order, and the point-to-point
sends and receives pace it. The bubble, ``(S-1)/(M+S-1)``, is the time a
stage waits in them.

The schedule is one ``torch.autograd.Function`` whose backward is the
reverse pipeline in a fixed order (microbatches from last to first on
every stage): the last stage starts from the outputs' gradient, each
stage differentiates its microbatch (``torch.autograd.grad``) and sends
the input's gradient to the stage before, and stage 0's microbatch
gradients are the input's. The stage parameters' gradients are the sum
over microbatches. The last stage's output gradient is its own: every
stage computes the head and the loss from the same outputs, and the
loss is counted once. The hops are counted in
:data:`~pddl_tpu_torch.core.collectives.TP_COUNTS` as ``pp_hop_fwd``,
``pp_hop_bwd`` and ``pp_outputs_fwd``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from pddl_tpu_torch.core import collectives
from pddl_tpu_torch.core.mesh import DATA_AXIS, STAGE_AXIS

PyTree = Any


def _stage_tensors(stage_params) -> List[torch.Tensor]:
    """The tensors of a stage that take a gradient: a module's parameters
    or the tensors of a dict/list of them."""
    if isinstance(stage_params, torch.nn.Module):
        leaves = list(stage_params.parameters())
    elif isinstance(stage_params, dict):
        leaves = list(stage_params.values())
    elif isinstance(stage_params, (list, tuple)):
        leaves = list(stage_params)
    else:
        leaves = [stage_params]
    return [t for t in leaves
            if isinstance(t, torch.Tensor) and t.requires_grad]


class _GPipe(torch.autograd.Function):
    """The schedule on this process's stage (module docstring)."""

    @staticmethod
    def forward(ctx, x, cfg, *params):
        stage_params, stage_fn, m, group, sid, n, remat, grad = cfg
        last = n - 1
        fn = stage_fn
        if remat:
            def fn(p, h):
                return checkpoint(stage_fn, p, h, use_reentrant=False)
        mb = x.shape[0] // m
        pending: list = []
        ins, outs, ys = [], [], []
        for i in range(m):
            if sid == 0:
                h = x[i * mb:(i + 1) * mb]
            else:
                h = collectives.recv_counted(x[:mb], group, sid - 1,
                                             "pp_hop_fwd")
            h = h.detach().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                y = fn(stage_params, h)
            if y.shape != h.shape:
                raise ValueError(
                    f"a stage maps {tuple(h.shape)} to {tuple(y.shape)}: the "
                    "pipeline's stages keep the activations' shape")
            if grad:
                ins.append(h)
                ys.append(y)
            if sid < last:
                pending.append(collectives.send_counted(
                    y.to(x.dtype), group, sid + 1, "pp_hop_fwd"))
            else:
                outs.append(y.detach().to(x.dtype))
        collectives.wait_sends(pending)
        out = torch.cat(outs) if sid == last else torch.empty_like(x)
        out = collectives.broadcast_counted(out, group, last,
                                            "pp_outputs_fwd")
        ctx.cfg = (group, sid, n, mb)
        ctx.graph = (ins, ys, params)
        return out

    @staticmethod
    def backward(ctx, g_out):
        group, sid, n, mb = ctx.cfg
        ins, ys, params = ctx.graph
        last = n - 1
        grads = [None] * len(params)
        dx: List[torch.Tensor] = [None] * len(ys)
        pending: list = []
        for i in reversed(range(len(ys))):
            h, y = ins[i], ys[i]
            if sid == last:
                g = g_out[i * mb:(i + 1) * mb].to(y.dtype)
            else:
                g = collectives.recv_counted(y.detach(), group, sid + 1,
                                             "pp_hop_bwd")
            got = torch.autograd.grad(y, [h, *params], g,
                                      allow_unused=True)
            for j, gp in enumerate(got[1:]):
                if gp is not None:
                    grads[j] = gp if grads[j] is None else grads[j] + gp
            if sid > 0:
                pending.append(collectives.send_counted(
                    got[0], group, sid - 1, "pp_hop_bwd"))
            else:
                dx[i] = got[0]
        collectives.wait_sends(pending)
        ctx.graph = None
        grad_x = torch.cat(dx) if sid == 0 else None
        return (grad_x, None, *grads)


def gpipe_apply(
    stage_params: PyTree,
    x: torch.Tensor,
    *,
    mesh,
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    n_microbatches: int,
    stage_axis: str = STAGE_AXIS,
    data_axis: str = DATA_AXIS,
    check_vma: bool = True,
    remat_stages: bool = False,
) -> torch.Tensor:
    """Run ``x`` through the stage pipeline; returns same-shape activations.

    Args:
      stage_params: THIS process's stage (a module, or a dict/list of
        tensors), handed to ``stage_fn`` as it is; the tensors among it
        that require a gradient get one.
      x: this process's rows ``[batch, ...]`` (its ``data`` position's:
        the strategy splits the global batch over ``data`` and checks that
        it divides, with the JAX text).
      stage_fn: ``(stage_params, microbatch) -> microbatch`` for one stage.
      n_microbatches: microbatch count M; the per-data-shard batch must
        divide by it. Larger M shrinks the bubble ``(S-1)/(M+S-1)``.
      check_vma: the JAX varying-axes checker's switch; accepted and
        ignored (it has no counterpart here).
      remat_stages: recompute each stage's microbatch in the backward
        (``torch.utils.checkpoint``): only the microbatch inputs are kept,
        and no number changes.
    """
    del check_vma, data_axis  # the strategy splits the batch over data
    n_stages = mesh.shape[stage_axis]
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(
            f"per-data-shard batch {batch} not divisible by "
            f"{n_microbatches} microbatches")
    if n_stages == 1:  # degenerate: no pipeline, just apply the one stage
        if remat_stages and torch.is_grad_enabled():
            return checkpoint(stage_fn, stage_params, x, use_reentrant=False)
        return stage_fn(stage_params, x)
    params = _stage_tensors(stage_params)
    grad = torch.is_grad_enabled() and (x.requires_grad or bool(params))
    cfg: Tuple = (stage_params, stage_fn, n_microbatches,
                  mesh.axis_group(stage_axis), mesh.axis_index(stage_axis),
                  n_stages, remat_stages and grad, grad)
    return _GPipe.apply(x, cfg, *params)
