"""Weight-only int8 storage for serving (the port of
:mod:`pddl_tpu.ops.quant`): int8 weights, products in the model's compute
dtype.

:func:`quantize_int8` maps a model's parameters (its ``state_dict``
names) to a tree in which each eligible weight is the JAX package's
leaf ``{"qvalue": int8, "scale": f32, "like": dtype carrier}``:
symmetric, per output channel, the scale reduced over the CONTRACTION
axis — axis 0 of a JAX kernel, dim 1 of the port's ``[out, in]``
weights. Eligibility is the JAX leaf's: ``ndim >= 2``, ``size >=
min_elems`` and no ``embed`` in the name, judged on the JAX shape, so a
q/k/v bias (DenseGeneral ``[H, D]`` in JAX, flat ``[H·D]`` here) is
quantized over its heads axis exactly where the JAX package quantizes it;
its scale is stored repeated over the heads, so every scale broadcasts
against its ``qvalue``. Embeddings (``pos_embed`` too) stay dense:
decode gathers their rows.

:func:`dequantize` is the ``param_transform`` of ``generate``,
``generate_speculative`` and ``ServeEngine``: ``qvalue`` to f32, times
the scale, cast to the ``like`` dtype — bitwise the JAX function. The
JAX programs apply it to the whole tree inside every compiled program,
where XLA fuses it into the matmuls' operand reads. The port keeps int8
on the card the other way round: :func:`install_params` loads each
quantized leaf into its module as an int8 ``qvalue`` and f32 ``scale``
behind a ``torch.nn.utils.parametrize`` parametrization, which applies
``param_transform`` to that one leaf at every access — at each product,
so a forward holds at most one leaf's dense copy, never the model's.
:func:`dequantize` writes that copy block by block (one ``mul`` a block
of at most ``2**23`` elements, computed in f32 and rounded once to the
``like`` dtype), so no f32 copy of a whole leaf is ever made either (no
hand-written dequant or w8a16 kernel yet: ROADMAP.md, Speed).
:func:`with_params` is the functional form the ``variables=`` entry
points use: a model sharing the caller's modules' tensors with the tree
installed, the caller's model left as it was.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn
from torch.nn.utils import parametrize

from pddl_tpu_torch.models.layers import jax_shapes

__all__ = ["quantize_int8", "dequantize", "quantized_bytes",
           "install_params", "with_params", "is_qleaf"]

_QKEYS = frozenset(("qvalue", "scale", "like"))


def is_qleaf(node) -> bool:
    return isinstance(node, Mapping) and set(node.keys()) == _QKEYS


# The most elements :func:`dequantize` writes with one ``mul``: any f32
# temporary of the cast stays this small (the CPU's ``mul`` makes them,
# the card's casts in registers), and a large leaf (an LM head of 262.7 M
# weights) costs a few dozen launches, not an f32 copy of itself.
_DEQUANT_BLOCK = 1 << 23


def _levels(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor on ``like``'s device: torch's CUDA division by a
    Python scalar multiplies by its reciprocal, which is not IEEE division
    (the JAX package's ``amax / 127.0`` is), and would part the card's
    scales from the CPU's and the JAX package's by an ulp."""
    return torch.tensor(127.0, dtype=torch.float32, device=like.device)


def _quantize_leaf(w: torch.Tensor, jax_shape: Optional[tuple]) -> dict:
    wf = w.detach().float()
    if jax_shape is not None and len(jax_shape) != w.ndim:
        # Flat here, [H, D] in JAX: reduce over JAX's axis 0 (the heads),
        # then repeat the scale over the heads.
        wj = wf.reshape(jax_shape)
        amax = wj.abs().amax(dim=0)
        scale = torch.where(amax > 0, amax / _levels(amax), 1.0)
        q = torch.clamp(torch.round(wj / scale), -127, 127)
        scale = scale.expand(jax_shape).reshape(w.shape).contiguous()
        q = q.reshape(w.shape)
    else:
        # JAX kernels contract axis 0: [in, out] (dim 1 of the port's
        # [out, in]) or a conv's [kh, kw, in, out] (dim 2 of [out, in, kh,
        # kw]).
        axis = {2: 1, 4: 2}.get(w.ndim)
        if axis is None:
            raise ValueError(f"no int8 layout for a {w.ndim}-D weight")
        amax = wf.abs().amax(dim=axis, keepdim=True)
        scale = torch.where(amax > 0, amax / _levels(amax), 1.0)
        q = torch.clamp(torch.round(wf / scale), -127, 127)
    return {"qvalue": q.to(torch.int8), "scale": scale,
            "like": torch.zeros(0, dtype=w.dtype, device=w.device)}


def quantize_int8(model: nn.Module, *,
                  min_elems: int = 65536) -> Dict[str, object]:
    """A model's parameters → a flat tree (its ``state_dict`` names) with
    the eligible weights stored as int8 leaves (module docstring).

    Takes the model, not its ``state_dict``: each leaf is judged on its
    JAX shape, which only the modules know (a flat q/k/v bias is
    ``[H, D]`` in JAX). The default ``min_elems`` keeps every norm, bias
    and tiny test-model kernel in its original dtype."""
    if not isinstance(model, nn.Module):
        raise TypeError(
            "quantize_int8 takes the model (its modules know each "
            f"parameter's JAX shape), not a {type(model).__name__}")
    shapes = jax_shapes(model)
    out: Dict[str, object] = {}
    for name, w in model.state_dict().items():
        shape = shapes.get(name, tuple(w.shape))
        eligible = (w.is_floating_point() and len(shape) >= 2
                    and w.numel() >= min_elems and "embed" not in name.lower())
        out[name] = (_quantize_leaf(w, shapes.get(name)) if eligible
                     else w.detach())
    return out


def dequantize(qparams):
    """Inverse of :func:`quantize_int8`, identity on every other leaf: a
    tree maps to a tree, a single int8 leaf to its dense weight.

    Each element is ``qvalue`` times ``scale`` in f32, rounded once to the
    ``like`` dtype — bitwise the JAX function — written into the output
    in blocks of rows, so the only full-size tensor made is the output."""
    if is_qleaf(qparams):
        q, scale = qparams["qvalue"], qparams["scale"]
        out = torch.empty(q.shape, dtype=qparams["like"].dtype,
                          device=q.device)
        rows = max(1, _DEQUANT_BLOCK // max(1, q[:1].numel()))
        per_row = scale.ndim == q.ndim and scale.shape[0] == q.shape[0]
        for i in range(0, q.shape[0], rows):
            torch.mul(q[i:i + rows], scale[i:i + rows] if per_row else scale,
                      out=out[i:i + rows])
        return out
    if isinstance(qparams, Mapping):
        return {k: dequantize(v) for k, v in qparams.items()}
    return qparams


def quantized_bytes(tree) -> Dict[str, int]:
    """``{"bytes": stored bytes, "quantized_leaves": n}`` over a tree of
    tensors and int8 leaves — the memory claim as a measurement."""
    total, nq = 0, 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if is_qleaf(node):
            nq += 1
            for key in ("qvalue", "scale"):
                total += node[key].numel() * node[key].element_size()
        elif isinstance(node, Mapping):
            stack.extend(node.values())
        else:
            total += node.numel() * node.element_size()
    return {"bytes": int(total), "quantized_leaves": int(nq)}


class _Transformed(nn.Module):
    """The parametrization of one quantized weight: its ``scale`` and
    ``like`` ride along as buffers (they move with the model), and every
    access applies ``transform`` to the leaf."""

    def __init__(self, scale: torch.Tensor, like: torch.Tensor,
                 transform: Callable):
        super().__init__()
        self.register_buffer("scale", scale)
        self.register_buffer("like", like)
        self.transform = transform

    def forward(self, qvalue: torch.Tensor) -> torch.Tensor:
        return self.transform({"qvalue": qvalue, "scale": self.scale,
                               "like": self.like})


def _slot(model: nn.Module, name: str):
    prefix, _, attr = name.rpartition(".")
    module = model.get_submodule(prefix) if prefix else model
    return module, attr


def _check_names(model: nn.Module, params: Mapping,
                 param_transform: Optional[Callable], role: str) -> None:
    """``params`` names every parameter of ``model`` (a parametrized one
    by its own name), and its int8 leaves have a transform."""
    names = set(model.state_dict().keys())
    for prefix, module in model.named_modules():
        if parametrize.is_parametrized(module):
            base = f"{prefix}.parametrizations." if prefix else \
                "parametrizations."
            names = {n for n in names if not n.startswith(base)}
            names |= {f"{prefix}.{a}" if prefix else a
                      for a in module.parametrizations}
    if set(params) != names:
        missing = sorted(names - set(params))
        extra = sorted(set(params) - names)
        raise ValueError(f"{role} do not match the model's parameters "
                         f"(missing {missing[:4]}, unexpected {extra[:4]})")
    quantized = [name for name, value in params.items() if is_qleaf(value)]
    if quantized and param_transform is None:
        raise ValueError(f"{role} hold int8 leaves ({quantized[0]}, ...) "
                         "but no param_transform dequantizes them")


def _install(model: nn.Module, params: Mapping,
             param_transform: Optional[Callable], swap: bool) -> None:
    """Put each leaf of ``params`` into its slot: an int8 leaf as an int8
    parameter behind a parametrization; a dense leaf copied into the
    parameter (``swap=False``) or as a new parameter in its place."""
    dev = model.device
    for name, value in params.items():
        module, attr = _slot(model, name)
        was = parametrize.is_parametrized(module, attr)
        if was:
            parametrize.remove_parametrizations(module, attr,
                                                leave_parametrized=False)
        old = module._parameters[attr]
        if is_qleaf(value):
            module._parameters[attr] = nn.Parameter(
                value["qvalue"].to(dev), requires_grad=False)
            parametrize.register_parametrization(
                module, attr, _Transformed(value["scale"].to(dev),
                                           value["like"].to(dev),
                                           param_transform), unsafe=True)
        elif was:
            module._parameters[attr] = nn.Parameter(
                torch.as_tensor(value).to(dev))
        elif swap:
            module._parameters[attr] = nn.Parameter(
                torch.as_tensor(value).to(dev, old.dtype),
                requires_grad=old.requires_grad)
        else:
            old.copy_(torch.as_tensor(value))


@torch.no_grad()
def install_params(model: nn.Module, params: Mapping,
                   param_transform: Optional[Callable] = None,
                   *, role: str = "variables") -> nn.Module:
    """Load ``params`` (the port's ``state_dict`` names → tensors or int8
    leaves) into ``model`` in place, on the model's device: a dense leaf
    is copied into its parameter, an int8 leaf becomes that module's int8
    ``qvalue`` behind a parametrization applying ``param_transform`` at
    each access (module docstring). An int8 leaf without a
    ``param_transform`` raises, as the JAX programs cannot apply one. The
    names must be the model's, all of them. Returns the model."""
    _check_names(model, params, param_transform, role)
    _install(model, params, param_transform, swap=False)
    return model


@torch.no_grad()
def with_params(model: nn.Module, params: Mapping,
                param_transform: Optional[Callable] = None,
                *, role: str = "variables") -> nn.Module:
    """:func:`install_params` without touching ``model``: returns a copy
    of its modules that shares every tensor of ``model`` and holds
    ``params`` in place of its parameters, as the JAX entry points take
    ``variables`` for one call and leave the caller's tree alone. The
    copy's new parameters are the tree's tensors where they already sit
    on the model's device in its dtype (no second copy); the caller's
    model keeps its own weights, and drops them only when it goes."""
    _check_names(model, params, param_transform, role)
    memo = {}
    for module in model.modules():
        for t in (*module._parameters.values(), *module._buffers.values(),
                  *module.__dict__.values()):
            if isinstance(t, torch.Tensor):
                memo[id(t)] = t
    shell = copy.deepcopy(model, memo)
    _install(shell, params, param_transform, swap=True)
    return shell
