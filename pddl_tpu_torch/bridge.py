"""Weight bridge between a flax parameter tree (a Llama's, a GPT's, a
ViT's, or a ResNet's with its ``batch_stats``) and the port's
``state_dict``, both ways.

The JAX package's params are taken and given as NUMPY arrays
(``jax.tree.map(np.asarray, params)`` on the JAX side), so this module
needs neither jax nor flax. Each leaf keeps its dtype across the bridge
(f32 master weights stay f32; ``load_state_dict`` then copies into the
model's ``param_dtype``). The mapping:

- ``query``/``key``/``value`` DenseGeneral kernels ``[E, H, D]`` become
  Linear weights ``[H·D, E]`` (the reshape of
  ``pddl_tpu/ckpt/hf_export.py``), their biases ``[H, D]`` → ``[H·D]``;
- ``out``, ``mlp_*`` and ``lm_head`` kernels ``[in, out]`` are
  transposed to ``[out, in]``;
- ``embed`` and the RMSNorm ``scale``\\ s carry over as they are.

GPT and ViT blocks (:func:`gpt_params_from_jax`, :func:`vit_params_from_jax`)
map their biased ``query``/``key``/``value``/``out``, ``mlp1``/``mlp2``
and LayerNorm ``scale``/``bias`` (the port's ``weight``/``bias``) the same
way; GPT's ``token_embed`` and ``pos_embed`` and the ViT's ``pos_embed``
carry over, and the ViT's ``patch_embed`` conv kernel ``[p, p, C, E]``
becomes ``[E, C, p, p]``. A routed (MoE) block's ``moe`` subtree
carries over expert-major: ``router`` kernel ``[E, N]`` → ``[N, E]`` and
its bias, the experts' ``w1``/``w3``/``w2`` (and the GELU experts'
``b1``/``b2``) as they are.

:func:`shard_state_dict` cuts a whole state dict into one process's
blocks under a bound tensor- or expert-parallel strategy, so a sharded
run starts from the same numbers as a single-device JAX one.

For a ResNet (:func:`resnet_params_from_jax`): conv kernels ``[kh, kw,
in, out]`` become ``[out, in, kh, kw]``, the dense head's ``[in, out]``
becomes ``[out, in]``, BatchNorm ``scale``/``bias`` become its weight and
bias, and the ``batch_stats`` ``mean``/``var`` its running buffers;
``stage{s}_block{b}`` modules sit under ``blocks.``.

A GPipe model's tree ``{"embed", "stages", "head"}``
(:func:`gpipe_params_from_jax`, :func:`gpipe_params_to_jax`) maps its
embed and head as the family's stem and head, and slice ``i`` of every
stacked ``stages`` leaf as stage ``i``'s blocks (``stages.{i}.…``).

A trainer's shadows go the same way (:func:`ema_to_jax`: the EMA
shadows, ResNet's with its ``batch_stats`` shadow; :func:`master_to_jax`:
an ``f32_master`` rule's masters, f32 leaves standing for their own), so
a test compares them leaf by leaf with the JAX ``TrainState``'s
``ema_params``/``ema_batch_stats`` and ``F32MasterState.master``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    x = np.array(x)  # a writable, contiguous host copy
    if x.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _moe_from_jax(moe: Mapping, pre: str, sd: Dict) -> None:
    """A flax ``SwitchFFN`` subtree into ``sd`` under ``pre`` (``...moe.``)."""
    sd[pre + "router.weight"] = _tensor(np.asarray(moe["router"]["kernel"]).T)
    sd[pre + "router.bias"] = _tensor(moe["router"]["bias"])
    for name in ("w1", "w3", "w2", "b1", "b2"):
        if name in moe:
            sd[pre + name] = _tensor(moe[name])


def _moe_to_jax(sd: Mapping, pre: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {"router": {
        "kernel": _array(sd[pre + "router.weight"]).T.copy(),
        "bias": _array(sd[pre + "router.bias"])}}
    for name in ("w1", "w3", "w2", "b1", "b2"):
        if pre + name in sd:
            out[name] = _array(sd[pre + name])
    return out


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], strategy
                     ) -> Dict[str, torch.Tensor]:
    """A whole state dict (bridged from JAX, say) cut to this process's
    blocks under ``strategy``, a bound
    :class:`~pddl_tpu_torch.parallel.TensorParallelStrategy`: the sharded
    tensors narrowed along their dimension, the rest as they are."""
    return {k: strategy.local_state(k, v) for k, v in state_dict.items()}


def llama_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``Llama`` param tree (numpy leaves; the ``params``
    collection, not the ``{"params": ...}`` wrapper) to a state_dict for
    :class:`pddl_tpu_torch.models.llama.Llama`, routed blocks included."""
    sd: Dict[str, torch.Tensor] = {
        "stem.embed.weight": _tensor(params["embed"]["embedding"]),
        "head.ln_final.weight": _tensor(params["ln_final"]["scale"]),
        "head.lm_head.weight": _tensor(
            np.asarray(params["lm_head"]["kernel"]).T),
    }
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        blk = params[f"block{i}"]
        pre = f"blocks.{i}."
        sd[pre + "ln1.weight"] = _tensor(blk["ln1"]["scale"])
        sd[pre + "ln2.weight"] = _tensor(blk["ln2"]["scale"])
        attn = blk["attn"]
        for name in ("query", "key", "value"):
            kern = np.asarray(attn[name]["kernel"])          # [E, Hx, D]
            sd[pre + f"attn.{name}.weight"] = _tensor(
                kern.reshape(kern.shape[0], -1).T)           # [Hx*D, E]
            if "bias" in attn[name]:
                sd[pre + f"attn.{name}.bias"] = _tensor(
                    np.asarray(attn[name]["bias"]).reshape(-1))
        sd[pre + "attn.out.weight"] = _tensor(
            np.asarray(attn["out"]["kernel"]).T)
        if "moe" in blk:
            _moe_from_jax(blk["moe"], pre + "moe.", sd)
            continue
        for name in ("mlp_gate", "mlp_up", "mlp_down"):
            sd[pre + f"{name}.weight"] = _tensor(
                np.asarray(blk[name]["kernel"]).T)
    return sd


def _array(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy; bf16 (which numpy lacks) comes back as f32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def llama_params_to_jax(model, state_dict: Optional[Mapping] = None
                        ) -> Dict[str, Any]:
    """The inverse of :func:`llama_params_from_jax`: a port ``Llama``'s
    parameters (or ``state_dict``, a tree of its names, such as the
    trainer's EMA shadows) as a flax-layout tree of numpy arrays (the
    ``params`` collection), e.g. to compare trained weights with the JAX
    package's."""
    sd = model.state_dict() if state_dict is None else state_dict
    e = model.embed_dim
    out: Dict[str, Any] = {
        "embed": {"embedding": _array(sd["stem.embed.weight"])},
        "ln_final": {"scale": _array(sd["head.ln_final.weight"])},
        "lm_head": {"kernel": _array(sd["head.lm_head.weight"]).T.copy()},
    }
    heads = {"query": model.num_heads, "key": model.num_kv_heads,
             "value": model.num_kv_heads}
    for i in range(model.depth):
        pre = f"blocks.{i}."
        attn: Dict[str, Any] = {}
        for name, h in heads.items():
            w = _array(sd[pre + f"attn.{name}.weight"])      # [H*D, E]
            attn[name] = {"kernel": w.T.reshape(e, h, -1).copy()}
            if pre + f"attn.{name}.bias" in sd:
                attn[name]["bias"] = _array(
                    sd[pre + f"attn.{name}.bias"]).reshape(h, -1)
        attn["out"] = {"kernel": _array(sd[pre + "attn.out.weight"]).T.copy()}
        blk: Dict[str, Any] = {
            "ln1": {"scale": _array(sd[pre + "ln1.weight"])},
            "ln2": {"scale": _array(sd[pre + "ln2.weight"])},
            "attn": attn}
        if pre + "moe.router.weight" in sd:
            blk["moe"] = _moe_to_jax(sd, pre + "moe.")
        else:
            for name in ("mlp_gate", "mlp_up", "mlp_down"):
                blk[name] = {
                    "kernel": _array(sd[pre + f"{name}.weight"]).T.copy()}
        out[f"block{i}"] = blk
    return out


def _ln(leaf) -> Tuple[torch.Tensor, torch.Tensor]:
    return _tensor(leaf["scale"]), _tensor(leaf["bias"])


def _transformer_blocks_from_jax(params: Mapping, sd: Dict) -> None:
    """The ``block{i}`` subtrees of a flax GPT or ViT into ``sd``."""
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        blk = params[f"block{i}"]
        pre = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[pre + ln + ".weight"], sd[pre + ln + ".bias"] = _ln(blk[ln])
        attn = blk["attn"]
        for name in ("query", "key", "value"):
            kern = np.asarray(attn[name]["kernel"])          # [E, H, D]
            sd[pre + f"attn.{name}.weight"] = _tensor(
                kern.reshape(kern.shape[0], -1).T)           # [H*D, E]
            sd[pre + f"attn.{name}.bias"] = _tensor(
                np.asarray(attn[name]["bias"]).reshape(-1))
        named = [("attn.out", attn["out"])]
        if "moe" in blk:
            _moe_from_jax(blk["moe"], pre + "moe.", sd)
        else:
            named += [("mlp1", blk["mlp1"]), ("mlp2", blk["mlp2"])]
        for name, leaf in named:
            sd[pre + name + ".weight"] = _tensor(np.asarray(leaf["kernel"]).T)
            sd[pre + name + ".bias"] = _tensor(leaf["bias"])


def _transformer_blocks_to_jax(model, sd, out: Dict) -> None:
    e, h = model.embed_dim, model.num_heads
    for i in range(model.depth):
        pre = f"blocks.{i}."
        attn: Dict[str, Any] = {}
        for name in ("query", "key", "value"):
            w = _array(sd[pre + f"attn.{name}.weight"])      # [H*D, E]
            attn[name] = {
                "kernel": w.T.reshape(e, h, -1).copy(),
                "bias": _array(sd[pre + f"attn.{name}.bias"]).reshape(h, -1)}
        blk: Dict[str, Any] = {"attn": attn}
        for name in ("ln1", "ln2"):
            blk[name] = {"scale": _array(sd[pre + name + ".weight"]),
                         "bias": _array(sd[pre + name + ".bias"])}
        moe = pre + "moe.router.weight" in sd
        if moe:
            blk["moe"] = _moe_to_jax(sd, pre + "moe.")
        for name, key in (("attn.out", None),) + (
                () if moe else (("mlp1", "mlp1"), ("mlp2", "mlp2"))):
            leaf = {"kernel": _array(sd[pre + name + ".weight"]).T.copy(),
                    "bias": _array(sd[pre + name + ".bias"])}
            if key is None:
                attn["out"] = leaf
            else:
                blk[key] = leaf
        out[f"block{i}"] = blk


def gpt_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``GPT`` param tree (numpy leaves, the ``params``
    collection) to a state_dict for :class:`pddl_tpu_torch.models.gpt.GPT`."""
    sd: Dict[str, torch.Tensor] = {
        "stem.token_embed.weight": _tensor(params["token_embed"]["embedding"]),
        "stem.pos_embed": _tensor(params["pos_embed"]),
        "head.lm_head.weight": _tensor(
            np.asarray(params["lm_head"]["kernel"]).T),
        "head.lm_head.bias": _tensor(params["lm_head"]["bias"]),
    }
    sd["head.ln_final.weight"], sd["head.ln_final.bias"] = _ln(
        params["ln_final"])
    _transformer_blocks_from_jax(params, sd)
    return sd


def gpt_params_to_jax(model, state_dict: Optional[Mapping] = None
                      ) -> Dict[str, Any]:
    """The inverse of :func:`gpt_params_from_jax`: a port ``GPT``'s
    parameters as a flax-layout tree of numpy arrays."""
    sd = model.state_dict() if state_dict is None else state_dict
    out: Dict[str, Any] = {
        "token_embed": {"embedding": _array(sd["stem.token_embed.weight"])},
        "pos_embed": _array(sd["stem.pos_embed"]),
        "ln_final": {"scale": _array(sd["head.ln_final.weight"]),
                     "bias": _array(sd["head.ln_final.bias"])},
        "lm_head": {"kernel": _array(sd["head.lm_head.weight"]).T.copy(),
                    "bias": _array(sd["head.lm_head.bias"])},
    }
    _transformer_blocks_to_jax(model, sd, out)
    return out


def vit_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``ViT`` param tree (numpy leaves, the ``params``
    collection) to a state_dict for :class:`pddl_tpu_torch.models.vit.ViT`."""
    sd: Dict[str, torch.Tensor] = {
        "stem.patch_embed.weight": _tensor(np.asarray(
            params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)),
        "stem.patch_embed.bias": _tensor(params["patch_embed"]["bias"]),
        "stem.pos_embed": _tensor(params["pos_embed"]),
    }
    sd["head.ln_final.weight"], sd["head.ln_final.bias"] = _ln(
        params["ln_final"])
    if "head" in params:
        sd["head.head.weight"] = _tensor(np.asarray(
            params["head"]["kernel"]).T)
        sd["head.head.bias"] = _tensor(params["head"]["bias"])
    _transformer_blocks_from_jax(params, sd)
    return sd


def vit_params_to_jax(model, state_dict: Optional[Mapping] = None
                      ) -> Dict[str, Any]:
    """The inverse of :func:`vit_params_from_jax`."""
    sd = model.state_dict() if state_dict is None else state_dict
    out: Dict[str, Any] = {
        "patch_embed": {
            "kernel": np.ascontiguousarray(
                _array(sd["stem.patch_embed.weight"]).transpose(2, 3, 1, 0)),
            "bias": _array(sd["stem.patch_embed.bias"])},
        "pos_embed": _array(sd["stem.pos_embed"]),
        "ln_final": {"scale": _array(sd["head.ln_final.weight"]),
                     "bias": _array(sd["head.ln_final.bias"])},
    }
    if "head.head.weight" in sd:
        out["head"] = {"kernel": _array(sd["head.head.weight"]).T.copy(),
                       "bias": _array(sd["head.head.bias"])}
    _transformer_blocks_to_jax(model, sd, out)
    return out


_GPIPE_FAMILY = {"embed": "llama", "token_embed": "gpt",
                 "patch_embed": "vit"}


def _gpipe_family(embed_tree: Mapping) -> str:
    for key, family in _GPIPE_FAMILY.items():
        if key in embed_tree:
            return family
    raise ValueError(f"not a GPipe embed tree: {sorted(embed_tree)}")


def gpipe_params_from_jax(params: Mapping, stage: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
    """Map a flax GPipe param tree ``{"embed", "stages", "head"}`` (numpy
    leaves; every leaf under ``stages`` carries a leading ``[n_stages]``
    dim) of a ``GPipeLlama``, ``GPipeGPT`` or ``GPipeViT`` to a state_dict
    of the port's twin: stage ``i``'s slice goes to ``stages.{i}.…``.
    ``stage``: that stage's blocks only (with the embed and head), the
    state of a process bound to it."""
    family = _gpipe_family(params["embed"])
    stages = params["stages"]
    names = sorted((k for k in stages if k.startswith("block")),
                   key=lambda k: int(k[len("block"):]))
    per = len(names)
    n = int(np.shape(_first_leaf(stages))[0])
    merged: Dict[str, Any] = dict(params["embed"])
    merged.update(params["head"])
    for i in range(n):
        for j, name in enumerate(names):
            merged[f"block{i * per + j}"] = _slice_tree(stages[name], i)
    from_jax = {"llama": llama_params_from_jax, "gpt": gpt_params_from_jax,
                "vit": vit_params_from_jax}[family]
    out = {}
    for k, v in from_jax(merged).items():
        if k.startswith("stem."):
            k = "embed." + k[len("stem."):]
        elif k.startswith("blocks."):
            _, g, rest = k.split(".", 2)
            i, j = divmod(int(g), per)
            if stage is not None and i != stage:
                continue
            k = f"stages.{i}.blocks.{j}.{rest}"
        out[k] = v
    return out


def gpipe_params_to_jax(model, state_dict: Optional[Mapping] = None
                        ) -> Dict[str, Any]:
    """The inverse of :func:`gpipe_params_from_jax` for a port GPipe
    model built whole (or ``state_dict``, every stage's names): the flax
    GPipe tree, the stages' leaves stacked on a leading dim."""
    from types import SimpleNamespace  # noqa: PLC0415

    sd = model.state_dict() if state_dict is None else state_dict
    n = model.n_stages
    per = sum(1 for k in sd if k.startswith("stages.0.")
              and k.endswith("ln1.weight"))
    flat = {}
    for k, v in sd.items():
        if k.startswith("embed."):
            k = "stem." + k[len("embed."):]
        elif k.startswith("stages."):
            _, i, _, j, rest = k.split(".", 4)
            k = f"blocks.{int(i) * per + int(j)}.{rest}"
        flat[k] = v
    family = _gpipe_family({k.split(".")[1]: None for k in flat
                            if k.startswith("stem.")})
    shim = SimpleNamespace(
        embed_dim=model.embed_dim, num_heads=model.num_heads,
        num_kv_heads=getattr(model, "num_kv_heads", model.num_heads),
        depth=n * per)
    to_jax = {"llama": llama_params_to_jax, "gpt": gpt_params_to_jax,
              "vit": vit_params_to_jax}[family]
    tree = to_jax(shim, flat)
    blocks = {f"block{j}": [tree.pop(f"block{i * per + j}")
                            for i in range(n)] for j in range(per)}
    stages = {name: _stack_trees(parts) for name, parts in blocks.items()}
    embed_keys = {"llama": ("embed",), "gpt": ("token_embed", "pos_embed"),
                  "vit": ("patch_embed", "pos_embed")}[family]
    embed = {k: tree.pop(k) for k in embed_keys}
    return {"embed": embed, "stages": stages, "head": tree}


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def _slice_tree(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _slice_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _stack_trees(trees):
    if isinstance(trees[0], Mapping):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _resnet_key(path: str) -> str:
    """flax module path ``a/b`` -> the port's module path."""
    parts = path.split("/")
    if parts[0].startswith("stage"):
        parts.insert(0, "blocks")
    return ".".join(parts)


def _flat(tree: Mapping, prefix: str = ""):
    """(module path, leaf dict) for every innermost dict of ``tree``."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield prefix, leaves
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)


def resnet_params_from_jax(params: Mapping, batch_stats: Mapping
                           ) -> Dict[str, torch.Tensor]:
    """Map a flax ``ResNet``'s ``params`` and ``batch_stats`` collections
    (numpy leaves) to a state_dict for
    :class:`pddl_tpu_torch.models.resnet.ResNet`."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flat(params):
        key = _resnet_key(path)
        if "scale" in leaf:  # BatchNorm
            sd[key + ".weight"] = _tensor(leaf["scale"])
            sd[key + ".bias"] = _tensor(leaf["bias"])
            continue
        kern = np.asarray(leaf["kernel"])
        perm = (3, 2, 0, 1) if kern.ndim == 4 else (1, 0)
        sd[key + ".weight"] = _tensor(kern.transpose(perm))
        sd[key + ".bias"] = _tensor(leaf["bias"])
    for path, leaf in _flat(batch_stats):
        key = _resnet_key(path)
        sd[key + ".running_mean"] = _tensor(leaf["mean"])
        sd[key + ".running_var"] = _tensor(leaf["var"])
    return sd


def resnet_params_to_jax(state_dict: Mapping[str, torch.Tensor]
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of :func:`resnet_params_from_jax`: a port ResNet's
    ``state_dict`` as flax-layout ``(params, batch_stats)`` trees of numpy
    arrays."""
    modules: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in state_dict.items():
        path, leaf = name.rsplit(".", 1)
        modules.setdefault(path, {})[leaf] = t
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, value):
        parts = path.split(".")
        if parts[0] == "blocks":
            parts = parts[1:]
        for p in parts[:-1]:
            tree = tree.setdefault(p, {})
        tree[parts[-1]] = value

    for path, leaf in modules.items():
        if "running_mean" in leaf:
            put(params, path, {"scale": _array(leaf["weight"]),
                               "bias": _array(leaf["bias"])})
            put(stats, path, {"mean": _array(leaf["running_mean"]),
                              "var": _array(leaf["running_var"])})
            continue
        w = _array(leaf["weight"])
        perm = (2, 3, 1, 0) if w.ndim == 4 else (1, 0)
        put(params, path, {"kernel": np.ascontiguousarray(w.transpose(perm)),
                           "bias": _array(leaf["bias"])})
    return params, stats


def state_to_jax(model, state_dict: Mapping):
    """``state_dict`` (names of ``model``) in the JAX layout of the
    model's family: a params tree, or for a ResNet ``(params,
    batch_stats)``."""
    kind = type(model).__name__
    if kind == "ResNet":
        return resnet_params_to_jax(state_dict)
    convert = {"Llama": llama_params_to_jax, "GPT": gpt_params_to_jax,
               "ViT": vit_params_to_jax}.get(kind)
    if convert is None:
        raise TypeError(f"no JAX layout for a {kind}")
    return convert(model, state_dict)


def ema_to_jax(trainer):
    """The trainer's EMA shadows in the JAX layout (the ``ema_params``,
    and for a ResNet ``(ema_params, ema_batch_stats)``)."""
    if trainer.ema is None:
        raise ValueError("the trainer keeps no EMA (ema_decay=None)")
    sd = {**trainer.model.state_dict(), **trainer.ema}
    return state_to_jax(trainer.model, sd)


def master_to_jax(trainer):
    """The ``f32_master`` rule's masters in the JAX layout (a ResNet's
    params tree only): a bf16 parameter's master, and an f32 parameter
    itself, as the JAX rule's master tree holds every leaf in f32."""
    rule = trainer.optimizer
    while not hasattr(rule, "masters"):
        rule = rule.inner
    masters = rule.masters()
    model = trainer.model
    sd = dict(model.state_dict())
    for name, p in model.named_parameters():
        sd[name] = masters.get(p, p.detach().float())
    out = state_to_jax(model, sd)
    return out[0] if type(model).__name__ == "ResNet" else out
