"""Weight bridge between a flax Llama parameter tree and the port's
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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    x = np.array(x)  # a writable, contiguous host copy
    if x.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def llama_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``Llama`` param tree (numpy leaves; the ``params``
    collection, not the ``{"params": ...}`` wrapper) to a state_dict for
    :class:`pddl_tpu_torch.models.llama.Llama`. Raises on MoE blocks."""
    sd: Dict[str, torch.Tensor] = {
        "stem.embed.weight": _tensor(params["embed"]["embedding"]),
        "head.ln_final.weight": _tensor(params["ln_final"]["scale"]),
        "head.lm_head.weight": _tensor(
            np.asarray(params["lm_head"]["kernel"]).T),
    }
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        blk = params[f"block{i}"]
        if "moe" in blk:
            raise NotImplementedError(
                "MoE blocks are not ported yet (ROADMAP.md queue 1 item 5)")
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
        for name in ("mlp_gate", "mlp_up", "mlp_down"):
            sd[pre + f"{name}.weight"] = _tensor(
                np.asarray(blk[name]["kernel"]).T)
    return sd


def _array(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy; bf16 (which numpy lacks) comes back as f32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def llama_params_to_jax(model) -> Dict[str, Any]:
    """The inverse of :func:`llama_params_from_jax`: a port ``Llama``'s
    parameters as a flax-layout tree of numpy arrays (the ``params``
    collection), e.g. to compare trained weights with the JAX package's."""
    sd = model.state_dict()
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
        for name in ("mlp_gate", "mlp_up", "mlp_down"):
            blk[name] = {"kernel": _array(sd[pre + f"{name}.weight"]).T.copy()}
        out[f"block{i}"] = blk
    return out
