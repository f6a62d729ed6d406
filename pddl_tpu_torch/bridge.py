"""Weight bridge: a flax Llama parameter tree → the port's ``state_dict``.

The JAX package's params are taken as NUMPY arrays (``jax.tree.map(
np.asarray, params)`` on the JAX side), so this module needs neither jax
nor flax. The mapping:

- ``query``/``key``/``value`` DenseGeneral kernels ``[E, H, D]`` become
  Linear weights ``[H·D, E]`` (the reshape of
  ``pddl_tpu/ckpt/hf_export.py``), their biases ``[H, D]`` → ``[H·D]``;
- ``out``, ``mlp_*`` and ``lm_head`` kernels ``[in, out]`` are
  transposed to ``[out, in]``;
- ``embed`` and the RMSNorm ``scale``\\ s carry over as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
