"""The port's Llama weights as a HuggingFace ``transformers`` state dict
(the port of :mod:`pddl_tpu.ckpt.hf_export`): train here, serve anywhere
``transformers`` runs.

The inverse of :func:`~pddl_tpu_torch.ckpt.hf_import.load_hf_llama`,
reading the same key table (:func:`~pddl_tpu_torch.ckpt.hf_import.llama_keys`):
HF's ``nn.Linear`` weights and the port's are both ``[out, in]``, so the
map is a rename. Keys follow ``LlamaForCausalLM`` (``model.*`` and
``lm_head.weight``); values are f32 numpy arrays, as the JAX function's
(``torch.from_numpy`` them for ``load_state_dict``). The GPT-2 family is
deliberately not exported, as in the JAX package: HF GPT-2 ties
``lm_head`` to ``wte``, and a trained untied head has no faithful
representation in that format. A routed block exports as Mixtral's
``block_sparse_moe``: the router weight as ``gate.weight`` (its bias,
which Mixtral lacks, is not exported, as in the JAX package) and each
expert's ``w1``/``w3``/``w2`` ``[out, in]``, in the JAX exporter's order.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from pddl_tpu_torch.ckpt.hf_import import LLAMA_VOCAB_ROWS, llama_keys


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).contiguous().numpy()


def export_hf_llama(model, state_dict: Optional[Mapping] = None
                    ) -> Dict[str, np.ndarray]:
    """Map a port :class:`~pddl_tpu_torch.models.llama.Llama`'s weights
    (or ``state_dict``, a tree of its names such as the trainer's EMA
    shadows) onto HF Llama keys: ``{key: f32 ndarray}``.

    ``vocab_multiple`` padding is sliced off by ``model.vocab_size``
    (padding rows never influence training: the head slices them away).
    Q/K/V biases are kept when present (the Qwen2 lineage)."""
    sd = model.state_dict() if state_dict is None else state_dict
    vocab = model.vocab_size
    out: Dict[str, np.ndarray] = {}
    for ours, theirs in llama_keys(model.depth):
        pre = ours.rsplit("mlp_gate.weight", 1)[0]
        if ours.endswith(".mlp_gate.weight") and pre + "moe.w1" in sd:
            hf = theirs.rsplit("mlp.", 1)[0] + "block_sparse_moe."
            out[hf + "gate.weight"] = _f32(sd[pre + "moe.router.weight"])
            for name in ("w1", "w3", "w2"):
                stack = sd[pre + "moe." + name]
                for x in range(stack.shape[0]):
                    out[hf + f"experts.{x}.{name}.weight"] = _f32(
                        stack[x].t())
        if ours not in sd:
            continue  # a bias-free model's q/k/v biases, a routed MLP
        value = sd[ours]
        if ours in LLAMA_VOCAB_ROWS:
            value = value[:vocab]
        out[theirs] = _f32(value)
    return out
