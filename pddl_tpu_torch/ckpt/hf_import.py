"""HuggingFace LM weights into the port's GPT and Llama (the port of
:mod:`pddl_tpu.ckpt.hf_import`): the LM families' ``weights='imagenet'``.

**The call form.** The port's models carry their weights, so, as
:func:`~pddl_tpu_torch.ckpt.keras_import.load_keras_resnet50_h5` does,
:func:`load_hf_gpt2` and :func:`load_hf_llama` take the model where the
JAX functions take a variables tree and its ``model=``:
``load_hf_gpt2(model_or_dir, model, *, expected_ln_eps=None)`` and
``load_hf_llama(model_or_dir, model, *, expected_rms_eps=None,
expected_rope_theta=None)`` load in place under ``torch.no_grad()`` and
return ``model``. Every value is cast to its tensor's own dtype. The
checks the JAX functions run only when ``model=`` is given (epsilon, RoPE
theta, the sliding window) always run here, since the model is always
there. A JAX-form call, which passes ``{"params": ...}`` second, raises a
``TypeError`` naming this form.

``model_or_dir`` is a ``transformers`` model, any object with a
``state_dict()`` (torch tensors or numpy arrays, such as
:func:`~pddl_tpu_torch.ckpt.hf_export.export_hf_llama`'s output behind a
holder), or a local checkpoint directory, which imports ``transformers``
at call time; importing this module imports no ``transformers``. Keys are
accepted with and without their prefix (``transformer.`` / ``model.``).

**The layouts** (one key table a family, :func:`llama_keys` and
:func:`gpt2_keys`; the exporter reads the Llama one):

========================  ===========================  ==================
HF                        port                         layout
========================  ===========================  ==================
Llama ``nn.Linear``       ``blocks.{i}.attn.query`` …  ``[out, in]`` both:
                                                       a rename
GPT-2 ``Conv1D``          ``blocks.{i}.attn.query`` …  ``[in, out]`` →
                                                       ``[out, in]``: ``c_attn``
                                                       splits in three and
                                                       transposes, as do
                                                       ``c_proj``, ``c_fc``,
                                                       ``mlp.c_proj``
GPT-2 ``wpe [P, E]``      ``stem.pos_embed``           ``[1, P, E]``
========================  ===========================  ==================

A ``vocab_multiple``-padded model takes the smaller HF vocabulary: the
real rows fill and the padding rows keep their init (the head slices them
away). A Llama checkpoint without ``lm_head.weight`` ties the head to the
embedding; GPT-2's head is always its ``wte``, with the bias zeroed over
the real vocabulary. Mistral (``sliding_window``) and Qwen2 (q/k/v
biases) checkpoints are Llama-layout state dicts and load through
:func:`load_hf_llama`. So do Mixtral checkpoints (:func:`load_hf_mixtral`
resolves a directory through ``MixtralForCausalLM``): a layer's
``block_sparse_moe.gate`` is the routed block's ``moe.router`` weight (a
rename; the router's bias, which Mixtral lacks, keeps the model's) and
the per-expert ``experts.{x}.w1|w3|w2`` ``[out, in]`` stack, transposed,
into the expert-major ``moe.w1|w3|w2``. The model's routed blocks must
sit where the checkpoint's are, with its expert count, and against a
config ``moe_top_k`` must equal ``num_experts_per_tok`` (a model with
``moe_eval_dropless=False`` must carry a capacity factor of at least
``num_local_experts / num_experts_per_tok``), as the JAX importer checks.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# A Llama layer's leaves: port name under ``blocks.{i}.`` -> HF name under
# ``model.layers.{i}.``. The q/k/v biases are Qwen2's, present only in
# biased models.
LLAMA_BLOCK_KEYS: Tuple[Tuple[str, str], ...] = (
    ("ln1.weight", "input_layernorm.weight"),
    ("ln2.weight", "post_attention_layernorm.weight"),
    ("attn.query.weight", "self_attn.q_proj.weight"),
    ("attn.query.bias", "self_attn.q_proj.bias"),
    ("attn.key.weight", "self_attn.k_proj.weight"),
    ("attn.key.bias", "self_attn.k_proj.bias"),
    ("attn.value.weight", "self_attn.v_proj.weight"),
    ("attn.value.bias", "self_attn.v_proj.bias"),
    ("attn.out.weight", "self_attn.o_proj.weight"),
    ("mlp_gate.weight", "mlp.gate_proj.weight"),
    ("mlp_up.weight", "mlp.up_proj.weight"),
    ("mlp_down.weight", "mlp.down_proj.weight"),
)
LLAMA_HEAD = ("head.lm_head.weight", "lm_head.weight")  # outside ``model.``
# The leaves whose first axis is the (padded) vocabulary.
LLAMA_VOCAB_ROWS = frozenset({"stem.embed.weight", "head.lm_head.weight"})

_MOE_REFUSAL = ("Mixtral checkpoints (block_sparse_moe layers) load into "
                "a Llama: use load_hf_mixtral")


def llama_keys(depth: int) -> Iterator[Tuple[str, str]]:
    """``(port name, HF name)`` of every Llama leaf, in the JAX exporter's
    order, biases included (a caller skips the ones its model lacks)."""
    yield "stem.embed.weight", "model.embed_tokens.weight"
    yield LLAMA_HEAD
    yield "head.ln_final.weight", "model.norm.weight"
    for i in range(depth):
        for ours, theirs in LLAMA_BLOCK_KEYS:
            yield f"blocks.{i}.{ours}", f"model.layers.{i}.{theirs}"


def gpt2_keys(i: int) -> Dict[str, Tuple[str, bool]]:
    """GPT-2 layer ``i``: port name -> (HF name under ``transformer.``,
    transposed). ``attn.c_attn`` is missing: it splits into the three
    projections (:func:`load_hf_gpt2`)."""
    pre, hf = f"blocks.{i}.", f"h.{i}."
    out = {}
    for ours, theirs in (("ln1", "ln_1"), ("ln2", "ln_2")):
        out[pre + ours + ".weight"] = (hf + theirs + ".weight", False)
        out[pre + ours + ".bias"] = (hf + theirs + ".bias", False)
    for ours, theirs in (("attn.out", "attn.c_proj"), ("mlp1", "mlp.c_fc"),
                         ("mlp2", "mlp.c_proj")):
        out[pre + ours + ".weight"] = (hf + theirs + ".weight", True)
        out[pre + ours + ".bias"] = (hf + theirs + ".bias", False)
    return out


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(value))


def _check_call(model, fn: str, form: str) -> None:
    if isinstance(model, Mapping) or not isinstance(model, nn.Module):
        raise TypeError(
            f"{fn} loads into the port's model in place: {form} (the JAX "
            "form passes a {'params': ...} tree and model=; the port's "
            "model carries its weights)")


def _put(target: Dict[str, torch.Tensor], name: str, value, *,
         allow_vocab_pad: bool = False, what: str = "hf import") -> None:
    """Copy ``value`` into the model's tensor ``name`` (cast to its
    dtype). ``allow_vocab_pad``: a smaller HF vocabulary fills the real
    slice of a ``vocab_multiple``-padded leaf (rows of ``[V, E]``, columns
    of ``[E, V]``, or a ``[V]`` bias); the padding keeps its init."""
    old = target[name]
    value = _tensor(value)
    vs, os_ = tuple(value.shape), tuple(old.shape)
    dst = old
    if allow_vocab_pad and vs != os_:
        # Merge only when the checkpoint FITS inside the padded leaf; a
        # larger vocabulary (a wrong vocab_size) falls through to the
        # shape error below.
        fits = (len(vs) == len(os_) and all(a <= b for a, b in zip(vs, os_))
                and sum(a != b for a, b in zip(vs, os_)) == 1)
        if fits:
            if value.ndim == 1 or vs[0] != os_[0]:
                dst = old[:vs[0]]
            else:
                dst = old[:, :vs[1]]
            vs, os_ = tuple(value.shape), tuple(dst.shape)
    if vs != os_:
        raise ValueError(
            f"{what} {name}: shape {tuple(value.shape)} != model's "
            f"{tuple(old.shape)} (wrong depth/width/heads?)")
    dst.copy_(value)


def _state_dict(model_or_dir) -> Dict[str, object]:
    return dict(model_or_dir.state_dict())


def _hf_depth(sd, prefix: str, layers: str) -> int:
    pattern = re.compile(rf"{re.escape(prefix)}{layers}\.(\d+)\.")
    return 1 + max((int(m.group(1)) for m in map(pattern.match, sd) if m),
                   default=-1)


def _refuse_moe(sd) -> None:
    if any(".block_sparse_moe." in k for k in sd):
        raise ValueError(_MOE_REFUSAL)


def _check_experts_config(model, cfg) -> None:
    """The JAX importer's Mixtral config checks: the routing width, and a
    capacity that cannot drop at inference."""
    have_tk = getattr(cfg, "num_experts_per_tok", None)
    n_local = getattr(cfg, "num_local_experts", None)
    if not (n_local and have_tk):
        return
    want_tk = getattr(model, "moe_top_k", None)
    if want_tk is not None and want_tk != have_tk:
        raise ValueError(
            f"hf llama import: model moe_top_k={want_tk} but the checkpoint "
            f"uses num_experts_per_tok={have_tk} — rebuild with "
            f"moe_top_k={have_tk}")
    if not getattr(model, "moe_eval_dropless", False):
        want_cf = getattr(model, "moe_capacity_factor", None)
        if want_cf is not None and want_cf < n_local / have_tk:
            raise ValueError(
                f"hf llama import: moe_eval_dropless=False with "
                f"moe_capacity_factor={want_cf} can drop routed tokens at "
                f"inference (dropless Mixtral needs >= num_local_experts/"
                f"num_experts_per_tok = {n_local / have_tk:g}) — re-enable "
                "moe_eval_dropless or raise moe_capacity_factor for serving "
                "parity")


def _moe_layers(sd, prefix: str, model) -> Dict[int, int]:
    """``{layer: experts}`` of the checkpoint's routed layers, checked
    against the model's routed blocks."""
    out = {}
    for i, block in enumerate(model.blocks):
        hf = f"{prefix}layers.{i}.block_sparse_moe."
        moe = getattr(block, "moe", None)
        if hf + "gate.weight" not in sd:
            if moe is not None:
                raise ValueError(
                    f"hf llama import: layer {i} of the checkpoint is dense "
                    "but the model block routes experts — rebuild the "
                    "Llama with moe_experts=0 (or the checkpoint's "
                    "moe_every)")
            continue
        if moe is None:
            raise ValueError(
                "hf llama import: checkpoint is a Mixtral (routed experts "
                f"in layer {i}) but the model block has no MoE — rebuild "
                "the Llama with moe_experts=config.num_local_experts")
        n_exp = moe.w1.shape[0]
        ck_exp = sum(1 for k in sd if k.startswith(hf + "experts.")
                     and k.endswith(".w1.weight"))
        if n_exp != ck_exp:
            raise ValueError(
                f"hf llama import: layer {i} has {ck_exp} experts in the "
                f"checkpoint but the model was built with moe_experts="
                f"{n_exp}")
        out[i] = n_exp
    return out


@torch.no_grad()
def load_hf_gpt2(model_or_dir, model: nn.Module, *,
                 expected_ln_eps: Optional[float] = None) -> nn.Module:
    """Load a HF GPT-2 checkpoint (``GPT2LMHeadModel``) into the port's
    :class:`~pddl_tpu_torch.models.gpt.GPT` in place; returns ``model``.

    LayerNorm epsilon is a module attribute, invisible in the weights: it
    is checked against the checkpoint's ``layer_norm_epsilon`` (1e-5 when
    the source has no config), ``expected_ln_eps`` overriding the
    model's, since a mismatch would import cleanly and skew every logit.
    Positions must equal the model's ``max_len`` and depths must match."""
    _check_call(model, "load_hf_gpt2",
                "load_hf_gpt2(model_or_dir, model, *, expected_ln_eps=None)"
                " -> model")
    if isinstance(model_or_dir, str):
        from transformers import GPT2LMHeadModel  # noqa: PLC0415

        model_or_dir = GPT2LMHeadModel.from_pretrained(model_or_dir)
    if expected_ln_eps is None:
        expected_ln_eps = model.head.ln_final.eps
    cfg = getattr(model_or_dir, "config", None)
    hf_eps = getattr(cfg, "layer_norm_epsilon", 1e-5)
    if not np.isclose(expected_ln_eps, hf_eps, rtol=1e-3):
        raise ValueError(
            f"hf import: model was built with ln_eps={expected_ln_eps} "
            f"but the checkpoint uses layer_norm_epsilon={hf_eps} — "
            f"build the GPT with ln_eps={hf_eps} (epsilon is baked "
            "into the module, not the weights, so the import would "
            "silently produce wrong logits)")
    sd = _state_dict(model_or_dir)
    _refuse_moe(sd)
    prefix = "transformer." if any(k.startswith("transformer.")
                                   for k in sd) else ""
    target = model.state_dict()

    def put(name, value, allow_vocab_pad=False):
        _put(target, name, value, allow_vocab_pad=allow_vocab_pad)

    wte = _tensor(sd[f"{prefix}wte.weight"])
    put("stem.token_embed.weight", wte, allow_vocab_pad=True)
    wpe = _tensor(sd[f"{prefix}wpe.weight"])
    pos = target["stem.pos_embed"]
    if wpe.shape[0] != pos.shape[1]:
        raise ValueError(
            f"hf import: positions {wpe.shape[0]} != model max_len "
            f"{pos.shape[1]}")
    put("stem.pos_embed", wpe[None])
    n_hf = _hf_depth(sd, prefix, "h")
    if n_hf != model.depth:
        raise ValueError(
            f"hf import: checkpoint has {n_hf} transformer layers but the "
            f"model has {model.depth} — depths must match (a deeper "
            "checkpoint would silently drop layers)")
    e = wte.shape[1]
    for i in range(model.depth):
        for ours, (theirs, transpose) in gpt2_keys(i).items():
            value = _tensor(sd[prefix + theirs])
            put(ours, value.t() if transpose else value)
        qkv_w = _tensor(sd[f"{prefix}h.{i}.attn.c_attn.weight"])  # [E, 3E]
        qkv_b = _tensor(sd[f"{prefix}h.{i}.attn.c_attn.bias"])    # [3E]
        for j, name in enumerate(("query", "key", "value")):
            put(f"blocks.{i}.attn.{name}.weight",
                qkv_w[:, j * e:(j + 1) * e].t())
            put(f"blocks.{i}.attn.{name}.bias", qkv_b[j * e:(j + 1) * e])
    put("head.ln_final.weight", sd[f"{prefix}ln_f.weight"])
    put("head.ln_final.bias", sd[f"{prefix}ln_f.bias"])
    # GPT-2 ties its head to wte; the port's head is a biased Linear over
    # the padded vocabulary.
    put("head.lm_head.weight", wte, allow_vocab_pad=True)
    target["head.lm_head.bias"][:wte.shape[0]] = 0.0
    return model


def _resolve_window(model, cfg) -> None:
    """The JAX importer's sliding-window resolution: ``layer_types``,
    then Qwen2's ``use_sliding_window`` gate, then its
    ``max_window_layers`` by hand; a mixed split raises, and the result
    must equal the model's window."""
    want_sw = getattr(model, "sliding_window", None)
    have_sw = getattr(cfg, "sliding_window", None)
    layer_types = getattr(cfg, "layer_types", None)
    if layer_types is not None:
        kinds = set(layer_types)
        if kinds == {"full_attention"}:
            have_sw = None
        elif kinds != {"sliding_attention"}:
            raise ValueError(
                "hf llama import: checkpoint mixes per-layer "
                f"attention types {sorted(kinds)} (e.g. Qwen2 "
                "max_window_layers) — not representable by the "
                "global sliding_window attribute")
    elif getattr(cfg, "use_sliding_window", True) is False:
        have_sw = None
    elif have_sw is not None:
        mwl = getattr(cfg, "max_window_layers", None)
        nhl = getattr(cfg, "num_hidden_layers", None)
        if mwl is not None and nhl is not None:
            if mwl >= nhl:
                have_sw = None
            elif mwl > 0:
                raise ValueError(
                    "hf llama import: checkpoint windows only "
                    f"layers >= max_window_layers={mwl} of {nhl} "
                    "— not representable by the global "
                    "sliding_window attribute")
    if want_sw != have_sw:
        raise ValueError(
            f"hf llama import: model sliding_window={want_sw} but "
            f"the checkpoint config uses {have_sw} — rebuild with "
            f"sliding_window={have_sw}")


@torch.no_grad()
def load_hf_llama(model_or_dir, model: nn.Module, *,
                  expected_rms_eps: Optional[float] = None,
                  expected_rope_theta: Optional[float] = None) -> nn.Module:
    """Load a HF Llama (or Mistral, or Qwen2) checkpoint into the port's
    :class:`~pddl_tpu_torch.models.llama.Llama` in place; returns
    ``model``.

    Against a real config, ``rms_eps`` and ``rope_theta`` are checked
    (the ``expected_*`` values overriding the model's) and the sliding
    window resolved and held to the model's (module docstring); a bare
    state-dict holder has no config to check. The q/k/v biases must be
    in both or in neither, and depths must match. The checkpoint's
    ``rope_scaling`` is not read: neither package models it."""
    _check_call(model, "load_hf_llama",
                "load_hf_llama(model_or_dir, model, *, expected_rms_eps="
                "None, expected_rope_theta=None) -> model")
    if isinstance(model_or_dir, str):
        from transformers import LlamaForCausalLM  # noqa: PLC0415

        model_or_dir = LlamaForCausalLM.from_pretrained(model_or_dir)
    cfg = getattr(model_or_dir, "config", None)
    if expected_rms_eps is None:
        expected_rms_eps = model.head.ln_final.eps
    if expected_rope_theta is None:
        expected_rope_theta = model.blocks[0].attn.rope_theta
    sd = _state_dict(model_or_dir)
    if cfg is not None:
        for name, want, have in (
                ("rms_eps", expected_rms_eps,
                 getattr(cfg, "rms_norm_eps", None)),
                ("rope_theta", expected_rope_theta,
                 getattr(cfg, "rope_theta", None))):
            if want is not None and have is not None \
                    and not np.isclose(want, have, rtol=1e-3):
                raise ValueError(
                    f"hf llama import: model was built with {name}={want} "
                    f"but the checkpoint uses {have} — rebuild the Llama "
                    f"with {name}={have} (the value is baked into the "
                    "module, not the weights, so the import would "
                    "silently skew logits)")
        _resolve_window(model, cfg)
        _check_experts_config(model, cfg)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    target = model.state_dict()
    routed = _moe_layers(sd, prefix, model)

    ckpt_has_bias = f"{prefix}layers.0.self_attn.q_proj.bias" in sd
    model_has_bias = "blocks.0.attn.query.bias" in target
    if ckpt_has_bias and not model_has_bias:
        raise ValueError(
            "hf llama import: checkpoint carries q/k/v projection biases "
            "(Qwen2-style) but the model has none — rebuild the Llama "
            "with qkv_bias=True")
    if model_has_bias and not ckpt_has_bias:
        raise ValueError(
            "hf llama import: model was built with qkv_bias=True but the "
            "checkpoint has no q/k/v projection biases — rebuild with "
            "qkv_bias=False")
    n_hf = _hf_depth(sd, prefix, "layers")
    if n_hf != model.depth:
        raise ValueError(
            f"hf llama import: checkpoint has {n_hf} layers but the model "
            f"has {model.depth} — depths must match")
    embed = sd[f"{prefix}embed_tokens.weight"]
    for ours, theirs in llama_keys(model.depth):
        if ours not in target:
            continue  # a bias-free model's q/k/v biases
        if theirs == LLAMA_HEAD[1]:
            value = sd.get(theirs, embed)  # tied when absent
        else:
            value = sd[prefix + theirs[len("model."):]]
        _put(target, ours, value, allow_vocab_pad=ours in LLAMA_VOCAB_ROWS,
             what="hf llama import")
    for i, n_exp in routed.items():
        hf = f"{prefix}layers.{i}.block_sparse_moe."
        _put(target, f"blocks.{i}.moe.router.weight", sd[hf + "gate.weight"],
             what="hf llama import")
        for name in ("w1", "w3", "w2"):
            _put(target, f"blocks.{i}.moe.{name}", torch.stack([
                _tensor(sd[hf + f"experts.{x}.{name}.weight"]).t()
                for x in range(n_exp)]), what="hf llama import")
    return model


def load_hf_mixtral(model_or_dir, model: nn.Module, **kwargs) -> nn.Module:
    """Load a HF Mixtral checkpoint into the port's routed
    :class:`~pddl_tpu_torch.models.llama.Llama` in place (module
    docstring); returns ``model``. A directory resolves through
    ``MixtralForCausalLM``; everything else is :func:`load_hf_llama`,
    which maps the ``block_sparse_moe`` layers. Build the model with
    ``moe_experts=config.num_local_experts`` and
    ``moe_top_k=config.num_experts_per_tok``."""
    _check_call(model, "load_hf_mixtral",
                "load_hf_mixtral(model_or_dir, model, **kwargs) -> model")
    if isinstance(model_or_dir, str):
        from transformers import MixtralForCausalLM  # noqa: PLC0415

        model_or_dir = MixtralForCausalLM.from_pretrained(model_or_dir)
    return load_hf_llama(model_or_dir, model, **kwargs)
