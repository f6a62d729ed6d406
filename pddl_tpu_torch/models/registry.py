"""Tiny model registry so configs can name models by string (the port of
:mod:`pddl_tpu.models.registry`: the same 16 names over the port's
factories, with the same adapters).

Every factory takes the port's ``device=`` (``None`` means ``cuda``) and
``seed=`` (the weights' draw) and passes them through to the model.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}

# Registry names whose models consume TOKEN batches (language models):
# run.py keys data/augmentation decisions off membership here — an exact
# per-name property, never a substring heuristic (a vision model whose
# name merely contains 'gpt' must not be fed token batches).
LM_MODELS: set = set()

# Registry names whose factories accept the ``remat`` kwarg (transformer
# families with rematerializable blocks) — same exact-membership rule.
REMAT_MODELS: set = set()


def register_model(name: str, factory: Callable | None = None, *,
                   is_lm: bool = False, supports_remat: bool = False):
    """Register a model factory; usable as a decorator or a call."""
    if is_lm:
        LM_MODELS.add(name)
        REMAT_MODELS.add(name)  # every LM family here is remat-capable
    if supports_remat:
        REMAT_MODELS.add(name)
    if factory is not None:
        _REGISTRY[name] = factory
        return factory

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def _populate() -> None:
    from pddl_tpu_torch.models import gpt, llama, resnet, vit

    register_model("resnet18", resnet.ResNet18)
    register_model("resnet34", resnet.ResNet34)
    register_model("resnet50", resnet.ResNet50)
    register_model("resnet101", resnet.ResNet101)
    register_model("resnet152", resnet.ResNet152)
    register_model("tiny_resnet", resnet.tiny_resnet)

    def _vit(factory):
        # ViTs take no bn_mode (no BatchNorm anywhere in a ViT); accept and
        # drop it so configs stay uniform across model families.
        def make(bn_mode: str = "train", **kwargs):
            return factory(**kwargs)

        return make

    register_model("vit_s16", _vit(vit.ViT_S16), supports_remat=True)
    register_model("vit_b16", _vit(vit.ViT_B16), supports_remat=True)
    register_model("vit_l16", _vit(vit.ViT_L16), supports_remat=True)
    register_model("tiny_vit", _vit(vit.tiny_vit), supports_remat=True)

    # LM configs take no bn_mode; num_classes maps onto vocab_size so the
    # uniform ExperimentConfig drives LMs too (run.py sets the LM batch
    # keys and synthetic-text data for these names).
    def _lm(factory):
        def make(bn_mode: str = "train", num_classes: int = 0, **kwargs):
            # Same fallback as run.py's synthetic-text vocab (num_classes
            # or 64), so the model and data always agree on vocab size.
            kwargs.setdefault("vocab_size", num_classes or 64)
            return factory(**kwargs)

        return make

    register_model("gpt_small", _lm(gpt.GPT_Small), is_lm=True)
    register_model("tiny_gpt", _lm(gpt.tiny_gpt), is_lm=True)
    register_model("llama_small", _lm(llama.Llama_Small), is_lm=True)
    register_model("llama_300m", _lm(llama.Llama_300M), is_lm=True)
    register_model("llama_1b", _lm(llama.Llama_1B), is_lm=True)
    register_model("tiny_llama", _lm(llama.tiny_llama), is_lm=True)


_populate()
