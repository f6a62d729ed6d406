"""pddl_tpu_torch — the PyTorch / CUDA port of :mod:`pddl_tpu` for NVIDIA Hopper.

The port is a package of its own beside the JAX one and imports none of
it (not even JAX's framework-free modules — it keeps its own copies), so a
GPU host needs neither ``jax`` nor ``flax``. Module paths and public names
follow the JAX package wherever a module has a counterpart; inside, the
code is PyTorch idiom (``nn.Module``\\ s, plain tensor functions, an
explicit ``device``, ``torch.Generator``\\ s).

What is ported so far:

- the paged serving path: ``ServeEngine`` with ``paged=True`` answering
  requests on a Llama-lineage model, whose single-token decode attention
  runs a hand-written CUDA kernel (``ops/csrc/paged_decode.cu``);
- causal-LM training on one card: ``Trainer`` fitting a Llama with
  ``attention="flash"``, whose attention forward and backward run
  hand-written CUDA kernels (``ops/csrc/flash_fwd.cu``,
  ``ops/csrc/flash_bwd.cu``);
- the reference's own workload, ResNet-50 training on one card:
  ``Trainer`` fitting a ``ResNet50`` (flax BatchNorm semantics, the Keras
  or space-to-depth stem, bf16 compute over f32 parameters) with the
  on-device augmentation of ``ops/augment.py`` and the reference's
  callbacks; its convolutions, BatchNorm and pooling go through torch to
  cuDNN and ATen (the JAX package runs no Pallas kernel there).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no ``device="cpu"`` they raise.

Like :mod:`pddl_tpu`, importing the bare package imports nothing heavy:
the public names below resolve lazily (PEP 562).
"""

_LAZY_EXPORTS = {
    "Llama": ("pddl_tpu_torch.models.llama", "Llama"),
    "Llama_1B": ("pddl_tpu_torch.models.llama", "Llama_1B"),
    "tiny_llama": ("pddl_tpu_torch.models.llama", "tiny_llama"),
    "ResNet50": ("pddl_tpu_torch.models.resnet", "ResNet50"),
    "tiny_resnet": ("pddl_tpu_torch.models.resnet", "tiny_resnet"),
    "ServeEngine": ("pddl_tpu_torch.serve.engine", "ServeEngine"),
    "Trainer": ("pddl_tpu_torch.train.loop", "Trainer"),
    "SyntheticImageClassification": ("pddl_tpu_torch.data.synthetic",
                                     "SyntheticImageClassification"),
    "SyntheticLanguageModeling": ("pddl_tpu_torch.data.synthetic",
                                  "SyntheticLanguageModeling"),
    "llama_params_from_jax": ("pddl_tpu_torch.bridge",
                              "llama_params_from_jax"),
    "resnet_params_from_jax": ("pddl_tpu_torch.bridge",
                               "resnet_params_from_jax"),
}

__all__ = sorted(_LAZY_EXPORTS)


def __getattr__(name):
    try:
        module_name, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value  # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
