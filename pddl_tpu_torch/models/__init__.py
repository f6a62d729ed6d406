"""Model families of the port (the port of :mod:`pddl_tpu.models`): the
ResNet family with Keras-v1 parity, the ViT and the Llama, with the JAX
package's presets. GPT is ``models/gpt.py``, as in the JAX package.

The names resolve lazily. The registry (``get_model``,
``register_model``, ``list_models``) waits for ROADMAP.md queue 1 item
9."""

from pddl_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("Llama", "Llama_1B", "Llama_Small", "tiny_llama",
                     "GPipeLlama"), "llama"),
    **dict.fromkeys(("ResNet", "ResNet18", "ResNet34", "ResNet50",
                     "ResNet101", "ResNet152"), "resnet"),
    **dict.fromkeys(("ViT", "ViT_S16", "ViT_B16", "ViT_L16"), "vit"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
