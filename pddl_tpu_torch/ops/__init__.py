"""Device-side ops of the port (the port of :mod:`pddl_tpu.ops`): the
augment, attention (with the hand-written CUDA kernels behind it, built
at first launch by ``_kernels.py``), the chunked cross-entropy and the
routed experts (``SwitchFFN``, ``ops/moe.py``; resolved here, outside
``__all__`` as in the JAX package).

The names resolve lazily; ``ring_attention``, ``ring_attention_flash``
and ``sequence_parallel_attention`` are ``ops/ring_attention.py``'s."""

from pddl_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "augment": "augment",
    **dict.fromkeys(("attention_reference", "decode_attention",
                     "flash_attention", "flash_attention_lse"), "attention"),
    "chunked_cross_entropy": "large_vocab",
    **dict.fromkeys(("ring_attention", "ring_attention_flash",
                     "sequence_parallel_attention"), "ring_attention"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, {**_EXPORTS,
                                               "SwitchFFN": "moe"})
