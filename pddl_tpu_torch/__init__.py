"""pddl_tpu_torch — the PyTorch / CUDA port of :mod:`pddl_tpu` for NVIDIA Hopper.

The port is a package of its own beside the JAX one and imports none of
it (not even JAX's framework-free modules — it keeps its own copies), so a
GPU host needs neither ``jax`` nor ``flax``. Module paths and public names
follow the JAX package wherever a module has a counterpart; inside, the
code is PyTorch idiom (``nn.Module``\\ s, plain tensor functions, an
explicit ``device``, ``torch.Generator``\\ s).

What is ported so far:

- serving: ``ServeEngine`` answering requests on a Llama-lineage model
  or a GPT, in bf16 or from int8 weights (``ops/quant.py``:
  ``param_transform=dequantize``), on resident rows (``paged=False``,
  the default) or a paged pool
  (``paged=True``), whose single-token decode attention runs a
  hand-written CUDA kernel (``ops/csrc/paged_decode.cu``); with
  ``spec_k > 0`` each tick drafts and verifies a window of tokens
  (n-gram drafts, or a draft model on the paged pool); with
  ``tenant=TenantConfig(...)`` it serves per-request LoRA adapters from a
  paged device pool (``AdapterRegistry``) and grammar-constrained
  decoding (``compile_constraint``: a regex or JSON schema to a token
  FSM);
- KV-cache decoding: ``models/gpt.generate`` and its speculative twin
  ``models/speculative.generate_speculative``;
- causal-LM training on one card: ``Trainer`` fitting a Llama or a GPT
  with ``attention="flash"``, whose attention forward and backward run
  hand-written CUDA kernels (``ops/csrc/flash_fwd.cu``,
  ``ops/csrc/flash_bwd.cu``), with any of the JAX package's eight
  optimizers;
- the reference's own workload, ResNet-50 training on one card:
  ``Trainer`` fitting a ``ResNet50`` (flax BatchNorm semantics, the Keras
  or space-to-depth stem, bf16 compute over f32 parameters) with the
  on-device augmentation of ``ops/augment.py`` and the reference's
  callbacks; its convolutions, BatchNorm and pooling go through torch to
  cuDNN and ATen (the JAX package runs no Pallas kernel there); and a ViT
  on the same image batches, its attention on the flash kernels;
- the reference's distribution modes: ``Trainer(strategy=...)`` with the
  single, mirrored, multi-worker and parameter-server strategies
  (``parallel/``) and the Horovod shim (``compat/hvd.py``), one process
  per device on ``torch.distributed`` (``core/``), with BatchNorm over the
  global batch; and beyond them tensor and expert parallelism
  (``parallel/tensor_parallel.py``) over the mesh's ``model`` and
  ``expert`` axes, with routed experts (``ops/moe.py``) in the Llama, GPT
  and ViT.

The reference's eight scripts are the presets of one command line,
``python -m pddl_tpu_torch --preset NAME`` (``run.py``, ``config.py``),
over the model registry (``models/registry.py``) and the data modules
(``data/``: synthetic tasks, TFRecords, ImageNet, packed files, token
corpora).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no ``device="cpu"`` they raise.

Like :mod:`pddl_tpu`, importing the bare package imports nothing heavy:
the public names below resolve lazily (PEP 562).
"""

from pddl_tpu_torch._lazy import lazy_exports
from pddl_tpu_torch.version import __version__

_EXPORTS = {
    "Llama": "models.llama",
    "Llama_1B": "models.llama",
    "GPT": "models.gpt",
    "GPT_Small": "models.gpt",
    "tiny_gpt": "models.gpt",
    "ViT": "models.vit",
    "ViT_S16": "models.vit",
    "tiny_vit": "models.vit",
    "quantize_int8": "ops.quant",
    "dequantize": "ops.quant",
    "tiny_llama": "models.llama",
    "ResNet50": "models.resnet",
    "tiny_resnet": "models.resnet",
    "ServeEngine": "serve.engine",
    "TenantConfig": "serve.tenant",
    "AdapterRegistry": "serve.tenant",
    "compile_constraint": "serve.tenant",
    "Trainer": "train.loop",
    "MeshConfig": "core.mesh",
    "build_mesh": "core.mesh",
    "local_device_count": "core.mesh",
    "collectives": "core.collectives",
    "MinSizePartitioner": "core.sharding",
    "get_strategy": "parallel",
    "SyntheticImageClassification": "data.synthetic",
    "SyntheticLanguageModeling": "data.synthetic",
    "llama_params_from_jax": "bridge",
    "resnet_params_from_jax": "bridge",
    "gpt_params_from_jax": "bridge",
    "vit_params_from_jax": "bridge",
}
__all__ = ["__version__"] + sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
