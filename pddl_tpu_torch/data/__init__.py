"""Input data of the port (the port of :mod:`pddl_tpu.data`): the
synthetic image and language-modeling tasks, and ``NativeLoader``, the
threaded C++ loader of packed uint8 files (``native_loader.py``, whose
library is built from ``csrc/`` at its first use).

The names resolve lazily, so importing this package builds nothing.
``ImageNetConfig``, ``ImageNetDataset``, ``load_imagenet``,
``TFRecordReader``, ``TokenFileDataset`` and ``load_token_corpus`` wait
for ROADMAP.md queue 1 item 9."""

from pddl_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "SyntheticImageClassification": "synthetic",
    "SyntheticLanguageModeling": "synthetic",
    "NativeLoader": "native_loader",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
