"""Input data of the port (the port of :mod:`pddl_tpu.data`): the
synthetic image and language-modeling tasks, ``NativeLoader``, the
threaded C++ loader of packed uint8 files (``native_loader.py``), the
TFRecord reader (``tfrecord.py``; both built from ``csrc/`` at their first
use), the ImageNet pipeline over TFDS, TFRecords or image folders
(``imagenet.py``, TensorFlow as a CPU input library), the offline packer
(``pack.py``) and the token-corpus pipeline of the language models
(``text.py``). Every source yields host numpy batches; ``Trainer`` moves
them to the device.

The names resolve lazily, so importing this package builds nothing and
imports no TensorFlow."""

from pddl_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "SyntheticImageClassification": "synthetic",
    "SyntheticLanguageModeling": "synthetic",
    "ImageNetConfig": "imagenet",
    "ImageNetDataset": "imagenet",
    "load_imagenet": "imagenet",
    "NativeLoader": "native_loader",
    "TFRecordReader": "tfrecord",
    "TokenFileDataset": "text",
    "load_token_corpus": "text",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
