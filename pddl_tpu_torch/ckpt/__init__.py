"""Checkpoints and pretrained weights (the port of :mod:`pddl_tpu.ckpt`):

- :class:`Checkpointer`, :class:`CheckpointEveryN`,
  :class:`ModelCheckpoint` and :class:`BackupAndRestore`: verified saves
  of the trainer's state and the callbacks that take them;
- :func:`fetch_keras_resnet50_weights`: the official keras-applications
  ResNet weight file from the local cache (downloaded only on explicit
  opt-in), MD5-verified;
- :func:`load_keras_resnet50_h5` and :func:`export_keras_style_h5`: a
  Keras ResNet ``.h5`` into the port's ``ResNet`` and back out, the
  reference's pretrained mode and its final ``model.save``;
- :func:`load_hf_gpt2`, :func:`load_hf_llama`, :func:`load_hf_mixtral`
  and :func:`export_hf_llama`: HuggingFace LM checkpoints in and out of
  the port's GPT and Llama (routed experts included);
- :func:`save_inference_artifact` / :func:`load_inference_artifact` and
  :func:`save_decode_artifact` / :func:`load_decode_artifact`: serving
  artifacts on ``torch.export``.

Checkpoints of a strategy over several processes are one save each,
which no world size shapes (``checkpoint.py``), tensor- and
expert-parallel ones included. Importing this package imports no
``transformers``."""

from pddl_tpu_torch.ckpt.checkpoint import (
    BackupAndRestore,
    CheckpointCorruptError,
    CheckpointEveryN,
    Checkpointer,
    ModelCheckpoint,
    latest_epoch,
    save_params_npz,
    tree_checksums,
)
from pddl_tpu_torch.ckpt.export import (
    export_decode_programs,
    export_inference_fn,
    load_decode_artifact,
    load_inference_artifact,
    save_decode_artifact,
    save_inference_artifact,
)
from pddl_tpu_torch.ckpt.fetch import fetch_keras_resnet50_weights
from pddl_tpu_torch.ckpt.hf_export import export_hf_llama
from pddl_tpu_torch.ckpt.hf_import import (
    load_hf_gpt2,
    load_hf_llama,
    load_hf_mixtral,
)
from pddl_tpu_torch.ckpt.keras_import import (
    export_keras_style_h5,
    load_keras_resnet50_h5,
)

__all__ = [
    "Checkpointer",
    "CheckpointCorruptError",
    "CheckpointEveryN",
    "ModelCheckpoint",
    "BackupAndRestore",
    "latest_epoch",
    "save_params_npz",
    "tree_checksums",
    "fetch_keras_resnet50_weights",
    "export_keras_style_h5",
    "load_keras_resnet50_h5",
    "load_hf_gpt2",
    "load_hf_llama",
    "load_hf_mixtral",
    "export_hf_llama",
    "export_inference_fn",
    "save_inference_artifact",
    "load_inference_artifact",
    "export_decode_programs",
    "save_decode_artifact",
    "load_decode_artifact",
]
