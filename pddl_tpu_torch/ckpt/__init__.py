"""Checkpoints and pretrained weights (the port of :mod:`pddl_tpu.ckpt`):

- :class:`Checkpointer`, :class:`CheckpointEveryN`,
  :class:`ModelCheckpoint` and :class:`BackupAndRestore`: verified saves
  of the trainer's state and the callbacks that take them;
- :func:`fetch_keras_resnet50_weights`: the official keras-applications
  ResNet weight file from the local cache (downloaded only on explicit
  opt-in), MD5-verified;
- :func:`load_keras_resnet50_h5` and :func:`export_keras_style_h5`: a
  Keras ResNet ``.h5`` into the port's ``ResNet`` and back out, the
  reference's pretrained mode and its final ``model.save``.

``load_hf_gpt2`` waits for ROADMAP.md queue 1 item 6 (its HF part)."""

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
from pddl_tpu_torch.ckpt.fetch import fetch_keras_resnet50_weights
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
]
